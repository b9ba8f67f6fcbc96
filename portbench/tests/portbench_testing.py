"""Shared helpers of the benchmark's CPU tests: the import path and a cell
resolved from ``BENCHMARK.json`` cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench import harness  # noqa: E402

SERVE, CHAIN, TRAIN, DP4 = ("genj_pv6.serve_tiled_bf16",
                            "genj_temporal9.chain_bf16", "genj_pv6.train_fp32",
                            "genj_pv6.train_fp32_dp4")


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


# cells whose files are here though BENCHMARK.json does not list them
# (the serving cell: its host-paced rate spread too widely for a bound)
PLANNED = {DP4: {"name": DP4, "config": "genj_pv6",
                 "traffic": "train_fp32_dp4", "chips": 4},
           SERVE: {"name": SERVE, "config": "genj_pv6",
                   "traffic": "serve_tiled_bf16", "chips": 1}}


def resolve(workload: str) -> dict:
    """``harness.resolve`` of a cell of BENCHMARK.json or of PLANNED."""
    b = bench()
    if workload not in {w["name"] for w in b["workloads"]}:
        b = dict(b, workloads=b["workloads"] + [PLANNED[workload]])
    return harness.resolve(b, workload)


def tiny(workload: str) -> dict:
    """The cell with narrow networks, 16-pixel patches and small frames."""
    res = resolve(workload)
    cfg = copy.deepcopy(res["config"])
    cfg["model"]["generator"]["args"].update(filters=[4, 8, 8, 8, 8, 4],
                                             resnet_blocks=1)
    cfg["model"]["discriminator"]["args"].update(num_filters=4)
    cfg["data"]["patch_size"] = 16
    t = copy.deepcopy(res["traffic"])
    t.update(frames=6, height=48, width=64)
    if t["driver"] == "fit":
        t.update(keyframes=3, warmup_steps=4, trace_steps=[1, 3])
        t["training"].update(batch_size=8, image_log_freq=5,
                             log_every_n_steps=2)
    else:
        t["check"]["frames"] = 2
        if "chain_frames" in t["check"]:
            t["check"]["chain_frames"] = 3
    res.update(config=cfg, traffic=t)
    return res
