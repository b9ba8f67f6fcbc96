#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (patch_toon_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card; run from the root of a checkout. Phases, one or more
lines each, flushed as they go:

1. ``build``: the nvcc build of ``patch_toon_tpu_torch/csrc/*.cu`` (seconds,
   and each kernel's registers, shared memory and spills as ptxas reports
   them).
2. ``instance_norm``: both variants of kernel B1 (cluster and streaming)
   against its plain PyTorch version at the five main-path shapes of a
   512-tile generator call, fp32 and bf16, each activation. Tolerance: fp32
   |d| <= 1e-5 + 1e-5 |ref|; bf16 one bf16 ulp of the value (2^-7
   relative) + 1e-5. The two variants timed in turns by CUDA events
   (streaming, cluster, cluster, streaming), the plain version and the
   library call (``F.instance_norm`` + activation), the bound and the
   share of it; per-call totals over the 19 sites.
3. ``blend``: kernel B2 against its plain version on the real tile layout of
   three 512x910 frames (510 tiles in a bucket of 512). Bitwise equal.
   Timed three times over.
4. ``main_path``: ``StyleTransferInference.stylize_group`` at the full width
   of config/model/default.yaml (6 input channels, 7 residual blocks) with
   the weights of docs/quality_2000/torch_train.ckpt, precision bf16 and 32,
   on 512x910 frames made from a numpy seed, full masks, grouped by the
   engine's own rule (3 frames a group). Launch counters are zeroed
   just before and read just after: B1's cluster variant must run 19 times
   per generator call, its streaming variant never, and B2 once per group.
   Then a small masked frame through the card at precision 32 must agree
   within 1 uint8 count with the same engine on the CPU (plain versions).

Then, on lines of their own: the kernels' JSON record, the card's name and
power limit (nvidia-smi), and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero before the last line; nothing falls back
to the CPU or to a plain version. A process alarm ends a run that hangs.
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from patch_toon_tpu_torch import _build
from patch_toon_tpu_torch.config.defaults import inference_config
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.infer.programs import make_tile_plan
from patch_toon_tpu_torch.infer.tiling import (
    bucket_size,
    pack_boxes_multi,
    tile_boxes_from_mask,
)
from patch_toon_tpu_torch.ops import blend, instance_norm
from patch_toon_tpu_torch.ops.masks import erode_full_support_np

REPO = Path(__file__).resolve().parent
CKPT = REPO / "docs" / "quality_2000" / "torch_train.ckpt"
ALARM_S = 1100            # the whole run, build included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM, fp32 outside the tensor cores
B = 512                    # tiles per generator call on the main path
# 512p 16:9 frames, the JAX package's benchmark workload (bench.py): full
# masks give 170 tiles of 80x80 a frame, and the engine co-batches 3 frames
# into one call of 510 tiles in a bucket of 512
H, W, PS = 512, 910, 80
# (H, W, C) of each InstanceNorm site of one generator call with its
# activation: stem, 2 downsamples, 7 residual blocks x 2, 2 upsamples
SITES = ([((80, 80, 32), "leaky_relu"), ((40, 40, 64), "leaky_relu"),
          ((20, 20, 128), "leaky_relu")]
         + [((20, 20, 128), "relu"), ((20, 20, 128), None)] * 7
         + [((40, 40, 128), "relu"), ((80, 80, 128), "relu")])


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.library()
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        nvcc_seconds=f"{_build.last_build_seconds:.1f}",
        library=_build.library_path().name)
    entry = "?"
    for line in _build.last_build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            say("build", entry=entry, ptxas=line.split(":", 1)[-1].strip())
    if lib.ptt_instance_norm_slice_bytes() != instance_norm.CTA_BYTES:
        raise AssertionError("csrc/instance_norm.cu and ops/instance_norm.py "
                             "disagree on a CTA's slice budget")


def _library_in(x: torch.Tensor, act):
    y = F.instance_norm(x.permute(0, 3, 1, 2))
    if act == "leaky_relu":
        y = F.leaky_relu(y, 0.2)
    elif act == "relu":
        y = F.relu(y)
    return y


def _in_check(got, want, dtype) -> float:
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * w.abs()
    else:
        tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5
    bad = int((d > tol).sum())
    if bad:
        raise AssertionError(f"instance_norm_act: {bad} values beyond "
                             f"tolerance, max |d| {float(d.max())}")
    return float(d.max())


def phase_instance_norm(dev) -> dict:
    """Both variants against the plain version at every (shape, activation,
    dtype) of the main path, then timed in turns in this one process
    (streaming, cluster, cluster, streaming); the per-call numbers sum the
    19 sites of one 512-tile generator call."""
    gen = torch.Generator(device=dev).manual_seed(1)
    variants = {"cluster": instance_norm.instance_norm_act_cluster,
                "streaming": instance_norm.instance_norm_act_streaming}
    per = {}  # (dtype, shape, act) -> dict of errors and times
    for dtype in (torch.bfloat16, torch.float32):
        for shape in sorted({s for s, _ in SITES}):
            x = (torch.randn((B,) + shape, device=dev, generator=gen) * 2.0
                 + 0.5).to(dtype)
            p = instance_norm.plan_for(x)
            if p.variant != "cluster":
                raise AssertionError(f"{shape} {dtype}: plan {p}")
            bound = 2 * x.nbytes / HBM_BYTES_PER_S * 1e3
            for act in (None, "relu", "leaky_relu"):
                want = instance_norm.instance_norm_act_plain(x, act)
                r = {f"err_{v}": _in_check(fn(x, act), want, dtype)
                     for v, fn in variants.items()}
                del want
                ms = {v: [] for v in variants}
                for v in ("streaming", "cluster", "cluster", "streaming"):
                    ms[v].append(time_ms(lambda: variants[v](x, act), 10))
                r.update({f"ms_{v}": sum(t) / len(t) for v, t in ms.items()})
                r["plain_ms"] = time_ms(
                    lambda: instance_norm.instance_norm_act_plain(x, act), 3)
                r["library_ms"] = time_ms(lambda: _library_in(x, act), 3)
                per[(dtype, shape, act)] = r
                say("instance_norm", dtype=str(dtype).split(".")[1],
                    shape=f"{B}x{shape[0]}x{shape[1]}x{shape[2]}", act=act,
                    k=p.k, G=p.group, cta_kb=f"{p.cta_bytes / 1024:.1f}",
                    cluster_ms=f"{r['ms_cluster']:.4f}",
                    cluster_runs="/".join(f"{t:.4f}" for t in ms["cluster"]),
                    streaming_ms=f"{r['ms_streaming']:.4f}",
                    streaming_runs="/".join(
                        f"{t:.4f}" for t in ms["streaming"]),
                    bound_ms=f"{bound:.4f}",
                    cluster_share_of_bound=f"{bound / r['ms_cluster']:.3f}",
                    streaming_share_of_bound=
                    f"{bound / r['ms_streaming']:.3f}",
                    plain_ms=f"{r['plain_ms']:.4f}",
                    library_ms=f"{r['library_ms']:.4f}",
                    max_abs_err_cluster=f"{r['err_cluster']:.3g}",
                    max_abs_err_streaming=f"{r['err_streaming']:.3g}")
            del x
    rec = {"variants": {v: {} for v in variants}}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        item = 2 if dtype == torch.bfloat16 else 4
        elems = sum(B * s[0] * s[1] * s[2] for s, _ in SITES)
        bytes_ms = 2 * elems * item / HBM_BYTES_PER_S * 1e3
        ops_ms = 8 * elems / FP32_FLOPS * 1e3  # sub, mul, 2 sums, act...
        rows = [per[(dtype, s, a)] for s, a in SITES]
        keys = [k for k in per if k[0] == dtype]
        for v in variants:
            rec["variants"][v][f"ms{tag}"] = sum(r[f"ms_{v}"] for r in rows)
            rec["variants"][v][f"max_abs_err{tag}"] = max(
                per[k][f"err_{v}"] for k in keys)
        rec.update({
            f"max_abs_err{tag}": rec["variants"]["cluster"][
                f"max_abs_err{tag}"],
            f"ms{tag}": rec["variants"]["cluster"][f"ms{tag}"],
            f"plain_ms{tag}": sum(r["plain_ms"] for r in rows),
            f"library_ms{tag}": sum(r["library_ms"] for r in rows),
            f"bound_ms{tag}": max(bytes_ms, ops_ms),
            f"bound_by{tag}": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        say("instance_norm", per_call=str(dtype).split(".")[1],
            cluster_ms=f"{rec['ms' + tag]:.4f}",
            streaming_ms=f"{rec['variants']['streaming']['ms' + tag]:.4f}",
            bound_ms=f"{rec['bound_ms' + tag]:.4f}",
            cluster_share_of_bound=
            f"{rec['bound_ms' + tag] / rec['ms' + tag]:.3f}",
            plain_ms=f"{rec['plain_ms' + tag]:.4f}",
            library_ms=f"{rec['library_ms' + tag]:.4f}")
    return rec


def _full_mask():
    """A full-frame mask as the engine loads one (eroded at the border)."""
    return erode_full_support_np(np.ones((H, W), np.float32))


def _tile_layout(n_frames: int):
    boxes = tile_boxes_from_mask(_full_mask(), PS, 30.0)
    group = [boxes] * n_frames
    fboxes, weights, n = pack_boxes_multi(group, PS,
                                          bucket_size(n_frames * len(boxes)))
    return fboxes, weights, n


def phase_blend(dev) -> dict:
    fboxes, weights_np, n = _tile_layout(3)
    plan = make_tile_plan(fboxes, H, W, PS, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    gen = torch.rand((len(fboxes), PS, PS, 3), device=dev,
                     generator=g) * 2 - 1
    wts = torch.from_numpy(weights_np).to(dev)
    ch, cw = 3 * (H + PS), W + PS
    args = (gen, wts, plan.positions, plan.offsets, plan.ids, ch, cw)
    got = blend.blend_tiles(*args)
    want = blend.blend_tiles_plain(gen, wts, plan.positions, ch, cw)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        d = (got[0] - want[0]).abs().max()
        raise AssertionError(f"blend_tiles differs from its plain version "
                             f"(max |d| {float(d)}); it must be bitwise")
    # library yardstick: one index_add_ of the weighted contributions
    pos = plan.positions.long()[:n]
    r = torch.arange(PS, device=dev)
    flat = ((pos[:, 0, None, None] + r[None, :, None]) * cw
            + pos[:, 1, None, None] + r[None, None, :]).reshape(-1)
    contrib = torch.cat([gen[:n] * wts[:n, ..., None], wts[:n, ..., None]],
                        dim=-1).reshape(-1, 4)
    acc = torch.zeros((ch * cw, 4), device=dev)
    bytes_ = n * PS * PS * 4 * 4 + ch * cw * 4 * 4 + plan.positions.numel() \
        * 4 + plan.offsets.numel() * 4 + int(plan.offsets[-1]) * 4
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = n * PS * PS * 7 / FP32_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    plain = time_ms(lambda: blend.blend_tiles_plain(
        gen, wts, plan.positions, ch, cw), 2)
    runs, libs = [], []
    for _ in range(3):  # three timings settle the share of bound
        runs.append(time_ms(lambda: blend.blend_tiles(*args), 20))
        libs.append(time_ms(
            lambda: acc.zero_().index_add_(0, flat, contrib), 20))
    ms, lib = sum(runs) / 3, sum(libs) / 3
    say("blend", tiles=n, bucket=len(fboxes), canvas=f"{ch}x{cw}",
        bitwise_equal=True, ms=f"{ms:.4f}",
        runs_ms="/".join(f"{t:.4f}" for t in runs),
        share_of_bound="/".join(f"{bound / t:.3f}" for t in runs),
        plain_ms=f"{plain:.4f}", library_ms=f"{lib:.4f}",
        bound_ms=f"{bound:.4f}")
    return {"max_abs_err": 0.0, "ms": ms, "ms_runs": runs, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _engine(precision: str, device=None) -> StyleTransferInference:
    cfg = inference_config(paths={"checkpoint": str(CKPT)},
                           inference={"precision": precision})
    return StyleTransferInference(cfg, device=device)


def phase_main_path(dev, card: str, groups: int = 4) -> dict:
    if not CKPT.exists():
        raise FileNotFoundError(f"weights not found: {CKPT}")
    engines = {p: _engine(p) for p in ("bf16", "32")}
    mask = _full_mask()
    fpd = engines["bf16"]._group_size(
        len(engines["bf16"].boxes_for(mask, (H, W))))
    rng = np.random.default_rng(0)
    # smooth frames: blocks of random colour, like decoded video
    base = rng.integers(0, 256, (fpd, -(-H // 10), -(-W // 10), 6),
                        dtype=np.uint8)
    frames = np.repeat(np.repeat(base, 10, axis=1), 10, axis=2)[:, :H, :W]
    masks = [mask] * fpd
    n_tiles = _tile_layout(fpd)[2]
    outs = {}
    instance_norm.instance_norm_act_cluster.launches = 0
    instance_norm.instance_norm_act_streaming.launches = 0
    blend.blend_tiles.launches = 0
    for prec, eng in engines.items():
        times = []
        for _ in range(groups):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.stylize_group(frames, masks)
            times.append(time.perf_counter() - t0)
        outs[prec] = out
        timed = times[1:]  # the first group sets up cuDNN
        say("main_path", precision=prec, groups=groups,
            frames_per_group=len(frames), tiles_per_group=n_tiles,
            ms_per_group=f"{1e3 * sum(timed) / len(timed):.2f}",
            first_group_ms=f"{1e3 * times[0]:.2f}",
            eq_frames_per_s=f"{len(frames) * len(timed) / sum(timed):.2f}",
            card=f"'{card}'")
    n_in = instance_norm.instance_norm_act_cluster.launches
    n_st = instance_norm.instance_norm_act_streaming.launches
    n_bl = blend.blend_tiles.launches
    calls = groups * len(engines)
    say("main_path", instance_norm_cluster_launches=n_in,
        instance_norm_streaming_launches=n_st, blend_launches=n_bl,
        generator_calls=calls)
    if n_in != 19 * calls or n_st != 0 or n_bl != calls:
        raise AssertionError(f"launch counts {n_in}, {n_st}, {n_bl}: "
                             f"expected {19 * calls} (all 19 sites of each "
                             f"call in the cluster variant), 0 and {calls}")
    for prec, out in outs.items():
        if out.shape != (fpd, H, W, 3) or out.dtype != np.uint8 \
                or out.std() < 1.0:
            raise AssertionError(f"{prec}: bad output {out.shape} "
                                 f"{out.dtype} std {out.std()}")
    d = np.abs(outs["bf16"].astype(int) - outs["32"].astype(int))
    say("main_path", bf16_vs_32_mean_abs=f"{d.mean():.3f}",
        bf16_vs_32_max_abs=int(d.max()))

    # a small masked frame: card at precision 32 against the CPU engine
    mask = np.zeros((H, W), np.float32)
    mask[200:330, 380:560] = 1
    eroded = erode_full_support_np(mask)
    small = frames[:1]
    got = engines["32"].stylize_group(small, [eroded])
    want = _engine("32", device="cpu").stylize_group(small, [eroded])
    dm = np.abs(got.astype(int) - want.astype(int))
    say("main_path", small_check_tiles=len(tile_boxes_from_mask(
        eroded, PS, 30.0)), card_vs_cpu_max_abs=int(dm.max()),
        differing_pixels=int((dm > 0).sum()))
    if dm.max() > 1:
        raise AssertionError(f"card vs CPU at precision 32: {dm.max()} "
                             "counts apart (limit 1)")
    return {"instance_norm_act": n_in, "instance_norm_act_streaming": n_st,
            "blend_tiles": n_bl}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    signal.alarm(ALARM_S)  # default action ends the process
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    say("device", name=f"'{torch.cuda.get_device_name(0)}'",
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, card=f"'{card}'")
    phase_build()
    rec_in = phase_instance_norm(dev)
    rec_bl = phase_blend(dev)
    launches = phase_main_path(dev, card)
    rec_in["variants"]["cluster"]["launches"] = launches["instance_norm_act"]
    rec_in["variants"]["streaming"]["launches"] = launches[
        "instance_norm_act_streaming"]
    kernels = [
        dict(name="instance_norm_act", route="cuda",
             source="patch_toon_tpu_torch/csrc/instance_norm.cu",
             replaces="patch_toon_tpu/ops/pallas_norm.py:52",
             launches=launches["instance_norm_act"], dtype="bf16",
             variant="cluster",
             per="19 sites of one 512-tile generator call", **rec_in),
        dict(name="blend_tiles", route="cuda",
             source="patch_toon_tpu_torch/csrc/blend.cu",
             replaces="patch_toon_tpu/ops/pallas_blend.py:116",
             launches=launches["blend_tiles"],
             per="one group of 3 512x910 frames", **rec_bl),
    ]
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
