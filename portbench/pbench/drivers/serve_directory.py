"""Serving a shot: ``StyleTransferInference.process_directory`` called back
to back over a directory of PNG frames that set-up writes.

Set-up draws the generator's weights on the device and writes them as the
program's ``.ckpt``, renders the shot (``pbench/scene.py``) and writes its
frames, guides and masks as PNG files, builds the engine from the
program's own config files with the cell's overrides, and serves the
shot once (every kernel built, every shape seen; with the temporal
guide the chain starts there, and its first frame is kept for the
check). The window then calls ``process_directory`` until ``--seconds``
have passed, each call a whole shot whose outputs overwrite the last
call's; with the temporal guide the chain carries from call to call.
With ``--trace 1`` the traffic's ``trace.call``-th call of the window
runs under the profiler.

The check, after the window, the engine freed: frames drawn from the seed
(and, with the temporal guide, the chain's first frame) are served again
by the plain reference in fp32 from the same input files, each chained
frame from the program's own previous output as written, and compared
with the program's files byte by byte. With the temporal guide the
reference also runs a chain of its own over ``check.chain_frames``
consecutive frames of the window's last call, from a frame drawn from
the seed: the first guided by the program's previous output as written,
each later one by the reference's own fp32 composite (the ``chain_``
numbers, and each frame's in the info line). They are printed and not
held to a limit: the carry's gain grows any difference about 2.5 times a
frame, so an fp32 run of the program drifts from this chain nearly as
fast as bf16 and int8 do.
"""

from __future__ import annotations

import gc
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from pbench import plain, pngio, scene, seeds, weights
from pbench.harness import ROOT, Run, launch_counts
from pbench.overrides import program_overrides
from pbench.trace import Slice

NAME = "{:03d}.png"


def input_channels(config: dict) -> int:
    chans = config["data"].get("additional_channels") or {}
    temporal = config.get("inference", {}).get("temporal") or {}
    return 3 + sum(int(c["depth"]) for c in chans.values()) + (
        int(temporal.get("depth", 3)) if temporal.get("enabled") else 0)


def write_shot(traffic: dict, seed: int, device, shot_dir: Path) -> int:
    """Render and write the shot -> the bytes written."""
    shot = scene.Shot(traffic, seed, device)
    dirs = {k: shot_dir / k for k in ("input", "guide", "mask", "output")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    mask = shot.mask(float(traffic.get("mask_fraction", 1.0))).cpu().numpy()
    futures = []
    with ThreadPoolExecutor(max_workers=8) as pool:
        for t in range(shot.t_len):
            frame, guide = shot.frame(t)
            name = NAME.format(t)
            futures += [
                pool.submit(pngio.write_png, dirs["input"] / name,
                            frame.cpu().numpy()),
                pool.submit(pngio.write_png, dirs["guide"] / name,
                            guide.cpu().numpy()),
                pool.submit(pngio.write_png, dirs["mask"] / name, mask)]
        return sum(f.result() for f in futures)


def make_engine(run: Run, shot_dir: Path, ckpt: Path, quantize=None):
    from patch_toon_tpu_torch.config.compose import compose
    from patch_toon_tpu_torch.infer.engine import StyleTransferInference

    paths = {"checkpoint": str(ckpt), "input_dir": str(shot_dir / "input"),
             "mask_dir": str(shot_dir / "mask"),
             "output_dir": str(shot_dir / "output")}
    ov = program_overrides(run.config, run.traffic, paths,
                           str(shot_dir / "guide"))
    if quantize:
        ov.append(f"inference.quantize={quantize}")
    cfg = compose(ROOT / "config", "inference", overrides=ov)
    return StyleTransferInference(cfg, device=str(run.device))


def output_bytes(shot_dir: Path) -> int:
    return sum(p.stat().st_size for p in (shot_dir / "output").iterdir())


def prepare(run: Run, quantize: Optional[str] = None):
    """Weights, shot and engine (``quantize``: the program's
    ``inference.quantize``); the shot served once. -> (engine, shot
    directory, the weights, the chain's first frame or None)."""
    dev = run.device
    cin = input_channels(run.config)
    args = run.config["model"]["generator"]["args"]
    sd = weights.draw(run.reference.generator_specs(args, cin), run.seed,
                      seeds.WEIGHTS_G, dev)
    ckpt = run.scratch / "generator.ckpt"
    torch.save({"gen": {k: v.cpu() for k, v in sd.items()}}, ckpt)
    shot_dir = run.scratch / "shot"
    written = write_shot(run.traffic, run.seed, dev, shot_dir)
    ps = int(run.config["data"]["patch_size"])
    mask = torch.from_numpy(pngio.read_png(shot_dir / "mask" / NAME.format(
        0)))[..., 0]
    run.counts.update(channels=cin, patch_size=ps, tiles_per_frame=len(
        plain.tile_boxes(plain.erode(mask).numpy(), ps, float(
            run.traffic["inference"].get("overlap_percent", 30.0)))))
    t_shot = time.perf_counter() - run.t_start
    eng = make_engine(run, shot_dir, ckpt, quantize)
    t_engine = time.perf_counter() - run.t_start
    eng.process_directory()
    run.info["setup_marks_s"] = {"shot_written": t_shot,
                                 "engine_built": t_engine,
                                 "warmed": time.perf_counter() - run.t_start}
    start = None
    if temporal(run):
        start = (shot_dir / "output" / NAME.format(0)).read_bytes()
    run.info["setup_bytes_written"] = written + output_bytes(shot_dir)
    return eng, shot_dir, sd, start


def temporal(run: Run) -> bool:
    return bool((run.config.get("inference", {}).get("temporal") or {})
                .get("enabled"))


def window(run: Run, eng, shot_dir: Path) -> None:
    """Whole calls until ``--seconds`` have passed."""
    frames = int(run.traffic["frames"])
    trace_call = int(run.traffic.get("trace", {}).get("call", 1))
    before = launch_counts()
    eng.spans.reset()
    torch.cuda.synchronize(run.device) if run.device.type == "cuda" else None
    t0 = time.perf_counter()
    served = calls = written = 0
    left_out = {"s": 0.0, "frames": 0, "spans": {}}
    call_s: List[float] = []
    while True:
        sl = None
        if run.trace and calls == trace_call:
            before_slice = eng.spans.snapshot()
            sl = Slice(run.device, run.scratch)
            sl.start()
        t_call = time.perf_counter()
        n = eng.process_directory()
        if sl is None:
            call_s.append(time.perf_counter() - t_call)
        if sl is not None:
            sl.stop()
            run.summary = sl.summary
            run.counts["slice_frames"] = n
            # the profiled call, its export and reduction are left out of
            # the window's time, frames and spans
            left_out = {"s": sl.seconds, "frames": n, "spans": _minus(
                eng.spans.snapshot(), before_slice)}
        served += n
        calls += 1
        written += output_bytes(shot_dir)
        if time.perf_counter() - t0 - left_out["s"] >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0 - left_out["s"]
    run.info["call_s"] = call_s
    run.spans = _minus(eng.spans.snapshot(), left_out["spans"])
    after = launch_counts()
    run.info["launches"] = {k: after[k] - before.get(k, 0) for k in after
                            if after[k] != before.get(k, 0)}
    run.info["window_bytes_written"] = written
    if hasattr(eng, "flow_graphs"):
        run.info["flow_graph_replays"] = eng.flow_graphs.replays
    run.counts.update(frames=served - left_out["frames"], calls=calls)
    run.attempted = calls * frames
    run.failed = run.attempted - served


def _minus(spans: Dict[str, dict], less: Dict[str, dict]) -> Dict[str, dict]:
    """Host spans ``spans`` less those of ``less``, name by name."""
    return {k: {f: v[f] - less.get(k, {}).get(f, 0) for f in ("ms", "calls")}
            for k, v in spans.items()}


def _read(path: Path) -> Optional[torch.Tensor]:
    try:
        return torch.from_numpy(pngio.read_png(path))
    except (OSError, ValueError):
        return None


def reference_frame(run: Run, sd: Dict[str, torch.Tensor], shot_dir: Path,
                    t: int, prev_out: Optional[torch.Tensor],
                    ps: int) -> Optional[torch.Tensor]:
    """The reference's fp32 composite of frame ``t`` in [-1, 1] (its chain
    guide from ``prev_out``, the previous frame's output as bytes or as an
    fp32 composite; None at a chain start)."""
    dev = run.device
    name = NAME.format(t)
    rgb = _read(shot_dir / "input" / name)
    guide = _read(shot_dir / "guide" / name)
    mask = _read(shot_dir / "mask" / name)
    if rgb is None or guide is None or mask is None:
        return None
    rgb, guide, mask = rgb.to(dev), guide.to(dev)[..., :3], mask.to(dev)[
        ..., 0]
    if temporal(run):
        depth = int(run.config["inference"]["temporal"].get("depth", 3))
        prev_rgb = None
        if prev_out is not None:
            prev_rgb = _read(shot_dir / "input" / NAME.format(t - 1))
            prev_rgb = prev_rgb.to(dev)
        x = plain.chain_input(rgb, guide, prev_out, prev_rgb, mask, depth)
    else:
        x = plain.signed(torch.cat([rgb, guide], dim=-1))
    eroded = plain.erode(mask)
    boxes = plain.tile_boxes(eroded.cpu().numpy(), ps, float(
        run.traffic["inference"].get("overlap_percent", 30.0)))
    args = run.config["model"]["generator"]["args"]
    net = run.reference

    def gen(tiles):
        with torch.no_grad():
            return net.generator(sd, tiles, args)

    return plain.serve_tiled(gen, x, rgb, eroded, boxes, ps)


class Gaps:
    """Byte differences summed over frames: the mean and largest absolute
    difference, and the share of bytes that differ by more than 2."""

    def __init__(self):
        self.total = self.big = self.count = self.worst = 0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> List[float]:
        """-> this frame's mean absolute difference, shares over 2 and 8."""
        d = (got.to(want.device).to(torch.int32)
             - want.to(torch.int32)).abs()
        self.total += int(d.sum())
        self.big += int((d > 2).sum())
        self.count += d.numel()
        self.worst = max(self.worst, int(d.max()))
        return [float(d.float().mean()), float((d > 2).float().mean()),
                float((d > 8).float().mean())]

    def numbers(self, prefix: str = "") -> Dict[str, float]:
        return {f"{prefix}mean_abs_bytes": self.total / self.count,
                f"{prefix}max_abs_bytes": float(self.worst),
                f"{prefix}share_over_2": self.big / self.count}


def compare(run: Run, sd: Dict[str, torch.Tensor], shot_dir: Path,
            start: Optional[bytes]) -> Dict[str, float]:
    """The program's files against the reference (:class:`Gaps`): frames
    checked one by one and, with the temporal guide, the reference's own
    chain (``chain_``)."""
    frames = int(run.traffic["frames"])
    k = int(run.traffic["check"]["frames"])
    first = 1 if temporal(run) else 0
    picks = sorted(seeds.rng(run.seed, seeds.CHECK).choice(
        np.arange(first, frames), size=k, replace=False).tolist())
    ps = int(run.config["data"]["patch_size"])
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gaps, chain = Gaps(), Gaps()
    try:
        jobs: List[tuple] = [(t, shot_dir / "output" / NAME.format(t))
                             for t in picks]
        if start is not None:
            jobs.insert(0, (0, None))
        for t, path in jobs:
            got = _read(path) if path is not None else \
                torch.from_numpy(pngio.decode_png(start))
            prev = None
            if temporal(run) and path is not None:
                prev = _read(shot_dir / "output" / NAME.format(t - 1))
                prev = None if prev is None else prev.to(run.device)
                if prev is None:
                    run.ok = False
                    continue
            want = reference_frame(run, sd, shot_dir, t, prev, ps)
            if got is None or want is None or got.shape != want.shape:
                run.ok = False
                continue
            gaps.add(got, plain.to_bytes(want))
        if temporal(run):
            _own_chain(run, sd, shot_dir, ps, chain)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    run.counts["checked_frames"] = len(picks) + (start is not None)
    if not gaps.count or (temporal(run) and not chain.count):
        run.ok = False
        return {}
    out = gaps.numbers()
    if chain.count:
        out.update(chain.numbers("chain_"))
    return out


def _own_chain(run: Run, sd: Dict[str, torch.Tensor], shot_dir: Path,
               ps: int, chain: Gaps) -> None:
    """The reference's chain over ``check.chain_frames`` frames from one
    drawn from the seed, against the program's files."""
    frames = int(run.traffic["frames"])
    n = int(run.traffic["check"]["chain_frames"])
    t0 = int(seeds.rng(run.seed, seeds.CHAIN).integers(1, frames - n + 1))
    prev = _read(shot_dir / "output" / NAME.format(t0 - 1))
    if prev is None:
        run.ok = False
        return
    prev = prev.to(run.device)
    per_frame = run.info["own_chain"] = {"first": t0, "frames": []}
    for t in range(t0, t0 + n):
        got = _read(shot_dir / "output" / NAME.format(t))
        prev = reference_frame(run, sd, shot_dir, t, prev, ps)
        if got is None or prev is None or got.shape != prev.shape:
            run.ok = False
            return
        per_frame["frames"].append(chain.add(got, plain.to_bytes(prev)))


def run(run: Run) -> None:
    eng, shot_dir, sd, start = prepare(run)
    run.setup_done()
    window(run, eng, shot_dir)
    if run.device.type == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated(run.device))
    del eng
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    nums = compare(run, sd, shot_dir, start)
    run.checks.update(nums)
    run.info["check_numbers"] = nums
