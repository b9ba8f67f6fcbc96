#!/usr/bin/env python3
"""Where the port's tiled main path, or its training, spends its time on a
CUDA card.

    python3 tools/profile_torch_main_path.py [--groups 6] [--out FILE]
    python3 tools/profile_torch_main_path.py --train [--steps 10] [--out FILE]
    python3 tools/profile_torch_main_path.py --dir [--frames 36] [--out FILE]
    python3 tools/profile_torch_main_path.py --fullframe [--frames 36]
    python3 tools/profile_torch_main_path.py --temporal [--out FILE]
    python3 tools/profile_torch_main_path.py --temporal --device-flow

Builds ``patch_toon_tpu_torch``'s engine at full width (the weights of
docs/quality_2000/torch_train.ckpt, 6 input channels) for precision bf16 and
32, and runs groups of three 512x910 frames with full masks (510 tiles in
one 512-tile generator call) through ``stylize_group``. For each precision
it prints:

- ms per group by host clock, with ``torch.backends.cudnn.benchmark`` off
  (as the engine ships) and on, in that order in one process;
- a ``torch.profiler`` trace of steady groups: device time by kernel (top
  15), by category (convolution, the upsample's matrix products, the
  InstanceNorm kernel B1, the blend kernel B2, copies, the rest; by kernel
  name, see ``_category``), and the device's busy share of the wall time.

With ``--train`` it trains instead, through ``train/loop.py::fit`` at the
full width of the shipped configuration (batch 80 of 80x80 patches, 6 input
channels; ``chip_smoke.py``'s synthetic keyframes from numpy seed 0), at
precision bf16 and 32, and reads windows of ``fit``'s steps through its
step callback: ms per step by host clock over ``--steps`` steps after 3
warm-up ones; the two ``Adam.step`` calls' ms per step, each between two
synchronisations, over the next ``--steps``; then a trace of 3 steps:
device time per step by category (B1's forward and backward apart, both
variants of each), kernel launches per step, the top 15 kernels, the busy
share, and the copies that B1's backward makes of a dy that is not
NHWC-contiguous (their device time, and each such dy's shape and
strides).

With ``--dir`` it serves a directory instead, through ``process_directory``:
``chip_smoke.py``'s synthetic scene of ``--frames`` 512x910 PNG frames (RGB,
a 3-band tracking guide, full masks), written by the port's codec. For each
precision: a first run (set-up), a timed run (eq-frames/s and ms per group
by host clock), the same run with twice the writer's threads, then a
traced run: the device's busy share and device ms
by category over the whole directory, and the host split of a group, the
host ms of each named step of ``infer/common.py::HostSpans`` (decode, mask,
tile placement, pack, mask stacking, upload, dispatch, readback, encode,
and the pipeline's waits) per group, from every thread. Beside it, the same
split of ``stylize_group`` on three frames already in memory (tile
placement included, as ``stylize_group`` places tiles itself when it is
given no boxes). ``--fullframe`` serves the same directory in full-frame
mode (a group is one frame; B1's split variant).

With ``--temporal`` it serves the temporal chain with flows from files:
``chip_smoke.py``'s temporal scene (12 frames, one flow missing) and a
full-width generator taking 6 + 3 channels with seeded weights, tiled and
fullframe: ms a frame by host clock, then a traced run's device ms a frame
by category, busy share and host split. ``--device-flow`` serves it with the
flow computed on the device instead (``flow_source: device``;
``chip_smoke.py``'s temporal_device scene: partial masks, one missing; the
runs of its ``DEVICE_FLOW_RUNS``, flow_scale 1 and 2): the flow step is its
own device category (the kernels of one flow step traced alone, times the
chain's steps: the profiler links a graph's kernels to no host op), and
each record adds the host's launch calls a frame (kernels, graph launches,
asynchronous copies).

One JSON line per precision goes to stdout, and the list of them to
``--out`` when given. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from patch_toon_tpu_torch.config.defaults import inference_config  # noqa
from patch_toon_tpu_torch.infer import engine as engine_mod  # noqa: E402
from patch_toon_tpu_torch.infer.engine import StyleTransferInference  # noqa
from patch_toon_tpu_torch.infer.temporal import _device_gray  # noqa: E402
from patch_toon_tpu_torch.ops.instance_norm import InstanceNormAct  # noqa
from patch_toon_tpu_torch.ops.masks import erode_full_support_np  # noqa
from patch_toon_tpu_torch.train import optim  # noqa: E402

CKPT = ROOT / "docs" / "quality_2000" / "torch_train.ckpt"
H, W = 512, 910


def _category(name: str) -> str:
    n = name.lower()
    if "instance_norm_split_" in n and "_kernel" in n:  # its 2 launches
        return "B1 instance_norm (split)"
    if "instance_norm_act_" in n and "_kernel" in n:  # both variants
        return "B1 instance_norm"
    if "blend_tiles_kernel" in n:
        return "B2 blend"
    if "upsample" in n or "interp" in n:
        return "upsample"
    if "bn_fw" in n:
        return "smoother batch norm"
    # cuDNN's FFT convolutions: transforms, complex products and sums
    if "fft" in n or "complex" in n or "cf32" in n:
        return "convolution"
    if any(k in n for k in ("conv", "cudnn", "fprop", "implicit", "winograd",
                            "nchw", "nhwc")):
        return "convolution"
    # the port's only matrix products outside cuDNN are the upsample's
    if "nvjet" in n or "gemm" in n:
        return "upsample (matrix products)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "index" in n or "gather" in n:
        return "gather"
    return "other elementwise/reduction"


def _train_category(name: str) -> str:
    n = name.lower()
    if "instance_norm_act_bwd_" in n and "_kernel" in n:  # both variants
        return "B1 backward"
    c = _category(name)
    if c == "B1 instance_norm":
        return "B1 forward"
    if c == "upsample (matrix products)":
        return "matrix products"
    return c


def _device_split(prof, steady: int, category, carve=None) -> tuple:
    """-> (device ms, launches, ms by category, top 15 kernels), each per
    step or group, from a finished trace. ``carve`` (category -> {kernel
    name: us}) moves those kernels' time out of their name's category."""
    by_kernel, launches = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key.startswith("host/"):
            # host ops: their kernels are listed on their own; a HostSpans
            # range also shows on the device timeline as an annotation
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us
            launches += ev.count
    cats = {}
    moved = {}
    for c, kernels in (carve or {}).items():
        for k, us in kernels.items():
            moved[k] = moved.get(k, 0.0) + us
        cats[c] = sum(kernels.values()) / 1e3 / steady
    for k, us in by_kernel.items():
        c = category(k)
        cats[c] = cats.get(c, 0.0) + max(0.0, us - moved.get(k, 0.0)) \
            / 1e3 / steady
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    return (sum(by_kernel.values()) / 1e3 / steady, launches / steady, cats,
            [[k[:90], us / 1e3 / steady] for k, us in top])


def _subtree_kernels(ev):
    yield from ev.kernels
    for child in ev.cpu_children:
        yield from _subtree_kernels(child)


def _b1_backward_copies(prof, steady: int) -> dict:
    """The device time, per step, of the kernels that InstanceNormAct's
    autograd node launches besides B1's backward kernel: the copies that
    make a channel-sliced (or other-typed) dy NHWC-contiguous. Read from
    the kernels the profiler links to the node and its child ops."""
    copy_us, copies, bwd = 0.0, 0, 0
    for ev in prof.events():
        if "InstanceNormActBackward" not in ev.name:
            continue
        parent = ev.cpu_parent
        if parent is not None and "InstanceNormActBackward" in parent.name:
            continue  # inside a node already counted
        for k in _subtree_kernels(ev):
            if "instance_norm_act_bwd_" in k.name.lower():
                bwd += 1
            else:
                copy_us += k.duration
                copies += 1
    return {"copy_ms_per_step": copy_us / 1e3 / steady,
            "copy_launches_per_step": copies / steady,
            "b1_backward_launches_linked_per_step": bwd / steady}


class _TrainWindows:
    """``fit``'s step callback: a timed window, an optimizer window and a
    traced window of steps, one after the other."""

    def __init__(self, warmup: int, steps: int, steady: int):
        self.marks = [warmup, warmup + steps, warmup + 2 * steps,
                      warmup + 2 * steps + steady]
        self.steps, self.steady = steps, steady
        self.opt_ms, self.prof = [], None
        self.plain_step = optim.Adam.step
        self.plain_backward = InstanceNormAct.backward
        self.strided_dy = []  # (shape, stride, dtype) of each dy copied

    def _noted_backward(self, ctx, dy):
        if not dy.is_contiguous() or dy.dtype != ctx.saved_tensors[0].dtype:
            self.strided_dy.append((tuple(dy.shape), dy.stride(),
                                    str(dy.dtype).split(".")[1]))
        return self.plain_backward(ctx, dy)

    def _timed(self, opt, grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.plain_step(opt, grads)
        torch.cuda.synchronize()
        self.opt_ms.append(1e3 * (time.perf_counter() - t0))

    def __call__(self, step: int, metrics) -> None:
        if step not in self.marks:
            return
        torch.cuda.synchronize()
        now = time.perf_counter()
        i = self.marks.index(step)
        if i == 1:
            self.ms = 1e3 * (now - self.t0) / self.steps
            optim.Adam.step = lambda opt, grads: self._timed(opt, grads)
        elif i == 2:
            optim.Adam.step = self.plain_step
            InstanceNormAct.backward = staticmethod(
                lambda ctx, dy: self._noted_backward(ctx, dy))
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        elif i == 3:
            self.prof.stop()
            InstanceNormAct.backward = self.plain_backward
            self.wall_ms = 1e3 * (now - self.t0)
        self.t0 = time.perf_counter()


def _train_records(steps: int, card: str) -> list:
    import tempfile

    from chip_smoke import BT, PS, _keyframes, _train_model
    from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
    from patch_toon_tpu_torch.train.loop import fit

    dev = torch.device("cuda", 0)
    _, pres, posts, masks, guides = _keyframes()
    data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, device=dev)
    records = []
    for prec in ("bf16", "32"):
        steady = 3
        win = _TrainWindows(3, steps, steady)
        model = _train_model(prec, max_steps=win.marks[-1])
        try:
            with tempfile.TemporaryDirectory() as tmp:
                fit(model, data, tmp, seed=0, progress=False, on_step=win)
        finally:
            optim.Adam.step = win.plain_step
            InstanceNormAct.backward = win.plain_backward
        device_ms, launches, cats, top = _device_split(win.prof, steady,
                                                       _train_category)
        strided = win.strided_dy[:len(win.strided_dy) // steady]
        records.append({
            "precision": prec, "card": card, "entry": "fit", "batch": BT,
            "patch": PS, "ms_per_step": win.ms,
            "patches_per_s": BT / win.ms * 1e3,
            "optimizer_ms_per_step": sum(win.opt_ms) / steps,
            "profiled_steps": steady, "device_ms_per_step": device_ms,
            "wall_ms_per_step_profiled": win.wall_ms / steady,
            "device_busy_share": device_ms * steady / win.wall_ms,
            "kernel_launches_per_step": launches,
            "device_ms_per_step_by_category": cats,
            "b1_backward_dy_copies": dict(
                _b1_backward_copies(win.prof, steady),
                copied_dy_per_step=[
                    {"shape": sh, "stride": st, "dtype": dt}
                    for sh, st, dt in strided]),
            "top_kernels_ms_per_step": top})
        print(json.dumps(records[-1]), flush=True)
        torch.cuda.empty_cache()
    return records


def _groups_ms(eng, frames, masks, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.stylize_group(frames, masks)
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _serve_records(groups: int, card: str) -> list:
    mask = erode_full_support_np(np.ones((H, W), np.float32))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (3, -(-H // 10), -(-W // 10), 6),
                        dtype=np.uint8)
    frames = np.repeat(np.repeat(base, 10, axis=1), 10, axis=2)[:, :H, :W]
    masks = [mask] * 3
    records = []
    for prec in ("bf16", "32"):
        torch.backends.cudnn.benchmark = False
        eng = StyleTransferInference(inference_config(
            paths={"checkpoint": str(CKPT)}, inference={"precision": prec}))
        off = _groups_ms(eng, frames, masks, groups)[1:]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steady = 3
            _groups_ms(eng, frames, masks, steady)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        device_ms, _, cats, top = _device_split(prof, steady, _category)
        torch.backends.cudnn.benchmark = True
        on = _groups_ms(eng, frames, masks, groups)[1:]
        torch.backends.cudnn.benchmark = False
        rec = {
            "precision": prec, "card": card, "frames_per_group": 3,
            "tiles_per_group": 510,
            "ms_per_group_benchmark_off": float(np.mean(off)),
            "ms_per_group_benchmark_on": float(np.mean(on)),
            "profiled_groups": steady,
            "device_ms_per_group": device_ms,
            "wall_ms_per_group_profiled": wall_ms / steady,
            "device_busy_share": device_ms * steady / wall_ms,
            "device_ms_per_group_by_category": cats,
            "top_kernels_ms_per_group": top,
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del eng
        torch.cuda.empty_cache()
    return records


# the HostSpans steps that run on the main thread of a directory run
MAIN_THREAD_STEPS = ("host/load_wait", "host/stack", "host/pack",
                     "host/dispatch", "host/readback_issue",
                     "host/readback_wait", "host/encode_submit",
                     "host/writer_drain")


def _spans_per_group(eng, groups: int) -> dict:
    return {k: v["ms"] / groups for k, v in eng.spans.snapshot().items()}


def _dir_records(n_frames: int, card: str, mode: str = "tiled") -> list:
    import tempfile

    from chip_smoke import write_scene

    records = []
    fpg = 3 if mode == "tiled" else 1  # frames a group
    with tempfile.TemporaryDirectory() as tmp:
        scene = pathlib.Path(tmp) / "scene"
        write_scene(scene, n_frames, H, W)
        for prec in ("bf16", "32"):
            out = pathlib.Path(tmp) / f"out_{prec}"
            eng = StyleTransferInference(inference_config(
                paths={"checkpoint": str(CKPT),
                       "input_dir": str(scene / "input"),
                       "mask_dir": str(scene / "mask"),
                       "output_dir": str(out),
                       "additional_channels": {"point_vector": {
                           "path": str(scene / "tracking"), "depth": 3}}},
                inference={"precision": prec, "mode": mode}))
            eng.process_directory()  # set-up: cuDNN, the codec, the rings
            eng.spans.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = eng.process_directory()
            seconds = time.perf_counter() - t0
            groups = -(-written // fpg)
            timed_spans = _spans_per_group(eng, groups)
            # the same run with twice the writer's threads: how far the
            # writer bounds the stream
            threads = engine_mod.WRITER_THREADS
            engine_mod.WRITER_THREADS = 2 * threads
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.process_directory()
                more_writers_s = time.perf_counter() - t0
            finally:
                engine_mod.WRITER_THREADS = threads
            eng.spans.reset()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                eng.process_directory()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
            device_ms, launches, cats, top = _device_split(prof, groups,
                                                           _category)
            traced_spans = _spans_per_group(eng, groups)
            frames = np.stack([eng.load_frame(p) for p in sorted(
                (scene / "input").glob("*.png"))[:fpg]])
            mask = erode_full_support_np(np.ones((H, W), np.float32))
            eng.stylize_group(frames, [mask] * fpg)
            eng.spans.reset()
            for _ in range(groups):
                eng.stylize_group(frames, [mask] * fpg)
            rec = {
                "precision": prec, "card": card, "entry": "process_directory",
                "mode": mode, "frames": written, "frames_per_group": fpg,
                "groups": groups,
                "eq_frames_per_s": written / seconds,
                "ms_per_group": 1e3 * seconds / groups,
                "writer_threads": threads,
                f"ms_per_group_writer_threads_{2 * threads}":
                1e3 * more_writers_s / groups,
                "host_ms_per_group_by_step": timed_spans,
                # the main thread's time outside its steps: Python between
                # them and waits for the interpreter lock there
                "main_thread_unspanned_ms_per_group": 1e3 * seconds / groups
                - sum(v for k, v in timed_spans.items()
                      if k in MAIN_THREAD_STEPS),
                "traced_wall_ms_per_group": wall_ms / groups,
                "device_ms_per_group": device_ms,
                "device_busy_share": device_ms * groups / wall_ms,
                "kernel_launches_per_group": launches,
                "device_ms_per_group_by_category": cats,
                "traced_host_ms_per_group_by_step": traced_spans,
                "stylize_group_host_ms_by_step": _spans_per_group(eng,
                                                                  groups),
                "top_kernels_ms_per_group": top}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            del eng
            torch.cuda.empty_cache()
    return records


def _flow_step_kernels(eng, scene: pathlib.Path, names) -> dict:
    """{kernel name: device us} of one flow step as the chain runs it (the
    graph's replay with its input and output copies), frame 1 against
    frame 0, traced alone: the profiler links a graph's kernels to no
    host op, so the chain's trace cannot tell them from the rest."""
    st0, st1 = (eng._load_for_dispatch(scene / "input" / n,
                                       scene / "mask_ignore", i)
                for i, n in enumerate(names[:2]))
    eng._await_staged([st0, st1])
    prev = _device_gray(st0.frame)

    def step():
        eng.flow_graphs(st1.frame, prev, st1.fmask, eng.temporal_flow_scale)

    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                out[ev.key] = out.get(ev.key, 0.0) + us
    return out


def _temporal_records(card: str, device_flow: bool = False) -> list:
    """The temporal chain through ``process_directory``: flows from files
    (``chip_smoke.py``'s temporal scene: 12 frames of 512x910, seeded
    smooth flows, one missing), or with ``device_flow`` computed on the
    device (its temporal_device scene and runs), with a full-width
    generator taking 6 + 3 channels with seeded weights, tiled and
    fullframe, bf16 and 32: a set-up run, a timed run of the chain from its
    start (ms a frame), then a traced one (device ms a frame by category,
    the flow its own, busy share, host split, launch calls)."""
    import tempfile

    from chip_smoke import (
        DEVICE_FLOW_RUNS,
        FLOW_FMT,
        LAUNCH_CALLS,
        TEMPORAL_FRAMES,
        _device_flow_scene,
        _temporal_ckpt,
        _temporal_engine,
        _temporal_scene,
        write_scene,
    )

    records = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_scene(tmp / "base", TEMPORAL_FRAMES, H, W)
        if device_flow:
            scene = _device_flow_scene(tmp / "base", tmp / "scene",
                                       TEMPORAL_FRAMES)
            runs = DEVICE_FLOW_RUNS
            extra = dict(mask="mask_ignore", flow_source="device",
                         file_format=FLOW_FMT)
        else:
            scene = _temporal_scene(tmp / "base", tmp / "scene",
                                    TEMPORAL_FRAMES)
            runs = [(m, p, 1) for m in ("tiled", "fullframe")
                    for p in ("bf16", "32")]
            extra = {}
        ckpt = _temporal_ckpt(tmp)
        for mode, prec, scale in runs:
            eng = _temporal_engine(prec, scene, tmp / f"out_{mode}{prec}",
                                   ckpt, mode, flow_scale=scale, **extra)
            eng.process_directory()  # set-up
            eng._temporal_prev = eng._temporal_prev_gray = None
            eng.spans.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = eng.process_directory()
            seconds = time.perf_counter() - t0
            spans = _spans_per_group(eng, n)
            eng._temporal_prev = eng._temporal_prev_gray = None
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                eng.process_directory()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
            carve = None
            if device_flow:  # n - 1 flow steps in the traced run
                one = _flow_step_kernels(eng, scene, sorted(
                    p.name for p in (scene / "input").glob("*.png")))
                carve = {"flow": {k: us * (n - 1) for k, us in one.items()}}
            device_ms, launches, cats, top = _device_split(prof, n, _category,
                                                           carve)
            calls = sum(ev.count for ev in prof.key_averages()
                        if ev.key in LAUNCH_CALLS)
            rec = {"precision": prec, "card": card, "mode": mode,
                   "entry": "process_directory (temporal, "
                   f"{'device flow' if device_flow else 'files'})",
                   "flow_scale": scale,
                   "frames": n, "ms_per_frame": 1e3 * seconds / n,
                   "frames_per_s": n / seconds,
                   "host_ms_per_frame_by_step": spans,
                   "traced_wall_ms_per_frame": wall_ms / n,
                   "device_ms_per_frame": device_ms,
                   "device_busy_share": device_ms * n / wall_ms,
                   "kernel_launches_per_frame": launches,
                   "host_launch_calls_per_frame": calls / n,
                   "device_ms_per_frame_by_category": cats,
                   "top_kernels_ms_per_frame": top}
            if device_flow:
                rec["flow_graphs"] = {"captures": eng.flow_graphs.captures,
                                      "replays": eng.flow_graphs.replays}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            del eng
            torch.cuda.empty_cache()
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--groups", type=int, default=6)
    ap.add_argument("--train", action="store_true",
                    help="profile training through fit instead")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dir", action="store_true",
                    help="serve a directory of PNG frames instead")
    ap.add_argument("--fullframe", action="store_true",
                    help="with --dir: inference.mode=fullframe")
    ap.add_argument("--temporal", action="store_true",
                    help="serve the temporal chain (flows from files)")
    ap.add_argument("--device-flow", action="store_true",
                    help="with --temporal: the flow computed on the device")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.train:
        records = _train_records(args.steps, card)
    elif args.temporal:
        records = _temporal_records(card, args.device_flow)
    elif args.dir or args.fullframe:
        records = _dir_records(args.frames, card,
                               "fullframe" if args.fullframe else "tiled")
    else:
        records = _serve_records(args.groups, card)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
