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
   ``instance_norm_fullframe``: the split variant of B1 (``plan``'s pick
   for the planes of a full frame) at the 19 sites of one full-frame pass
   over a 512x910 frame (512x912 after padding), bf16 and fp32, against
   the plain version with the tolerance above, its statistics within 1e-5,
   and bitwise equal to a second call; at the quarter-resolution sites
   also the cluster variant at the largest G whose unit fits 8 CTAs. Timed
   as device time (``queued_ms``, over input copies beyond twice the L2
   cache): split and streaming in turns, the cluster alternative, the plain
   version and the library; per-frame totals against the bound.
3. ``blend``: kernel B2 against its plain version on the real tile layout of
   three 512x910 frames (510 tiles in a bucket of 512). Bitwise equal.
   Timed three times over.
4. ``signed_unit``: the card's uint8 -> [-1, 1] normalization against the
   host's IEEE fp32 values, all 256, bitwise (fault C4).
5. ``main_path``: ``StyleTransferInference.stylize_group`` at the full width
   of config/model/default.yaml (6 input channels, 7 residual blocks) with
   the weights of docs/quality_2000/torch_train.ckpt, precision bf16 and 32,
   on 512x910 frames made from a numpy seed, full masks, grouped by the
   engine's own rule (3 frames a group). Launch counters are zeroed
   just before and read just after: B1's cluster variant must run 19 times
   per generator call, its streaming variant never, and B2 once per group.
   Then a small masked frame through the card at precision 32 must agree
   within 1 uint8 count with the same engine on the CPU (plain versions).
6. ``serve_directory``: ``StyleTransferInference.process_directory``, the
   serving entry point, over 36 PNG frames of 512x910 written by the port's
   codec (RGB, a 3-band tracking guide, full masks), with PIL made
   unimportable, at precision bf16 and 32: a set-up run, then a timed run
   (eq-frames/s, ms per group) with the launch counters zeroed just before
   and read just after (19 B1 cluster launches a generator call, none
   streaming, 1 B2 launch a group). Then the in-line loop on one thread
   (decode, ``stylize_group``, encode) on the same engine, timed, and every
   output file of the pipeline decoded and held against it: within 1
   count, the differing pixels printed. Last, an interrupted pass: the
   loader raises ``KeyboardInterrupt`` at frame 13 with groups in flight,
   and every frame taken before it must be on disk, and right, or named in
   the log.
   ``fullframe``: ``process_directory`` in full-frame mode over the same 36
   frames, precision bf16 and 32: a timed run with the counters zeroed just
   before and read just after (19 split launches a frame, none of the
   other B1 variants, no B2), ms a frame beside the tiled run; its files
   against ``stylize_group`` on 3 frames (limit 1 count); the card against
   the CPU at precision 32 on a 256x456 crop (limit 1 count).
   ``temporal``: the temporal chain, flows from files, over the first 12
   of those frames with seeded smooth flows (one missing) and a full-width
   generator taking 6 + 3 channels with seeded weights, tiled and
   fullframe, bf16 and 32: a timed run of the chain from its start (19 B1
   launches a frame in the mode's variant, one B2 launch a frame when
   tiled), its files bitwise against driving ``_chain_step`` directly; the
   first 4 frames of a 200x320 crop, card against the CPU at precision 32
   (limit 1 count).
   ``temporal_device``: the chain with the device flow (``flow_source:
   device``) over the same 12 frames with partial masks (frame 5's
   missing: an unmasked flow there) and the same generator. (a) the flow
   step as a replayed CUDA graph against the eager step on the card,
   bitwise, for two frame pairs at scale 1 and one at scale 2, with the
   graph's and the eager step's device ms and host launch calls; (b) the
   card's flow against the CPU's on a 256x456 crop (within 1e-3 px max and
   1e-4 px at the 99.9th percentile, or twice the CPU's own one-ulp
   spread); then tiled and full-frame at bf16 and 32 with flow_scale 1,
   and full-frame bf16 at flow_scale 2: a timed run of the chain from its
   start (19 B1 launches a frame, B2 when tiled, the two graphs, masked
   and not, captured in a set-up run and replayed 11 times), a traced run (device ms a frame, busy share,
   launch calls a frame) and the files bitwise against driving
   ``_chain_step``; (c) at scale 1 the port's flow tool on the card over
   the 12 frames, its ``flow_bwd`` served in files mode at ``flow_upload:
   f32``, within 1 count of the device run; at full-frame bf16 the chain
   with the eager flow step timed beside it and (d) ``flow_batch`` 3
   bitwise equal to 1; (e) the first 4 frames of a 200x320 crop, card
   against the CPU at precision 32 (limit 1 count).
7. ``instance_norm_backward``: both variants of B1's backward kernel
   (cluster and streaming) against its plain version at every
   InstanceNorm site of a training step (batch 80, the generator's 19
   sites and the discriminator's 2 at its 3 calls), fp32 and bf16, each
   bitwise equal to a second call of itself, with the forward pass's
   statistics checked too. Tolerance: fp32 |d| <= 2e-5 + 2e-5 |ref|; bf16
   one bf16 ulp + 1e-5. Timed as device time (CUDA events around calls
   queued behind a spin kernel, over copies of the inputs that exceed the
   L2 cache): the two variants in turns (cluster, streaming, streaming,
   cluster, cluster, streaming; the median of three each), against the
   bound (one read of x and dy, one write of dx), the plain version and
   the library (autograd through ``F.instance_norm`` + activation: its
   backward alone on a kept graph, and forward with backward beside the
   kernels' forward-with-statistics plus backward); beside them each
   variant back to back on one copy, the host's dispatch cost included.
   Per-step totals over the 25 sites, the variant that ``plan_backward``
   picks (the cluster one) beside its bound.
8. ``train``: training through ``train/loop.py::fit`` (the entry point
   under ``train_torch.py``) at the full width of the shipped configuration
   (config/model, training and data defaults: batch 80 of 80x80 patches, 6
   input channels, D 12 filters, VGG layers [0, 3, 5]) on synthetic
   keyframes from numpy seed 0, at precision 32 and bf16: ``fit`` runs 12
   steps and its step callback times steps 3 to 12 (ms/step, patches/s),
   with the counters zeroed just before them: 25 forward and 25 backward
   B1 launches a step, all in the cluster variants, no streaming launch.
   Two 3-step runs of ``fit`` from one seed must be bitwise equal in every
   parameter and statistic. Then one step on the card against the CPU port
   from the same parameters and batch, at the CPU tests' small widths
   (batch 4) and at full width (batch 2), through ``train/parity.py``: at
   precision 32 each device against the fp64 step that takes that device's
   branch at every ReLU, LeakyReLU and InstanceNorm + activation (within
   5e-5 in relative L2, the parameters within 1.5e-4 and 9e-4), the branch
   flips between the devices counted, losses within 1e-5 (D) and 1e-4 (G),
   BatchNorm 1e-5 and 1e-3; at bf16 each network's gradient on the card
   no further from the CPU's fp32 step than 1.25 times the CPU's bf16 step
   is, losses within 1e-2. Last, the checkpoint ``fit`` wrote at the end
   of the precision-32 run (reference .ckpt layout) loads into
   ``StyleTransferInference`` on the card and stylizes a masked keyframe,
   within 1 count of the CPU engine on the same file.

Then, on lines of their own: the kernels' JSON record, the card's name and
power limit (nvidia-smi), and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero before the last line; nothing falls back
to the CPU or to a plain version. A process alarm ends a run that hangs.
"""

from __future__ import annotations

import contextlib
import json
import logging
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from patch_toon_tpu_torch import _build
from patch_toon_tpu_torch.config.defaults import (
    inference_config,
    training_config,
)
from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
from patch_toon_tpu_torch.infer.common import SIGNED_UNIT, _to_signed_unit
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.infer.pipeline import GroupPipeline
from patch_toon_tpu_torch.infer.temporal import (
    FlowGraphs,
    _device_gray,
    _temporal_device_flow,
)
from patch_toon_tpu_torch.infer.programs import make_tile_plan
from patch_toon_tpu_torch.native.frameio import decode_png, encode_png
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.infer.tiling import (
    bucket_size,
    pack_boxes_multi,
    tile_boxes_from_mask,
)
from patch_toon_tpu_torch.ops import blend, instance_norm
from patch_toon_tpu_torch.ops.flow import dense_flow
from patch_toon_tpu_torch.ops.masks import erode_full_support_np
from patch_toon_tpu_torch.train.loop import fit
from patch_toon_tpu_torch.train.model import StyleTransferModel
from patch_toon_tpu_torch.train.parity import (
    assert_device_step_parity,
    device_step_parity,
)

REPO = Path(__file__).resolve().parent
CKPT = REPO / "docs" / "quality_2000" / "torch_train.ckpt"
ALARM_S = 1100            # the whole run, build included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM, fp32 outside the tensor cores
L2_BYTES = 50e6            # H100 SXM data sheet
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
DIR_FRAMES = 36  # PNG frames of the serve_directory phase: 12 groups
# the InstanceNorm sites of one full-frame generator pass over a 512x910
# frame, padded to 512x912 (infer/programs.py::make_fullframe_fn)
HP, WP = 512, 912
FF_SITES = ([((HP, WP, 32), "leaky_relu"),
             ((HP // 2, WP // 2, 64), "leaky_relu"),
             ((HP // 4, WP // 4, 128), "leaky_relu")]
            + [((HP // 4, WP // 4, 128), "relu"),
               ((HP // 4, WP // 4, 128), None)] * 7
            + [((HP // 2, WP // 2, 128), "relu"), ((HP, WP, 128), "relu")])
BT = 80  # patches per training step (config/training/default.yaml)
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
# the InstanceNorm sites of one training step, forward and backward alike:
# the generator's 19, then the discriminator's 2 (20x20x24, 19x19x48 at 12
# filters) in each of its 3 calls (real and fake in the D phase, fake in
# the G phase)
TRAIN_SITES = SITES + [((20, 20, 24), "leaky_relu"),
                       ((19, 19, 48), "leaky_relu")] * 3


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


def queued_ms(fns, reps: int) -> float:
    """Device time of one call, without the host's dispatch cost: ``reps``
    calls (``fns[i % len(fns)]``, each over its own copy of the inputs)
    are queued behind a spin kernel, between two CUDA events. If the device
    reached the first event before the host had queued the last call, the
    spin is made longer and the run repeated."""
    for fn in fns:  # warm-up
        fn()
    torch.cuda.synchronize()
    spin = 4_000_000  # cycles, about 2 ms
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for i in range(reps):
            fns[i % len(fns)]()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        spin *= 4
    raise AssertionError("the host could not queue the calls ahead of the "
                         "device")


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


def _input_copies(x: torch.Tensor) -> list:
    """x and enough copies of it that together they exceed twice the L2
    cache, so that calls over them in turn read x from HBM."""
    n = max(1, -(-int(2 * L2_BYTES) // x.nbytes))
    return [x] + [x.clone() for _ in range(n - 1)]


def _fitting_cluster(shape, dtype):
    """The cluster variant's plan at the largest G of ``GROUPS`` (in whole
    16-byte vectors) whose unit of ``shape`` fits 8 CTAs, or None."""
    for g in instance_norm.GROUPS:
        if shape[2] % g == 0 and (g * dtype.itemsize) % 16 == 0:
            p = instance_norm.cluster_plan(1, *shape, dtype, g)
            if p is not None:
                return p
    return None


def phase_instance_norm_fullframe(dev) -> dict:
    """B1 at the 19 sites of one full-frame generator pass over a 512x910
    frame (padded to 512x912), bf16 and fp32: the variant ``plan`` picks
    (the split variant; at the quarter-resolution sites the cluster variant
    at the least G that fits 8 CTAs as well, which ``plan`` does not take)
    against the plain version (``_in_check``), its statistics against the
    plain version's, and two calls bitwise equal. Then timed as device time
    (``queued_ms``, over input copies beyond twice the L2 cache): the split
    variant and the streaming variant in turns (split, streaming,
    streaming, split), the quarter-resolution cluster alternative, the
    plain version and the library (``F.instance_norm`` + activation);
    per-frame totals over the 19 sites against the bound (one read and one
    write of each site's tensor)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    per = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, act in sorted(set(FF_SITES), key=str):
            x = (torch.randn((1,) + shape, device=dev, generator=gen) * 2.0
                 + 0.5).to(dtype)
            p = instance_norm.plan_for(x)
            if p.variant != "split":
                raise AssertionError(f"{shape} {dtype}: plan {p}")
            want, pmean, prstd = instance_norm._plain_forward(x, act, 0.2,
                                                              1e-5)
            got, mean, rstd = instance_norm.instance_norm_act_split(
                x, act, stats=True)
            r = {"err": _in_check(got, want, dtype),
                 "stats_err": max(float((mean - pmean).abs().max()),
                                  float(((rstd - prstd) / prstd)
                                        .abs().max()))}
            if r["stats_err"] > 1e-5:
                raise AssertionError(f"{shape} {dtype}: statistics "
                                     f"{r['stats_err']}")
            if not torch.equal(got, instance_norm.instance_norm_act_split(
                    x, act)):
                raise AssertionError(f"{shape} {dtype}: the split variant "
                                     "is not repeatable")
            small = _fitting_cluster(shape, dtype)
            if small is not None:
                r["err_cluster"] = _in_check(
                    instance_norm.instance_norm_act_cluster(x, act, p=small),
                    want, dtype)
            del want, got
            copies = _input_copies(x)
            reps = max(4, 2 * len(copies))
            fns = {
                "split": lambda xc: lambda: instance_norm.
                instance_norm_act_split(xc, act),
                "streaming": lambda xc: lambda: instance_norm.
                instance_norm_act_streaming(xc, act)}
            ms = {v: [] for v in fns}
            for v in ("split", "streaming", "streaming", "split"):
                ms[v].append(queued_ms([fns[v](xc) for xc in copies], reps))
            r.update({f"ms_{v}": sum(t) / len(t) for v, t in ms.items()})
            if small is not None:
                r["ms_cluster"] = queued_ms(
                    [lambda xc=xc: instance_norm.instance_norm_act_cluster(
                        xc, act, p=small) for xc in copies], reps)
            r["plain_ms"] = queued_ms(
                [lambda xc=xc: instance_norm.instance_norm_act_plain(xc, act)
                 for xc in copies], len(copies))
            r["library_ms"] = queued_ms(
                [lambda xc=xc: _library_in(xc, act) for xc in copies],
                len(copies))
            r["bound_ms"] = 2 * x.nbytes / HBM_BYTES_PER_S * 1e3
            per[(dtype, shape, act)] = r
            del copies, x
            say("instance_norm_fullframe", dtype=str(dtype).split(".")[1],
                shape=f"1x{shape[0]}x{shape[1]}x{shape[2]}", act=act,
                G=p.group, chunks=p.chunks, pixels_a_chunk=p.ppc,
                chunk_kb=f"{p.cta_bytes / 1024:.1f}",
                split_ms=f"{r['ms_split']:.4f}",
                split_runs="/".join(f"{t:.4f}" for t in ms["split"]),
                streaming_ms=f"{r['ms_streaming']:.4f}",
                streaming_runs="/".join(f"{t:.4f}" for t in ms["streaming"]),
                bound_ms=f"{r['bound_ms']:.4f}",
                split_share_of_bound=f"{r['bound_ms'] / r['ms_split']:.3f}",
                cluster_small_g=(f"G{small.group}k{small.k}"
                                 if small else None),
                cluster_ms=(f"{r['ms_cluster']:.4f}" if small else None),
                plain_ms=f"{r['plain_ms']:.4f}",
                library_ms=f"{r['library_ms']:.4f}",
                max_abs_err=f"{r['err']:.3g}",
                max_abs_err_cluster=(f"{r['err_cluster']:.3g}"
                                     if small else None),
                stats_err=f"{r['stats_err']:.3g}")
    rec = {}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        rows = [per[(dtype, s, a)] for s, a in FF_SITES]
        elems = sum(s[0] * s[1] * s[2] for s, _ in FF_SITES)
        bytes_ms = 2 * elems * dtype.itemsize / HBM_BYTES_PER_S * 1e3
        ops_ms = 8 * elems / FP32_FLOPS * 1e3
        rec.update({
            f"ms{tag}": sum(r["ms_split"] for r in rows),
            f"streaming_ms{tag}": sum(r["ms_streaming"] for r in rows),
            f"plain_ms{tag}": sum(r["plain_ms"] for r in rows),
            f"library_ms{tag}": sum(r["library_ms"] for r in rows),
            f"bound_ms{tag}": max(bytes_ms, ops_ms),
            f"bound_by{tag}": "bytes" if bytes_ms >= ops_ms else "operations",
            f"max_abs_err{tag}": max(r["err"] for r in rows),
            f"quarter_sites_split_ms{tag}": sum(
                r["ms_split"] for r in rows if "ms_cluster" in r),
            f"quarter_sites_cluster_ms{tag}": sum(
                r["ms_cluster"] for r in rows if "ms_cluster" in r)})
        say("instance_norm_fullframe", per_frame=str(dtype).split(".")[1],
            sites=len(FF_SITES), elements=elems,
            split_ms=f"{rec['ms' + tag]:.4f}",
            bound_ms=f"{rec['bound_ms' + tag]:.4f}",
            split_share_of_bound=
            f"{rec['bound_ms' + tag] / rec['ms' + tag]:.3f}",
            streaming_ms=f"{rec['streaming_ms' + tag]:.4f}",
            quarter_sites_split_ms=
            f"{rec['quarter_sites_split_ms' + tag]:.4f}",
            quarter_sites_cluster_ms=
            f"{rec['quarter_sites_cluster_ms' + tag]:.4f}",
            plain_ms=f"{rec['plain_ms' + tag]:.4f}",
            library_ms=f"{rec['library_ms' + tag]:.4f}",
            below_half_of_bound=[
                f"{s[0]}x{s[1]}x{s[2]}:{a}" for (d, s, a), r in per.items()
                if d == dtype and r["bound_ms"] / r["ms_split"] < 0.5])
    return rec


def _full_mask():
    """A full-frame mask as the engine loads one (eroded at the border)."""
    return erode_full_support_np(np.ones((H, W), np.float32))


def write_scene(root: Path, n: int, h: int = H, w: int = W,
                seed: int = 0) -> None:
    """``n`` synthetic frames as PNG files, written by the port's codec:
    ``input/`` RGB and ``tracking/`` a 3-band guide (10x10 blocks of random
    colour from numpy ``seed``, as the main path's frames), ``mask/``
    full-frame masks (gray 255)."""
    rng = np.random.default_rng(seed)
    for sub in ("input", "tracking", "mask"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    full = np.full((h, w), 255, np.uint8)
    for i in range(n):
        base = rng.integers(0, 256, (-(-h // 10), -(-w // 10), 6),
                            dtype=np.uint8)
        u8 = np.repeat(np.repeat(base, 10, axis=0), 10, axis=1)[:h, :w]
        name = f"{i:04d}.png"
        encode_png(root / "input" / name, u8[..., :3], compress_level=1)
        encode_png(root / "tracking" / name, u8[..., 3:], compress_level=1)
        encode_png(root / "mask" / name, full, compress_level=1)


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


def _dir_engine(precision: str, scene: Path, out: Path, mode: str = "tiled",
                device=None):
    return StyleTransferInference(inference_config(
        paths={"checkpoint": str(CKPT), "input_dir": str(scene / "input"),
               "mask_dir": str(scene / "mask"), "output_dir": str(out),
               "additional_channels": {"point_vector": {
                   "path": str(scene / "tracking"), "depth": 3}}},
        inference={"precision": precision, "mode": mode}), device=device)


def _inline_directory(eng, scene: Path, out: Path, fpd: int) -> float:
    """The order before the pipeline, on one thread: decode, then
    ``stylize_group`` group by group, then encode (the port's codec, zlib
    level 1 as the pipeline's writer). -> seconds."""
    out.mkdir(parents=True, exist_ok=True)
    files = sorted((scene / "input").glob("*.png"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(files), fpd):
        chunk = files[i:i + fpd]
        frames = np.stack([eng.load_frame(p) for p in chunk])
        masks = [eng.load_eroded_mask(scene / "mask" / p.name,
                                      frames.shape[1:3]) for p in chunk]
        for p, img in zip(chunk, eng.stylize_group(frames, masks)):
            encode_png(out / p.name, img, compress_level=1)
    return time.perf_counter() - t0


def _compare_dirs(got: Path, want: Path, names) -> tuple:
    """-> (max |d| in counts, differing pixels) over the files ``names``
    of two output directories, decoded by the port's codec."""
    worst, differ = 0, 0
    for name in names:
        a = decode_png(got / name).astype(int)
        b = decode_png(want / name).astype(int)
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {a.shape} against {b.shape}")
        d = np.abs(a - b)
        worst, differ = max(worst, int(d.max())), differ + int(
            (d.max(axis=-1) > 0).sum())
    return worst, differ


class _LogNames(logging.Handler):
    def __init__(self):
        super().__init__(logging.ERROR)
        self.text = []

    def emit(self, record):
        self.text.append(record.getMessage())


def phase_serve_directory(dev, card: str, tmp: Path) -> dict:
    """``process_directory`` over ``DIR_FRAMES`` PNG frames of 512x910 (RGB,
    a 3-band guide, full masks; ``write_scene``), with PIL made
    unimportable: the card's path needs no Pillow. For each precision a
    first run (set-up), then a timed run with the launch counters zeroed
    just before and read just after; then the in-line loop
    (``_inline_directory``) on the same engine, and each output file
    against it (limit 1 count). Last, an interrupted pass: the loader
    raises ``KeyboardInterrupt`` at frame 13, after four groups are
    dispatched, and every frame taken before it must be on disk (and
    right) or named in the log."""
    saved_pil = {k: sys.modules[k] for k in list(sys.modules)
                 if k == "PIL" or k.startswith("PIL.")}
    sys.modules["PIL"] = None
    try:
        scene = tmp / "scene"
        write_scene(scene, DIR_FRAMES, H, W)
        names = sorted(p.name for p in (scene / "input").glob("*.png"))
        rec, launches, engines = {}, {"instance_norm_act": 0,
                                      "instance_norm_act_streaming": 0,
                                      "blend_tiles": 0}, {}
        for prec in ("bf16", "32"):
            out = tmp / f"dir_{prec}"
            eng = engines[prec] = _dir_engine(prec, scene, out)
            eng.process_directory()  # set-up: cuDNN, the codec, the pools
            for fn in (instance_norm.instance_norm_act_cluster,
                       instance_norm.instance_norm_act_streaming,
                       blend.blend_tiles):
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = eng.process_directory()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            n_in = instance_norm.instance_norm_act_cluster.launches
            n_st = instance_norm.instance_norm_act_streaming.launches
            n_bl = blend.blend_tiles.launches
            fpd = eng._group_size(len(eng.boxes_for(_full_mask(), (H, W))))
            groups = -(-DIR_FRAMES // fpd)
            if written != DIR_FRAMES or n_in != 19 * groups or n_st != 0 \
                    or n_bl != groups:
                raise AssertionError(
                    f"{prec}: {written} frames written, launches {n_in} "
                    f"cluster, {n_st} streaming, {n_bl} blend; expected "
                    f"{DIR_FRAMES}, {19 * groups}, 0, {groups}")
            launches["instance_norm_act"] += n_in
            launches["instance_norm_act_streaming"] += n_st
            launches["blend_tiles"] += n_bl
            inline_s = _inline_directory(eng, scene, tmp / f"inline_{prec}",
                                         fpd)
            worst, differ = _compare_dirs(out, tmp / f"inline_{prec}", names)
            rec[prec] = {"eq_frames_per_s": DIR_FRAMES / seconds,
                         "ms_per_group": 1e3 * seconds / groups,
                         "inline_eq_frames_per_s": DIR_FRAMES / inline_s,
                         "inline_ms_per_group": 1e3 * inline_s / groups}
            say("serve_directory", precision=prec, frames=written,
                groups=groups, frames_per_group=fpd,
                eq_frames_per_s=f"{DIR_FRAMES / seconds:.2f}",
                ms_per_group=f"{1e3 * seconds / groups:.2f}",
                inline_eq_frames_per_s=f"{DIR_FRAMES / inline_s:.2f}",
                inline_ms_per_group=f"{1e3 * inline_s / groups:.2f}",
                instance_norm_cluster_launches=n_in,
                instance_norm_streaming_launches=n_st, blend_launches=n_bl,
                vs_stylize_group_max_abs=worst, differing_pixels=differ,
                pinned_upload_buffers=eng.upload_pools.allocated(),
                card=f"'{card}'")
            if worst > 1:
                raise AssertionError(f"{prec}: process_directory is {worst} "
                                     "counts from stylize_group (limit 1)")

        # the interrupted pass: groups in flight when the loader raises
        eng, out = engines["bf16"], tmp / "dir_interrupted"
        eng.cfg["paths"]["output_dir"] = str(out)
        load, drain_all = eng._load_for_dispatch, GroupPipeline.drain_all
        in_flight = []

        def interrupting_load(path, mask_dir):
            if path.name == names[13]:
                raise KeyboardInterrupt
            return load(path, mask_dir)

        def noted_drain_all(pipe):
            in_flight.append(pipe.frames_in_flight())
            drain_all(pipe)

        log = _LogNames()
        eng.logger.addHandler(log)
        eng._load_for_dispatch = interrupting_load
        GroupPipeline.drain_all = noted_drain_all
        try:
            eng.process_directory()
            raise AssertionError("the interrupt did not reach the caller")
        except KeyboardInterrupt:
            pass
        finally:
            GroupPipeline.drain_all = drain_all
            del eng._load_for_dispatch
            eng.logger.removeHandler(log)
        on_disk = sorted(p.name for p in out.glob("*.png"))
        logged = [n for n in names[:13] if any(n in t for t in log.text)]
        lost = [n for n in names[:13] if n not in on_disk and n not in logged]
        worst, differ = _compare_dirs(out, tmp / "inline_bf16", on_disk)
        say("serve_directory", interrupted_at=names[13],
            frames_in_flight_at_interrupt=in_flight[0],
            on_disk=len(on_disk), named_in_log=logged, lost=lost,
            vs_stylize_group_max_abs=worst, differing_pixels=differ)
        if lost or in_flight[0] == 0 or worst > 1 or len(on_disk) != 12:
            raise AssertionError(
                f"interrupted pass: lost {lost}, {in_flight[0]} frames in "
                f"flight at the interrupt, {len(on_disk)} on disk, max |d| "
                f"{worst}")
        return {"rec": rec, "launches": launches}
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved_pil)


@contextlib.contextmanager
def _without_pil():
    """PIL made unimportable: the card's serving path needs none."""
    saved = {k: sys.modules[k] for k in list(sys.modules)
             if k == "PIL" or k.startswith("PIL.")}
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)


B1_WRAPPERS = {"cluster": instance_norm.instance_norm_act_cluster,
               "split": instance_norm.instance_norm_act_split,
               "streaming": instance_norm.instance_norm_act_streaming}


def _zero_counts() -> None:
    for fn in (*B1_WRAPPERS.values(), blend.blend_tiles):
        fn.launches = 0


def _read_counts() -> dict:
    out = {k: fn.launches for k, fn in B1_WRAPPERS.items()}
    out["blend"] = blend.blend_tiles.launches
    return out


def _check_counts(what: str, got: dict, frames: int, tiled: bool) -> None:
    """19 B1 launches a generator call, in the cluster variant and with one
    B2 launch a call when tiled (one call a frame in these phases), in the
    split variant and no B2 launch in full-frame mode; never streaming."""
    want = {"cluster": 19 * frames if tiled else 0,
            "split": 0 if tiled else 19 * frames, "streaming": 0,
            "blend": frames if tiled else 0}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def phase_fullframe(dev, card: str, tmp: Path, tiled: dict) -> dict:
    """``process_directory`` in full-frame mode over the serve_directory
    phase's 36 frames of 512x910 (one generator pass a frame, 512x912 after
    padding), PIL unimportable, precision bf16 and 32: a set-up run, then a
    timed run with the counters zeroed just before and read just after (19
    split launches a frame, none of the other variants, no B2), beside the
    tiled run on the same frames (``tiled``: the serve_directory records).
    Its files against ``stylize_group`` frame by frame on 3 frames (limit 1
    count). Then at precision 32 the card against the CPU engine on a
    256x456 crop of a frame with a partial mask (limit 1 count)."""
    scene = tmp / "scene"
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    rec, launches = {}, 0
    with _without_pil():
        for prec in ("bf16", "32"):
            out = tmp / f"ff_{prec}"
            eng = _dir_engine(prec, scene, out, mode="fullframe")
            eng.process_directory()  # set-up
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = eng.process_directory()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _read_counts()
            if written != DIR_FRAMES:
                raise AssertionError(f"fullframe {prec}: {written} frames")
            _check_counts(f"fullframe {prec}", counts, DIR_FRAMES, False)
            launches += counts["split"]
            worst = 0
            for name in names[:3]:
                frame = eng.load_frame(scene / "input" / name)
                mask = eng.load_eroded_mask(scene / "mask" / name, (H, W))
                want = eng.stylize_group(frame[None], [mask])[0]
                d = np.abs(decode_png(out / name).astype(int) - want)
                worst = max(worst, int(d.max()))
            ms = 1e3 * seconds / DIR_FRAMES
            tiled_ms = tiled[prec]["ms_per_group"] / 3
            rec[prec] = {"ms_per_frame": ms,
                         "eq_frames_per_s": DIR_FRAMES / seconds,
                         "tiled_ms_per_frame": tiled_ms,
                         "tiled_eq_frames_per_s":
                         tiled[prec]["eq_frames_per_s"]}
            say("fullframe", precision=prec, frames=written,
                ms_per_frame=f"{ms:.2f}",
                eq_frames_per_s=f"{DIR_FRAMES / seconds:.2f}",
                tiled_ms_per_frame=f"{tiled_ms:.2f}",
                tiled_eq_frames_per_s=
                f"{tiled[prec]['eq_frames_per_s']:.2f}",
                split_launches=counts["split"],
                cluster_launches=counts["cluster"],
                streaming_launches=counts["streaming"],
                blend_launches=counts["blend"],
                vs_stylize_group_max_abs=worst, card=f"'{card}'")
            if worst > 1:
                raise AssertionError(f"fullframe {prec}: process_directory "
                                     f"is {worst} counts from stylize_group")
            if prec == "32":  # the card against the CPU
                frame = eng.load_frame(scene / "input" / names[0])
                frame = frame[100:356, 200:656][None]
                mask = np.zeros((256, 456), np.float32)
                mask[20:230, 40:400] = 1
                eroded = erode_full_support_np(mask)
                got = eng.stylize_group(frame, [eroded])
                cpu = _dir_engine(prec, scene, out, mode="fullframe",
                                  device="cpu")
                want = cpu.stylize_group(frame, [eroded])
                dm = np.abs(got.astype(int) - want.astype(int))
                say("fullframe", card_vs_cpu="256x456", precision=prec,
                    max_abs=int(dm.max()), differing_pixels=int(
                        (dm > 0).sum()))
                if dm.max() > 1 or got.std() < 1.0:
                    raise AssertionError(f"fullframe card vs CPU: {dm.max()}"
                                         " counts apart (limit 1)")
            del eng
    return {"rec": rec, "launches": {"split": launches}}


TEMPORAL_FRAMES, TEMPORAL_MISSING = 12, 5  # chain length, missing flow


def _temporal_scene(scene: Path, root: Path, n: int, crop=None) -> Path:
    """The first ``n`` frames of ``scene`` (cropped to ``crop``, (y0, y1,
    x0, x1), when given) with a 3-band guide and masks, and seeded smooth
    backward flows ``flow_bwd/%03d.npy``, the one of frame
    ``TEMPORAL_MISSING`` left out."""
    rng = np.random.default_rng(6)
    for sub in ("input", "tracking", "mask", "flow_bwd"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(sorted(p.name for p in
                                    (scene / "input").glob("*.png"))[:n]):
        for sub in ("input", "tracking", "mask"):
            img = decode_png(scene / sub / name)
            if crop is not None:
                img = img[crop[0]:crop[1], crop[2]:crop[3]]
            encode_png(root / sub / name, img, compress_level=1)
        h, w = img.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        a, b = rng.random(2) * 2 * np.pi
        flow = np.stack([-6.0 + 2.0 * np.sin(yy / 37 + a),
                         1.5 * np.cos(xx / 53 + b)], -1).astype(np.float32)
        if i != TEMPORAL_MISSING:
            np.save(root / "flow_bwd" / f"{i:03d}.npy", flow)
    return root


def _temporal_ckpt(tmp: Path) -> Path:
    """A full-width generator taking 6 + 3 channels, seeded weights (no
    trained temporal checkpoint is at this width), saved once in ``tmp``."""
    ckpt = tmp / "temporal.ckpt"
    if ckpt.exists():
        return ckpt
    torch.manual_seed(9)
    args = dict(inference_config()["model"]["generator"]["args"])
    args["input_channels"] = 9
    gen = GeneratorJ(**args)
    with torch.no_grad():  # move off the zero-bias init
        for p in gen.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               gen.state_dict().items()}}, ckpt)
    return ckpt


def _temporal_engine(prec: str, scene: Path, out: Path, ckpt: Path, mode: str,
                     device=None, mask: str = "mask",
                     **temporal) -> StyleTransferInference:
    cfg = inference_config(
        paths={"checkpoint": str(ckpt), "input_dir": str(scene / "input"),
               "mask_dir": str(scene / mask), "output_dir": str(out),
               "additional_channels": {"point_vector": {
                   "path": str(scene / "tracking"), "depth": 3}}},
        inference={"precision": prec, "mode": mode,
                   "temporal": {"enabled": True, "depth": 3,
                                "flow_dir": str(scene / "flow_bwd"),
                                "file_format": "%03d", "flow_source": "files",
                                "flow_scale": 1, "flow_batch": "auto",
                                "flow_upload": "auto", **temporal}})
    return StyleTransferInference(cfg, device=device)


def phase_temporal(dev, card: str, tmp: Path) -> dict:
    """The temporal guide chain with flows from files through
    ``process_directory``: the first 12 frames of the serve_directory
    scene with seeded smooth flows (the flow of frame 5 missing: the chain
    holds the previous output there), a full-width generator taking 6 + 3
    channels with seeded weights, tiled and fullframe, bf16 and 32. For
    each: a set-up run, then the chain from its start, timed, with the
    counters zeroed just before and read just after; its files bitwise
    against driving ``_chain_step`` directly over the engine's own staging.
    Then at precision 32 the first 4 frames of the chain on a 200x320 crop,
    card against the CPU (limit 1 count)."""
    ckpt = _temporal_ckpt(tmp)
    scene = _temporal_scene(tmp / "scene", tmp / "tscene", TEMPORAL_FRAMES)
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    rec, launches = {}, {"cluster": 0, "split": 0, "blend": 0}
    with _without_pil():
        for mode in ("tiled", "fullframe"):
            for prec in ("bf16", "32"):
                out = tmp / f"t_{mode}_{prec}"
                eng = _temporal_engine(prec, scene, out, ckpt, mode)
                eng.process_directory()  # set-up
                eng._temporal_prev = None  # the chain from its start
                _zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                written = eng.process_directory()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = _read_counts()
                if written != TEMPORAL_FRAMES:
                    raise AssertionError(f"temporal {mode} {prec}: {written}")
                _check_counts(f"temporal {mode} {prec}", counts,
                              TEMPORAL_FRAMES, mode == "tiled")
                for k in launches:
                    launches[k] += counts[k]
                carry, differ = (None, None), []
                for name in names:
                    st = eng._load_for_dispatch(
                        scene / "input" / name, scene / "mask",
                        eng._temporal_position(name))
                    eng._await_staged([st])
                    u8, _, carry = eng._chain_step(
                        st.frame, st.mask, st.boxes, carry, aux=st.flow,
                        label=eng._flow_label(st.position))
                    if not np.array_equal(u8.cpu().numpy(),
                                          decode_png(out / name)):
                        differ.append(name)
                ms = 1e3 * seconds / TEMPORAL_FRAMES
                rec[f"{mode}_{prec}"] = {"ms_per_frame": ms,
                                         "frames_per_s": 1e3 / ms}
                say("temporal", mode=mode, precision=prec, frames=written,
                    ms_per_frame=f"{ms:.2f}", frames_per_s=f"{1e3 / ms:.2f}",
                    flow_f16=eng.temporal_flow_f16, **{
                        f"{k}_launches": v for k, v in counts.items()},
                    directory_vs_chain_steps_differing_frames=len(differ),
                    card=f"'{card}'")
                if differ:
                    raise AssertionError(f"temporal {mode} {prec}: the "
                                         "directory run differs from the "
                                         f"chain steps at {differ}")
                del eng
        # the card against the CPU: the first 4 chain frames, a crop
        small = _temporal_scene(tmp / "scene", tmp / "tsmall", 4,
                                crop=(150, 350, 300, 620))
        for mode in ("tiled", "fullframe"):
            outs = {}
            for device in ("cuda", "cpu"):
                out = tmp / f"tsmall_{mode}_{device}"
                _temporal_engine("32", small, out, ckpt, mode,
                                 device=device).process_directory()
                outs[device] = [decode_png(out / n).astype(int) for n in
                                sorted(p.name for p in out.glob("*.png"))]
            dm = max(int(np.abs(a - b).max())
                     for a, b in zip(outs["cuda"], outs["cpu"]))
            say("temporal", card_vs_cpu="200x320, 4 frames", mode=mode,
                precision="32", max_abs=dm)
            if len(outs["cuda"]) != 4 or dm > 1:
                raise AssertionError(f"temporal {mode}: card vs CPU {dm} "
                                     "counts apart (limit 1)")
    return {"rec": rec, "launches": launches}


FLOW_FMT = "%04d"  # the scene's frame names: the flow tool finds masks by them
# the device-flow runs: (mode, precision, flow_scale)
DEVICE_FLOW_RUNS = [("tiled", "bf16", 1), ("tiled", "32", 1),
                    ("fullframe", "bf16", 1), ("fullframe", "32", 1),
                    ("fullframe", "bf16", 2)]
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def _device_flow_scene(base: Path, root: Path, n: int, crop=None) -> Path:
    """The first ``n`` frames of ``base`` (cropped to ``crop``, (y0, y1,
    x0, x1)) with their 3-band guide; partial masks (an ellipse of 255 in a
    ring of 128, which the flow mask keeps and the composite mask drops) in
    ``mask_ignore/``, frame ``TEMPORAL_MISSING``'s left out (a full-frame
    composite and an unmasked flow there); and for the flow tool, which
    needs every mask, the same masks in ``tool_mask/`` with that frame's
    all 255."""
    for sub in ("input", "tracking", "mask_ignore", "tool_mask"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(sorted(p.name for p in
                                    (base / "input").glob("*.png"))[:n]):
        for sub in ("input", "tracking"):
            img = decode_png(base / sub / name)
            if crop is not None:
                img = img[crop[0]:crop[1], crop[2]:crop[3]]
            encode_png(root / sub / name, img, compress_level=1)
        h, w = img.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        r = ((yy - h * 0.5) / (h * 0.42)) ** 2 \
            + ((xx - w * (0.45 + 0.01 * i)) / (w * 0.38)) ** 2
        mask = np.where(r < 0.8, 255, np.where(r < 1.0, 128, 0)).astype(
            np.uint8)
        encode_png(root / "tool_mask" / name, mask if i != TEMPORAL_MISSING
                   else np.full((h, w), 255, np.uint8), compress_level=1)
        if i != TEMPORAL_MISSING:
            encode_png(root / "mask_ignore" / name, mask, compress_level=1)
    return root


def _traced(fn) -> dict:
    """``fn()`` under ``torch.profiler``: wall ms, device ms (the sum of the
    kernels' and copies' times), device operations, and the host's launch
    calls (kernels, graphs, asynchronous copies and sets)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device_us = ops = calls = 0
    for ev in prof.key_averages():
        if ev.key in LAUNCH_CALLS:
            calls += ev.count
        elif ev.device_type == torch.autograd.DeviceType.CUDA \
                and not ev.key.startswith("host/"):
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                device_us += us
                ops += ev.count
    return {"wall_ms": wall, "device_ms": device_us / 1e3,
            "device_ops": ops, "launch_calls": calls}


def _ulp_spread(g1, g2, scale: int) -> tuple:
    """(max, 99.9th percentile) of |d| of the CPU's ``dense_flow`` when g1
    moves by one ulp at random pixels: LK's own roundoff sensitivity on
    these frames (the CPU tests' bar is the larger of this doubled and
    1e-3 / 1e-4 px on blocky frames)."""
    want = dense_flow(g1, g2, scale=scale)
    step = torch.from_numpy(np.random.default_rng(0).choice(
        [-1.0, 0.0, 1.0], tuple(g1.shape)).astype(np.float32))
    moved = g1 + step * (torch.nextafter(g1, g1 + 1) - g1)
    d = (dense_flow(moved, g2, scale=scale) - want).abs().numpy()
    return float(d.max()), float(np.quantile(d, 0.999))


def _flow_checks(dev, scene: Path) -> dict:
    """(a) the flow step's graph replay against the eager step on the card,
    bitwise: frames 1 -> 0 and 2 -> 1 at scale 1 (masked), 3 -> 2 at scale
    2; CUDA events over 20 replays and over 5 eager steps (which the
    host's launches bound), and from a trace of one call each the sum of
    its kernels' times, its kernels and the host's launch calls. (b) the card's step against the CPU's on
    a 256x456 crop of frames 1 and 0: the luma bitwise, the flow within
    the CPU tests' blocky bar."""
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    frames = [torch.from_numpy(decode_png(scene / "input" / n)).to(dev)
              for n in names[:4]]
    masks = [torch.from_numpy((decode_png(scene / "mask_ignore" / n)[..., 0]
                               > 127).astype(np.uint8)).to(dev)
             for n in names[:4]]
    graphs = FlowGraphs()
    rec = {}
    for i, scale in ((1, 1), (2, 1), (3, 2)):
        prev = _device_gray(frames[i - 1])
        want = _temporal_device_flow(frames[i], prev, masks[i], scale)
        got = graphs(frames[i], prev, masks[i], scale)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            d = float((got[0] - want[0]).abs().max())
            raise AssertionError(f"flow graph replay {i} -> {i - 1} scale "
                                 f"{scale} differs from the eager step "
                                 f"(max |d| {d}); it must be bitwise")
        if float(want[0].abs().max()) < 1.0:
            raise AssertionError(f"flow {i} -> {i - 1}: no motion found")
        if i == 1 or scale == 2:
            key = f"scale{scale}"
            rec[f"graph_ms_{key}"] = time_ms(
                lambda: graphs(frames[i], prev, masks[i], scale), 20)
            rec[f"eager_wall_ms_{key}"] = time_ms(
                lambda: _temporal_device_flow(frames[i], prev, masks[i],
                                              scale), 5)
            for name, fn in (("graph", lambda: graphs(
                    frames[i], prev, masks[i], scale)), ("eager", lambda:
                    _temporal_device_flow(frames[i], prev, masks[i],
                                          scale))):
                tr = _traced(fn)  # the kernels' own time, the launches
                rec[f"{name}_kernel_ms_{key}"] = tr["device_ms"]
                rec[f"{name}_calls_{key}"] = tr["launch_calls"]
                rec[f"{name}_kernels_{key}"] = tr["device_ops"]
    say("temporal_device", check="a: graph replay vs eager step, "
        "512x910", pairs="1->0 s1, 2->1 s1, 3->2 s2", bitwise_equal=True,
        captures=graphs.captures, **{k: (f"{v:.4f}" if isinstance(v, float)
                                         else v) for k, v in rec.items()})
    if graphs.captures != 2 or rec["graph_calls_scale1"] >= \
            rec["eager_calls_scale1"] or rec["eager_calls_scale1"] < 100:
        raise AssertionError(f"flow graph: {graphs.captures} captures, "
                             f"launch calls {rec}")
    # (b) card against CPU
    f1 = frames[1][100:356, 200:656]
    f0 = frames[0][100:356, 200:656]
    for scale in (1, 2):
        gf, gg = _temporal_device_flow(f1, _device_gray(f0), None, scale)
        cprev = _device_gray(f0.cpu())
        cf, cg = _temporal_device_flow(f1.cpu(), cprev, None, scale)
        spread = _ulp_spread(cg.to(torch.float32) / 255.0,
                             cprev.to(torch.float32) / 255.0, scale)
        d = (gf.cpu() - cf).abs().numpy()
        worst, tail = max(1e-3, 2 * spread[0]), max(1e-4, 2 * spread[1])
        say("temporal_device", check="b: card vs CPU flow, 256x456",
            scale=scale, luma_bitwise=torch.equal(gg.cpu(), cg),
            max_abs_px=f"{d.max():.3g}", p999_px=f"{np.quantile(d, .999):.3g}",
            bar=f"{worst:.3g}/{tail:.3g}", cpu_ulp_spread=f"{spread[0]:.3g}/"
            f"{spread[1]:.3g}", bitwise_equal=bool((d == 0).all()))
        if not torch.equal(gg.cpu(), cg) or d.max() > worst \
                or np.quantile(d, 0.999) > tail:
            raise AssertionError(f"card vs CPU flow at scale {scale}: max "
                                 f"{d.max()}, p99.9 {np.quantile(d, .999)}")
    return rec


def phase_temporal_device(dev, card: str, tmp: Path) -> dict:
    """The temporal chain with the device flow (``flow_source: device``)
    through ``process_directory``: the first 12 frames of the
    serve_directory scene, partial masks with frame 5's missing, the
    temporal phase's generator. Checks (a) and (b) of ``_flow_checks``;
    then for each run of ``DEVICE_FLOW_RUNS`` a set-up run, the chain from
    its start timed with the counters zeroed just before and read just
    after (19 B1 launches a frame, B2 when tiled; the flow graphs, masked
    and not, captured in the set-up run and replayed 11 times, never run
    eagerly), a traced
    run (device ms, busy share, launch calls a frame) and the files
    against driving ``_chain_step``, bitwise. At scale 1, (c): the port's
    flow tool on the card over the 12 frames, its ``flow_bwd`` served in
    files mode at ``flow_upload: f32``, within 1 count of the device run.
    Full-frame bf16 also: the chain with the eager flow step, traced beside
    the graph's, and (d) ``flow_batch`` 3 bitwise equal to 1. Last, (e):
    the first 4 chain frames of a 200x320 crop at precision 32, card
    against the CPU, within 1 count."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "optical_flow_torch", REPO / "tools" / "optical_flow_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ckpt = _temporal_ckpt(tmp)
    scene = _device_flow_scene(tmp / "scene", tmp / "dscene",
                               TEMPORAL_FRAMES)
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    rec = {"flow": _flow_checks(dev, scene)}
    t0 = time.perf_counter()
    rc = tool.main([str(scene / "input"), str(scene / "tool_mask"),
                    str(scene / "flow_fwd"), str(scene / "flow_bwd"),
                    "--format", FLOW_FMT, "--device", str(dev)])
    torch.cuda.synchronize()
    say("temporal_device", tool="tools/optical_flow_torch.py", rc=rc,
        frames=TEMPORAL_FRAMES, seconds=f"{time.perf_counter() - t0:.2f}",
        flow_bwd_files=len(list((scene / "flow_bwd").glob("*.npy"))))
    if rc != 0 or len(list((scene / "flow_bwd").glob("*.npy"))) != \
            TEMPORAL_FRAMES - 1:
        raise AssertionError(f"the flow tool failed ({rc})")
    device = dict(mask="mask_ignore", flow_source="device",
                  file_format=FLOW_FMT)
    launches = {"cluster": 0, "split": 0, "blend": 0}
    with _without_pil():
        for mode, prec, scale in DEVICE_FLOW_RUNS:
            tag = f"{mode}_{prec}_s{scale}"
            out = tmp / f"td_{tag}"
            eng = _temporal_engine(prec, scene, out, ckpt, mode, **device,
                                   flow_scale=scale)
            eng.process_directory()  # set-up: cuDNN, the flow graph
            graphs = eng.flow_graphs
            replays = graphs.replays
            eng._temporal_prev = eng._temporal_prev_gray = None
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = eng.process_directory()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _read_counts()
            if written != TEMPORAL_FRAMES:
                raise AssertionError(f"temporal_device {tag}: {written}")
            _check_counts(f"temporal_device {tag}", counts, TEMPORAL_FRAMES,
                          mode == "tiled")
            # one graph with the mask, one without (frame 5), both made
            # in the set-up run
            if graphs.captures != 2 or \
                    graphs.replays - replays != TEMPORAL_FRAMES - 1:
                raise AssertionError(
                    f"temporal_device {tag}: {graphs.captures} graph "
                    f"captures, {graphs.replays - replays} replays in the "
                    f"timed run (expected 2 and {TEMPORAL_FRAMES - 1})")
            for k in launches:
                launches[k] += counts[k]
            eng._temporal_prev = eng._temporal_prev_gray = None
            tr = _traced(eng.process_directory)
            carry, differ, tiles = (None, None), [], 0
            for name in names:
                st = eng._load_for_dispatch(
                    scene / "input" / name, scene / "mask_ignore",
                    eng._temporal_position(name))
                tiles += len(st.boxes)
                eng._await_staged([st])
                u8, _, carry = eng._chain_step(st.frame, st.mask, st.boxes,
                                               carry, aux=st.fmask)
                if not np.array_equal(u8.cpu().numpy(),
                                      decode_png(out / name)):
                    differ.append(name)
            ms = 1e3 * seconds / TEMPORAL_FRAMES
            r = rec[tag] = {
                "ms_per_frame": ms, "frames_per_s": 1e3 / ms,
                "traced_device_ms_per_frame":
                tr["device_ms"] / TEMPORAL_FRAMES,
                "busy_share": tr["device_ms"] / tr["wall_ms"],
                "launch_calls_per_frame":
                tr["launch_calls"] / TEMPORAL_FRAMES,
                "device_ops_per_frame": tr["device_ops"] / TEMPORAL_FRAMES,
                "tiles_per_frame": tiles / TEMPORAL_FRAMES}
            extra = {}
            if scale == 1:  # (c) the flow tool's files, served
                fout = tmp / f"tf_{tag}"
                _temporal_engine(prec, scene, fout, ckpt, mode,
                                 mask="mask_ignore", file_format=FLOW_FMT,
                                 flow_upload="f32").process_directory()
                worst, differ_px = _compare_dirs(fout, out, names)
                r["files_vs_device_max_abs"] = extra[
                    "c_files_vs_device_max_abs"] = worst
                extra["c_differing_pixels"] = differ_px
                if worst > 1:
                    raise AssertionError(f"temporal_device {tag}: the flow "
                                         f"tool's files served {worst} "
                                         "counts from the device flow")
            if (mode, prec, scale) == ("fullframe", "bf16", 1):
                # (d) flow_batch 3
                bout = tmp / f"tb_{tag}"
                _temporal_engine(prec, scene, bout, ckpt, mode, **device,
                                 flow_batch=3).process_directory()
                worst, differ_px = _compare_dirs(bout, out, names)
                extra["d_flow_batch3_vs_1_differing_pixels"] = differ_px
                if differ_px:
                    raise AssertionError(f"flow_batch 3 differs from 1 at "
                                         f"{differ_px} pixels")
                # the same chain with the same step run eagerly
                keep, eng.flow_graphs = eng.flow_graphs, _temporal_device_flow
                try:
                    eng._temporal_prev = eng._temporal_prev_gray = None
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.process_directory()
                    torch.cuda.synchronize()
                    eager_s = time.perf_counter() - t0
                    eng._temporal_prev = eng._temporal_prev_gray = None
                    et = _traced(eng.process_directory)
                finally:
                    eng.flow_graphs = keep
                r["eager_flow_ms_per_frame"] = extra[
                    "eager_flow_ms_per_frame"] = 1e3 * eager_s / TEMPORAL_FRAMES
                r["eager_flow_launch_calls_per_frame"] = extra[
                    "eager_flow_launch_calls_per_frame"] = \
                    et["launch_calls"] / TEMPORAL_FRAMES
                r["eager_flow_busy_share"] = et["device_ms"] / et["wall_ms"]
            say("temporal_device", mode=mode, precision=prec,
                flow_scale=scale, frames=written, ms_per_frame=f"{ms:.2f}",
                frames_per_s=f"{1e3 / ms:.2f}",
                device_ms_per_frame=f"{r['traced_device_ms_per_frame']:.2f}",
                busy_share=f"{r['busy_share']:.3f}",
                launch_calls_per_frame=f"{r['launch_calls_per_frame']:.1f}",
                device_ops_per_frame=f"{r['device_ops_per_frame']:.1f}",
                tiles_per_frame=f"{r['tiles_per_frame']:.1f}",
                graph_replays=graphs.replays - replays, **{
                    f"{k}_launches": v for k, v in counts.items()},
                directory_vs_chain_steps_differing_frames=len(differ),
                **{k: (f"{v:.2f}" if isinstance(v, float) else v)
                   for k, v in extra.items()}, card=f"'{card}'")
            if differ:
                raise AssertionError(f"temporal_device {tag}: the directory "
                                     f"run differs from the chain steps at "
                                     f"{differ}")
            del eng
        # (e) the card against the CPU: the first 4 chain frames, a crop
        small = _device_flow_scene(tmp / "scene", tmp / "dsmall", 4,
                                   crop=(150, 350, 300, 620))
        for mode in ("tiled", "fullframe"):
            outs = {}
            for device_ in ("cuda", "cpu"):
                out = tmp / f"dsmall_{mode}_{device_}"
                _temporal_engine("32", small, out, ckpt, mode,
                                 device=device_, **device).process_directory()
                outs[device_] = [decode_png(out / n).astype(int) for n in
                                 sorted(p.name for p in out.glob("*.png"))]
            dm = max(int(np.abs(a - b).max())
                     for a, b in zip(outs["cuda"], outs["cpu"]))
            say("temporal_device", check="e: card vs CPU, 200x320, 4 "
                "frames", mode=mode, precision="32", max_abs=dm)
            if len(outs["cuda"]) != 4 or dm > 1:
                raise AssertionError(f"temporal_device {mode}: card vs CPU "
                                     f"{dm} counts apart (limit 1)")
    return {"rec": rec, "launches": launches}


def phase_signed_unit(dev) -> None:
    """C4: all 256 bytes through the card's normalization, bitwise against
    the host's IEEE values; the division it replaced, for the record."""
    a = torch.arange(256, dtype=torch.uint8, device=dev)
    got = _to_signed_unit(a).cpu().numpy()
    old = (a.float() / 255.0 * 2.0 - 1.0).cpu().numpy()
    differ = int((got.view(np.int32) != SIGNED_UNIT.view(np.int32)).sum())
    say("signed_unit", differing_values=differ,
        division_on_card_differing_values=int(
            (old.view(np.int32) != SIGNED_UNIT.view(np.int32)).sum()))
    if differ:
        raise AssertionError(f"_to_signed_unit on the card differs from the "
                             f"host's fp32 values at {differ} of 256 bytes")


def _bwd_check(got, want, dtype) -> float:
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        tol = 2e-5 + 2e-5 * w.abs()
    else:
        tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5
    bad = int((d > tol).sum())
    if bad:
        raise AssertionError(f"instance_norm_act_backward: {bad} values "
                             f"beyond tolerance, max |d| {float(d.max())}")
    return float(d.max())


def _library_in_fwd_bwd(x: torch.Tensor, dy: torch.Tensor, act):
    """Autograd through F.instance_norm + activation on the NCHW view of
    the NHWC memory (channels_last): forward and backward."""
    xl = x.detach().permute(0, 3, 1, 2).requires_grad_(True)
    y = _library_in(xl.permute(0, 2, 3, 1), act)
    return torch.autograd.grad(y, xl, dy.permute(0, 3, 1, 2))[0]


def _library_in_bwd(x: torch.Tensor, dy: torch.Tensor, act):
    """The library's backward alone: the graph of F.instance_norm +
    activation is built once and kept, and the returned function runs
    only ``torch.autograd.grad`` on it."""
    xl = x.detach().permute(0, 3, 1, 2).requires_grad_(True)
    y = _library_in(xl.permute(0, 2, 3, 1), act)
    g = dy.permute(0, 3, 1, 2)
    return lambda: torch.autograd.grad(y, xl, g, retain_graph=True)[0]


BWD_VARIANTS = {"cluster": instance_norm.instance_norm_act_backward_cluster,
                "streaming":
                instance_norm.instance_norm_act_backward_streaming}



def phase_instance_norm_backward(dev) -> dict:
    """Both backward variants at every (shape, activation, dtype) of a
    training step's InstanceNorm sites, against the plain version and
    bitwise against a second call of themselves; then timed beside the
    bound, the plain version and the library's backward alone and forward
    with backward. Each time is device time by ``queued_ms`` over copies
    of x and dy that together exceed twice the L2 cache, so every call
    reads its inputs from HBM as a training step's backward does; the two
    variants in turns in this one process (cluster, streaming, streaming,
    cluster, cluster, streaming: the median of three each). Beside them,
    each variant once by ``time_ms`` on one copy (back to back, the host's
    dispatch cost included). The per-step numbers sum the 25 sites; the
    picked variant is the one ``plan_backward`` names."""
    gen = torch.Generator(device=dev).manual_seed(3)
    per = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, act in sorted(set(TRAIN_SITES), key=str):
            x = (torch.randn((BT,) + shape, device=dev, generator=gen) * 2.0
                 + 0.5).to(dtype)
            dy = torch.randn((BT,) + shape, device=dev, generator=gen).to(
                dtype)
            p = instance_norm.plan_backward_for(x, dy)
            if p.variant != "cluster":
                raise AssertionError(f"{shape} {dtype}: plan {p}")
            y, mean, rstd = instance_norm.instance_norm_act_cluster(
                x, act, stats=True)
            _, pmean, prstd = instance_norm._plain_forward(x, act, 0.2, 1e-5)
            serr = max(float((mean - pmean).abs().max()),
                       float(((rstd - prstd) / prstd).abs().max()))
            if serr > 1e-5:
                raise AssertionError(f"{shape} {dtype}: statistics {serr}")
            want = instance_norm.instance_norm_act_backward_plain(
                x, dy, mean, rstd, act)
            r = {}
            for v, fn in BWD_VARIANTS.items():
                got = fn(x, dy, mean, rstd, act)
                r[f"err_{v}"] = _bwd_check(got, want, dtype)
                if not torch.equal(got, fn(x, dy, mean, rstd, act)):
                    raise AssertionError(f"the backward {v} variant is not "
                                         "repeatable")
            del y, want, got
            bound = 3 * x.nbytes / HBM_BYTES_PER_S * 1e3
            n_copies = max(1, -(-int(2 * L2_BYTES) // (3 * x.nbytes)))
            copies = [(x, dy)] + [(x.clone(), dy.clone())
                                  for _ in range(n_copies - 1)]
            reps, slow_reps = max(10, 2 * n_copies), max(3, n_copies)

            def calls(make):
                return [make(xc, dc) for xc, dc in copies]

            ms = {v: [] for v in BWD_VARIANTS}
            for v in ("cluster", "streaming", "streaming", "cluster",
                      "cluster", "streaming"):
                fn = BWD_VARIANTS[v]
                ms[v].append(queued_ms(calls(
                    lambda xc, dc: lambda: fn(xc, dc, mean, rstd, act)),
                    reps))
            r.update({f"ms_{v}": sorted(t)[1] for v, t in ms.items()})
            r.update({f"b2b_ms_{v}": time_ms(
                lambda: fn(x, dy, mean, rstd, act), 10)
                for v, fn in BWD_VARIANTS.items()})
            r.update({
                "bound_ms": bound,
                "fwd_stats_ms": queued_ms(calls(
                    lambda xc, dc: lambda: instance_norm.
                    instance_norm_act_cluster(xc, act, stats=True)), reps),
                "plain_ms": queued_ms(calls(
                    lambda xc, dc: lambda: instance_norm.
                    instance_norm_act_backward_plain(xc, dc, mean, rstd,
                                                     act)), slow_reps),
                "library_bwd_ms": queued_ms(calls(
                    lambda xc, dc: _library_in_bwd(xc, dc, act)), slow_reps),
                "library_ms": queued_ms(calls(
                    lambda xc, dc: lambda: _library_in_fwd_bwd(xc, dc, act)),
                    slow_reps)})
            del copies
            per[(dtype, shape, act)] = r
            other = r["ms_streaming"] - r["ms_cluster"]
            say("instance_norm_backward", dtype=str(dtype).split(".")[1],
                shape=f"{BT}x{shape[0]}x{shape[1]}x{shape[2]}", act=act,
                picked=p.variant, G=p.group, k=p.k,
                cta_kb=f"{p.cta_bytes / 1024:.1f}", input_copies=n_copies,
                cluster_ms=f"{r['ms_cluster']:.4f}",
                cluster_runs="/".join(f"{t:.4f}" for t in ms["cluster"]),
                streaming_ms=f"{r['ms_streaming']:.4f}",
                streaming_runs="/".join(f"{t:.4f}" for t in ms["streaming"]),
                bound_ms=f"{bound:.4f}",
                cluster_share_of_bound=f"{bound / r['ms_cluster']:.3f}",
                streaming_share_of_bound=f"{bound / r['ms_streaming']:.3f}",
                picked_ahead_of_other_ms=f"{other:.4f}",
                back_to_back_cluster_ms=f"{r['b2b_ms_cluster']:.4f}",
                back_to_back_streaming_ms=f"{r['b2b_ms_streaming']:.4f}",
                fwd_stats_ms=f"{r['fwd_stats_ms']:.4f}",
                plain_ms=f"{r['plain_ms']:.4f}",
                library_bwd_ms=f"{r['library_bwd_ms']:.4f}",
                library_fwd_bwd_ms=f"{r['library_ms']:.4f}",
                max_abs_err_cluster=f"{r['err_cluster']:.3g}",
                max_abs_err_streaming=f"{r['err_streaming']:.3g}",
                stats_err=f"{serr:.3g}")
            del x, dy, mean, rstd
    rec = {v: {} for v in BWD_VARIANTS}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        item = dtype.itemsize
        elems = sum(BT * s[0] * s[1] * s[2] for s, _ in TRAIN_SITES)
        bytes_ms = 3 * elems * item / HBM_BYTES_PER_S * 1e3
        ops_ms = 12 * elems / FP32_FLOPS * 1e3  # two passes of ~6 each
        rows = [per[(dtype, s, a)] for s, a in TRAIN_SITES]
        shared = {
            f"plain_ms{tag}": sum(r["plain_ms"] for r in rows),
            f"library_ms{tag}": sum(r["library_bwd_ms"] for r in rows),
            f"library_fwd_bwd_ms{tag}": sum(r["library_ms"] for r in rows),
            f"fwd_stats_ms{tag}": sum(r["fwd_stats_ms"] for r in rows),
            f"bound_ms{tag}": max(bytes_ms, ops_ms),
            f"bound_by{tag}": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        for v in BWD_VARIANTS:
            rec[v].update(shared)
            rec[v][f"ms{tag}"] = sum(r[f"ms_{v}"] for r in rows)
            rec[v][f"back_to_back_ms{tag}"] = sum(r[f"b2b_ms_{v}"]
                                                  for r in rows)
            rec[v][f"max_abs_err{tag}"] = max(
                r[f"err_{v}"] for k, r in per.items() if k[0] == dtype)
        picked, bound = rec["cluster"][f"ms{tag}"], shared[f"bound_ms{tag}"]
        worst = max(r["ms_cluster"] - r["ms_streaming"] for r in rows)
        say("instance_norm_backward", per_step=str(dtype).split(".")[1],
            sites=len(TRAIN_SITES), picked="cluster",
            picked_ms=f"{picked:.4f}", bound_ms=f"{bound:.4f}",
            share_of_bound=f"{bound / picked:.3f}",
            at_least_half_of_bound=bound / picked >= 0.5,
            streaming_ms=f"{rec['streaming']['ms' + tag]:.4f}",
            picked_behind_other_at_worst_site_ms=f"{worst:.4f}",
            back_to_back_cluster_ms=
            f"{rec['cluster']['back_to_back_ms' + tag]:.4f}",
            back_to_back_streaming_ms=
            f"{rec['streaming']['back_to_back_ms' + tag]:.4f}",
            fwd_stats_plus_bwd_ms=
            f"{shared['fwd_stats_ms' + tag] + picked:.4f}",
            plain_ms=f"{shared['plain_ms' + tag]:.4f}",
            library_bwd_ms=f"{shared['library_ms' + tag]:.4f}",
            library_fwd_bwd_ms=f"{shared['library_fwd_bwd_ms' + tag]:.4f}")
    return rec


def _keyframes(n: int = 4, h: int = 270, w: int = 480):
    """Synthetic keyframes from numpy seed 0, at the size of the sample
    scene (tools/make_sample_scene.py): uint8 blocks of random colour (RGB
    and a 3-band guide), and as the dataset takes them, fp32 in [-1, 1],
    a posterized target and elliptical masks."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames, pres, posts, masks, guides = [], [], [], [], []
    for _ in range(n):
        u8 = np.repeat(np.repeat(rng.integers(
            0, 256, (h // 8 + 1, w // 8 + 1, 6), dtype=np.uint8), 8, 0),
            8, 1)[:h, :w]
        frames.append(u8)
        frame = SIGNED_UNIT[u8]
        pres.append(frame[..., :3])
        guides.append(frame[..., 3:])
        posts.append(np.round(frame[..., :3] * 2) / 2 * 0.9)
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        masks.append((((yy - cy) / (0.3 * h)) ** 2 + ((xx - cx) / (0.3 * w))
                      ** 2 <= 1).astype(np.float32))
    return frames, pres, posts, masks, guides


def _train_model(precision: str, small: bool = False, batch: int = BT,
                 max_steps: int = 0):
    over = {"training": {"precision": precision, "batch_size": batch,
                         "max_steps": max_steps}}
    if small:  # the CPU tests' widths (tests/test_torch_train.py)
        over["model"] = training_config()["model"]
        over["model"]["generator"]["args"].update(
            filters=[8, 16, 32, 32, 32, 16], resnet_blocks=2)
        over["model"]["discriminator"]["args"]["num_filters"] = 8
    cfg = training_config(**over)
    return StyleTransferModel(cfg.model.generator, cfg.model.discriminator,
                              cfg.training, cfg.optimizer, cfg.data,
                              cfg.model.perception_loss, cfg.parallel)


def _net_tensors(state):
    out = {}
    for tag, net in (("G", state.generator), ("D", state.discriminator)):
        for k, v in net.state_dict().items():
            out[f"{tag}.{k}"] = v.detach().float().cpu()
    return out


def _counts():
    return (instance_norm.instance_norm_act_cluster.launches,
            instance_norm.instance_norm_act_streaming.launches,
            instance_norm.instance_norm_act_backward_cluster.launches,
            instance_norm.instance_norm_act_backward_streaming.launches)


def _step_parity(dev, small: bool, batch: int) -> dict:
    """One step from the same parameters and batch on the card and on the
    CPU (``train/parity.py::device_step_parity``)."""
    ps = 32 if small else PS
    rng = np.random.default_rng(1)
    batch_np = {"pre": rng.standard_normal((batch, ps, ps, 3)),
                "channels": rng.standard_normal((batch, ps, ps, 3)),
                "post": rng.random((batch, ps, ps, 3)) * 2 - 1}
    return device_step_parity(_train_model("32", small, batch),
                              _train_model("bf16", small, batch), batch_np,
                              dev)


class _Window:
    """A step callback for ``fit``: zeroes the launch counters just after
    step ``start`` (and its logging), reads them and the host clock just
    after step ``stop``, and keeps the last step's metrics."""

    def __init__(self, start: int, stop: int):
        self.start, self.stop = start, stop
        self.t0 = self.seconds = self.counts = self.metrics = None

    def __call__(self, step: int, metrics) -> None:
        self.metrics = metrics
        if step == self.start:
            torch.cuda.synchronize()
            instance_norm.instance_norm_act_cluster.launches = 0
            instance_norm.instance_norm_act_streaming.launches = 0
            instance_norm.instance_norm_act_backward_cluster.launches = 0
            instance_norm.instance_norm_act_backward_streaming.launches = 0
            torch.cuda.reset_peak_memory_stats()
            self.t0 = time.perf_counter()
        elif step == self.stop:
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - self.t0
            self.counts = _counts()


def phase_train(dev, card: str, tmp: Path) -> dict:
    """Training through ``train/loop.py::fit``, the entry point under
    ``train_torch.py``: the timed runs, the determinism runs and the
    checkpoint served at the end are all ``fit``'s."""
    frames, pres, posts, masks, guides = _keyframes()
    data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, device=dev)
    say("train", keyframes=data.num_images, size="270x480",
        patch_centers=len(data), batch=BT)
    rec = {}
    launches = {"forward": 0, "backward": 0, "backward_streaming": 0}
    for prec in ("32", "bf16"):
        model = _train_model(prec, max_steps=TRAIN_WARMUP + TRAIN_STEPS)
        win = _Window(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
        state = fit(model, data, str(tmp / f"run_{prec}"), seed=0,
                    on_step=win)
        fwd, st, bwd, bst = win.counts
        vals = {k: float(v) for k, v in win.metrics.items()}
        finite = all(bool(torch.isfinite(t).all())
                     for t in _net_tensors(state).values())
        if not finite or not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{prec}: non-finite losses or parameters "
                                 f"{vals}")
        if fwd != 25 * TRAIN_STEPS or st != 0 or bwd != 25 * TRAIN_STEPS \
                or bst != 0:
            raise AssertionError(
                f"{prec}: B1 launches {fwd} forward, {st} streaming, {bwd} "
                f"backward cluster, {bst} backward streaming in "
                f"{TRAIN_STEPS} steps; expected 25 forward and 25 backward "
                f"a step, all in the cluster variants")
        launches["forward"] += fwd
        launches["backward"] += bwd
        launches["backward_streaming"] += bst
        ms = 1e3 * win.seconds / TRAIN_STEPS
        rec[prec] = {"ms_per_step": ms, "patches_per_s": BT / ms * 1e3}
        say("train", entry="fit", precision=prec, steps=TRAIN_STEPS,
            warmup_steps=TRAIN_WARMUP, ms_per_step=f"{ms:.2f}",
            patches_per_s=f"{BT / ms * 1e3:.1f}",
            forward_launches_per_step=fwd // TRAIN_STEPS,
            backward_cluster_launches_per_step=bwd // TRAIN_STEPS,
            backward_streaming_launches=bst,
            peak_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}",
            g_total_loss=f"{vals['g_total_loss']:.4f}",
            d_total_loss=f"{vals['d_total_loss']:.4f}", card=f"'{card}'")
        del state

    for prec in ("32", "bf16"):  # determinism: two runs of fit, bitwise
        model = _train_model(prec, max_steps=3)
        runs = [_net_tensors(fit(model, data, str(tmp / f"det_{prec}_{i}"),
                                 seed=5, progress=False))
                for i in range(2)]
        differ = [k for k in runs[0] if not torch.equal(runs[0][k],
                                                        runs[1][k])]
        say("train", entry="fit", precision=prec, determinism_steps=3,
            tensors=len(runs[0]), differing_tensors=len(differ))
        if differ:
            raise AssertionError(f"{prec}: two identical runs differ in "
                                 f"{differ[:5]}")

    for small, batch in ((True, 4), (False, 2)):
        r = _step_parity(dev, small, batch)
        own, cc = r["to_own_reference"], r["card_vs_cpu"]
        say("train", card_vs_cpu="small widths" if small else "full width",
            batch=batch, **{f"loss_d_{k}": f"{v:.3g}"
                            for k, v in r["loss_d"].items()},
            card_to_own_fp64_grad_rel_l2=f"{own['card']['grad_rel_l2']:.3g}",
            card_to_own_fp64_kernel_rel_l2=
            f"{own['card']['kernel_rel_l2']:.3g}",
            card_to_own_fp64_max_param_d=f"{own['card']['worst_kernel']:.3g}",
            cpu_to_own_fp64_grad_rel_l2=f"{own['cpu']['grad_rel_l2']:.3g}",
            card_vs_cpu_grad_rel_l2=f"{cc['grad_rel_l2']:.3g}",
            card_vs_cpu_params_beyond_tolerance=cc["beyond"],
            kinks=r["kinks"], branch_flips=sum(r["flips"].values()),
            flips_by_site=json.dumps(r["flips"]).replace(" ", ""),
            bn_mean_d=f"{r['bn_d'][0]:.3g}", bn_var_d=f"{r['bn_d'][1]:.3g}")
        say("train", card_vs_cpu_bf16="small widths" if small else
            "full width", batch=batch,
            **{f"{net}_grad_rel_l2_to_cpu_fp32": "card {:.3g} cpu {:.3g}".format(
                v["card"], v["cpu"]).replace(" ", "_")
               for net, v in r["bf16"].items()},
            **{f"loss_d_{k}": f"{v:.3g}" for k, v in r["bf16_loss_d"].items()})
        assert_device_step_parity(r)

    # the checkpoint fit wrote at the end of the precision-32 run serves on
    # the card
    path = tmp / "run_32" / "checkpoints" / "last.ckpt"
    cfg = dict(paths={"checkpoint": str(path)}, inference={"precision": "32"})
    frame = frames[0][None]
    mask = erode_full_support_np(masks[0])
    got = StyleTransferInference(inference_config(**cfg)).stylize_group(
        frame, [mask])
    want = StyleTransferInference(inference_config(**cfg),
                                  device="cpu").stylize_group(frame, [mask])
    d = np.abs(got.astype(int) - want.astype(int))
    inside = mask > 0
    changed = float((got[0][inside] != frame[0, ..., :3][inside]).mean())
    say("train", served_checkpoint="run_32/checkpoints/last.ckpt",
        frame="270x480", mask_pixels=int(inside.sum()),
        changed_share_in_mask=f"{changed:.3f}",
        card_vs_cpu_max_abs=int(d.max()), differing_pixels=int((d > 0).sum()))
    if got.shape != (1, 270, 480, 3) or d.max() > 1 or changed < 0.5:
        raise AssertionError(f"serving the trained checkpoint: shape "
                             f"{got.shape}, card vs CPU {d.max()}, changed "
                             f"{changed}")
    return {"rec": rec, "launches": launches}


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
    rec_ff = phase_instance_norm_fullframe(dev)
    rec_bl = phase_blend(dev)
    phase_signed_unit(dev)
    launches = phase_main_path(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        served = phase_serve_directory(dev, card, Path(tmp))
        full = phase_fullframe(dev, card, Path(tmp), served["rec"])
        chain = phase_temporal(dev, card, Path(tmp))
        dflow = phase_temporal_device(dev, card, Path(tmp))
    rec_bw = phase_instance_norm_backward(dev)
    with tempfile.TemporaryDirectory() as tmp:
        train = phase_train(dev, card, Path(tmp))
    rec_in["variants"]["cluster"]["launches"] = launches[
        "instance_norm_act"] + served["launches"]["instance_norm_act"] \
        + chain["launches"]["cluster"] + dflow["launches"]["cluster"]
    rec_in["variants"]["streaming"]["launches"] = launches[
        "instance_norm_act_streaming"] + served["launches"][
        "instance_norm_act_streaming"]
    kernels = [
        dict(name="instance_norm_act", route="cuda",
             source="patch_toon_tpu_torch/csrc/instance_norm.cu",
             replaces="patch_toon_tpu/ops/pallas_norm.py:52",
             launches=launches["instance_norm_act"]
             + served["launches"]["instance_norm_act"]
             + chain["launches"]["cluster"] + dflow["launches"]["cluster"]
             + train["launches"]["forward"],
             launches_by_path={"serve": launches["instance_norm_act"],
                               "serve_directory":
                               served["launches"]["instance_norm_act"],
                               "temporal_tiled": chain["launches"]["cluster"],
                               "temporal_device_tiled":
                               dflow["launches"]["cluster"],
                               "train": train["launches"]["forward"]},
             dtype="bf16", variant="cluster",
             per="19 sites of one 512-tile generator call", **rec_in),
        dict(name="instance_norm_act_split", route="cuda",
             source="patch_toon_tpu_torch/csrc/instance_norm_split.cu",
             replaces="patch_toon_tpu/ops/pallas_norm.py:52",
             launches=full["launches"]["split"] + chain["launches"]["split"]
             + dflow["launches"]["split"],
             launches_by_path={"fullframe": full["launches"]["split"],
                               "temporal_fullframe":
                               chain["launches"]["split"],
                               "temporal_device_fullframe":
                               dflow["launches"]["split"]},
             dtype="bf16", variant="split",
             note="two launches (statistics, normalize) counted as one",
             per="the 19 sites of one full-frame pass over a 512x912 frame",
             **rec_ff),
        *[dict(name=f"instance_norm_act_backward_{v}", route="cuda",
               source="patch_toon_tpu_torch/csrc/instance_norm_bwd.cu",
               replaces="patch_toon_tpu/ops/pallas_norm.py:52",
               note="backward pass of B1; the Pallas kernel has none (JAX "
                    "differentiates patch_toon_tpu/models/layers.py:29-40)",
               launches=train["launches"][key], dtype="bf16", variant=v,
               picked_by_plan_backward=v == "cluster",
               per="the 25 sites of one training step at batch 80",
               **rec_bw[v])
          for v, key in (("cluster", "backward"),
                         ("streaming", "backward_streaming"))],
        dict(name="blend_tiles", route="cuda",
             source="patch_toon_tpu_torch/csrc/blend.cu",
             replaces="patch_toon_tpu/ops/pallas_blend.py:116",
             launches=launches["blend_tiles"]
             + served["launches"]["blend_tiles"] + chain["launches"]["blend"]
             + dflow["launches"]["blend"],
             launches_by_path={"serve": launches["blend_tiles"],
                               "serve_directory":
                               served["launches"]["blend_tiles"],
                               "temporal_tiled": chain["launches"]["blend"],
                               "temporal_device_tiled":
                               dflow["launches"]["blend"]},
             per="one group of 3 512x910 frames", **rec_bl),
    ]
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels, "train": train["rec"],
                      "serve_directory": served["rec"],
                      "fullframe": full["rec"], "temporal": chain["rec"],
                      "temporal_device": dflow["rec"]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
