#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (patch_toon_tpu_torch).

    python3 chip_smoke.py [--multi-gpu]

Needs one CUDA card; run from the root of a checkout. ``--multi-gpu`` runs
the build, phase 11 and phase 14's NCCL forms alone (for a machine with
several cards). Phases, one or more lines each, flushed as they go (phase
12, ``int8``, runs after ``multistream``, phase 13, ``transport``, after
it, and phase 14, ``tensor_parallel``, after ``train_rest``):

1. ``build``: the nvcc build of ``patch_toon_tpu_torch/csrc/*.cu`` (seconds,
   and each kernel's registers, shared memory and spills as ptxas reports
   them).
2. ``instance_norm``: kernel B1's cluster and streaming variants, and the
   sample variant forced where a sample fits 8 CTAs (18 of the 19 sites),
   against its plain PyTorch version at the five main-path shapes of a
   512-tile generator call, fp32 and bf16, each activation. Tolerance: fp32
   |d| <= 1e-5 + 1e-5 |ref|; bf16 one bf16 ulp of the value (2^-7
   relative) + 1e-5. The variants timed in turns by CUDA events
   (streaming, cluster, sample, sample, cluster, streaming), the plain
   version and the library call (``F.instance_norm`` + activation), the
   bound and the share of it; per-call totals over the 19 sites, the
   sample variant's beside the cluster variant's at its 18. Then the tile
   call at odd C (each site's C - 1 channels, as ``plan`` gives them: the
   sample variant at 18 sites, the streaming one at 80x80x127), each site
   against the plain version and timed.
   ``instance_norm_fullframe``: B1 at the 19 sites of one full-frame pass
   over a 512x910 frame (512x912 after padding), bf16 and fp32: the
   variant ``plan`` picks (the resident variant where the plane's chunks
   fit the SMs' shared memory: 18 sites at bf16, 16 at fp32; the split
   variant at the rest) and the split variant at every site, each against
   the plain version with the tolerance above, its statistics within 1e-5,
   and bitwise equal to a second call; at the quarter-resolution sites
   also the cluster variant at the largest G whose unit fits 8 CTAs. Timed
   as device time (``queued_ms``, over input copies beyond twice the L2
   cache): resident and split A B B A where the plan picks the resident
   variant, split and streaming A B B A elsewhere, streaming, the cluster
   alternative, the plain version and the library; per-frame totals and
   per-variant totals against the bound.
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
   Then, at bf16, 32 and ``32_fast``, a 3-frame group and a lone frame
   through two plans built by hand, JAX's padded one (``bucket_size``
   rows) and the real tiles alone: rows, device ms each way, outputs
   within 1 count; the engine's own plan (``pack_rows``: the bucket at
   precision 32, the real tiles at bf16 and ``32_fast``) within 1 count
   and no more than 5 % slower than the padded plan; at 32 the lone
   frame's call traced both ways. Last, the precision-32 generator alone at 100, 170, 360 and 510
   tiles: one batch, the bucket, and power-of-two sub-batches, timed.
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
   before and read just after (19 B1 launches a frame, in the resident and
   split variants as ``plan`` gives the sites, none of the other B1
   variants, no B2), ms a frame beside the tiled run; its files
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
7. ``instance_norm_backward``: B1's backward kernel, the cluster and
   streaming variants and the sample variant forced where a sample's x
   and dy fit 8 CTAs, against its plain version at every InstanceNorm site
   of a training step (batch 80, the generator's 19 sites and the
   discriminator's 2 at its 3 calls), fp32 and bf16, each bitwise equal to
   a second call of itself, with the forward pass's statistics checked
   too. Tolerance: fp32 |d| <= 2e-5 + 2e-5 |ref|; bf16
   one bf16 ulp + 1e-5. Timed as device time (CUDA events around calls
   queued behind a spin kernel, over copies of the inputs that exceed the
   L2 cache): the variants in turns (cluster, sample, streaming, three
   times; the median of three each), against the
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

9. ``train_rest``: the training knobs of the ninth slice through ``fit``
   at full width, batch 80, on the train phase's keyframes. (a)
   ``data.sampling=permutation``: the sampler alone over 2,500 batches,
   each image's cycle between two resets covering each of its centres
   exactly once (a hit table on the card), the straddling draws of
   PARITY_NOTES #16 counted apart; two bf16 ``fit`` runs of 12 steps
   bitwise equal. (c) In those runs ``image_log_freq=4`` with a spy
   logger: images at steps 4, 8 and 12, of shape (8 x 84, 4 x 84, 3), the
   last bitwise the copied numpy function's grid of the step's batch and an
   eval-mode forward with the final parameters, both on the card. (b)
   ``accumulate_grad_batches=2`` at 32 and bf16: two runs of 4
   micro-steps bitwise equal, the parameters of both networks bitwise
   unchanged after the odd micro-steps and after the even ones within
   1e-6 (relative to each tensor's largest value) of one Adam step on the
   Welford mean of the two gradients, computed on the card; ms a
   micro-step at k = 2 against a step at k = 1, timed in turns. (d)
   ``profile_dir``: the Chrome trace of epoch 0 names B1's kernels and
   cuDNN's convolutions; its size and epoch 0's extra ms.
10. ``guides``: the guide-channel tools on the card with Pillow made
   unimportable, over a 25-frame 512x910 scene (a textured plane panning
   5 px right and 2 px down a frame, PNG masks of an ellipse moving with
   it): ``tools/optical_flow_torch.py`` makes the flows;
   ``tools/gaussian_filter_torch.py`` at sigma 10 and 15 (radius 10,
   keyframes 1, 11, 21, 24 of frames 1-24, process_pipeline's pick) on the
   card, one splat launch a frame, and with the CPU asked for, every frame
   within 1 count, the differing pixels printed, ms a frame split into
   flow reads, advection, splat and PNG; the splat kernel bitwise its
   plain version on keyframe 11's points at each sigma, timed at sigma 15
   (device time, ``queued_ms``) against its bound; ``tools/temporal_guide_torch.py``
   over the scene, card against CPU within 1 count.
   ``pipeline``: the guide pipeline with Pillow made unimportable, on a
   12-frame 1080x1920 RGBA shot (``_pipeline_scene``):
   ``tools/process_pipeline_torch.py`` at ``--resize-mode width
   --resize-value 910`` (the port's LANCZOS resize and quality-95 JPEG
   writer, 511x910 frames; the flow and the splats on the card, one splat
   launch a frame and sigma); the C++ resize bitwise its numpy plain
   version on frame 1 (L and RGB); the codec against the committed Pillow
   fixtures (``tests/data/jpeg``: every baseline file decoded bitwise,
   ``src.png`` encoded byte for byte); the guides within 1 count of the
   same tool with the CPU asked for; the native JPEG decodes counted
   against the JPEG files the steps read, no PIL decode; each step's
   seconds a frame and the codec's ms for one 511x910 JPEG against one
   PNG. Then ``process_directory`` serves the prepared scene (JPEG frames
   under .png names, ``mask/*.jpg``, ``gauss_r10_s10`` as the guide) at
   bf16, tiled: 19 B1 cluster launches and one B2 launch a group, every
   pixel outside the masks its input within 1 count.

11. ``multi_gpu``: several cards through the entry points, on whatever
   cards the machine has (each card's name and power limit printed, and
   the link ``nvidia-smi topo -m`` shows between cards 0 and 1). On any
   count: ``process_directory`` over the 36 frames, tiled, bf16 and 32, at
   ``inference.devices=1`` (timed; the reference) and at
   ``inference.devices=-1``, bitwise equal to it, with the launch counters
   zeroed just before and read just after by card (19 B1 cluster launches
   and one B2 launch a card a group); two engines at ``file_shard`` 0/2
   and 1/2 whose files together are bitwise the one-device run's; ``fit``
   (12 steps, batch 80, bf16 and 32) on ``training.devices=-1`` ranks
   spawned by ``parallel.spawn`` (NCCL), bitwise equal to the plain
   ``fit`` of the ``train`` phase, 25 forward and 25 backward cluster
   launches a step on each rank, none streaming. One line says what did
   not run on one card. With 2+ cards (``python3 chip_smoke.py
   --multi-gpu`` runs the build and this phase alone): the same directory
   at 2 and 4 devices, tiled and full-frame, bf16 and 32, eq-frames/s and
   each card's busy share beside the one-card run, the files within 1
   count of it (the differing pixels printed); with 4 cards 4 processes
   at ``file_shard`` k/4, one card each, started together, eq-frames/s
   and their files within 1 count of one process; ``fit`` over 1, 2 and 4
   ranks, ms a step, the ranks bitwise equal, two runs of the largest
   world bitwise equal, the largest world against one rank after 12 steps
   (the update's relative L2 distance, limits 1e-1 at 32 and 5e-1 at
   bf16), the gradients' all-reduce timed (two coalesced calls, G's and
   D's) against the ring bound over the link, and one small-width step of
   the ranks held to the fp64 one-device step that takes their branches
   (``train/parity.py``, 5e-5). With 2+ cards also int8 serving
   (``inference.quantize: int8``) over 2 cards, bitwise the one-card int8
   run, every replica with card 0's scales.
12. ``int8``: w8a8 serving. The kernels of ``csrc/quant_conv.cu``
   (``quantize_act``; ``conv_s8``, whose plan takes the gather kernel or,
   at conv11 and the smoothers, the halo kernel) bitwise their plain
   versions (the int8 activation, the int32 accumulator, the output with
   its bias) at the 22 sites' shapes on 16 tiles, at one full-frame
   512x912 pass and at shapes
   off the tile, bf16 and fp32; each site at B = 512 in bf16 timed
   (device time) against its bound (int8 operations at 1,979 TOPS or bytes
   at 3.35 TB/s), the plain versions, cuDNN's bf16 convolution at the
   same shape and ``torch._int_mm`` over the site's explicit im2col (at
   most 2 GB of it, scaled to B = 512; checked against ``conv_s8``'s
   accumulator); the serve_directory phase's 36 frames, tiled and
   full-frame, bf16 with ``quantize: int8``: a set-up run that calibrates
   once, a timed run with the counters zeroed just before and read just
   after (22 launches of each int8 wrapper a generator call, conv_s8's 19
   on the gather kernel and 3 on the halo kernel; B1 and B2 as in the bf16
   runs), eq-frames/s beside the bf16 run, masked PSNR against it (at
   least 35 dB); one int8 generator call of 512 tiles against a bf16 call;
   the card against the CPU at precision 32 on a 256x456 crop, the card's
   scales copied to the CPU engine (limit 1 count; the share of differing
   pixels printed). No other phase launches either kernel but
   ``transport``'s int8 run.
13. ``transport``: the transport knobs at JAX's defaults
   (``crop_upload`` and ``crop_readback`` on, ``mask_upload: packed``)
   over 12 frames of 512x910 (``write_scene``'s frames, an ellipse mask
   of about a quarter of the frame drifting 3 px down and 5 px right a
   frame), full width with the trained checkpoint: tiled bf16 (timed
   defaults, off, off, defaults) and 32, full-frame bf16 (the readback
   crop alone) and the device-flow chain (tiled bf16, the
   ``temporal_device`` masks: readback crop and packed flow masks), each
   with the defaults and with ``crop_readback=off crop_upload=off
   mask_upload=plane``, the two runs' files bitwise equal; each timed run
   with the counters zeroed just before and read just after (19 B1
   launches and one B2 launch a group, full-frame as ``_ff_launches``);
   bytes up and down a frame through the pinned buffers, eq-frames/s, the
   host split (upload, readback wait, writer drain), the upload windows
   and readback boxes, both ways. B1 (each InstanceNorm site of one bf16
   generator call on the first cropped group's tiles, ``_in_check``'s
   tolerance) and B2 (that group's window canvas, bitwise) against their
   plain versions. int8 with the defaults (calibrated on the first
   window), masked PSNR against the bf16 default run at least 35 dB.

14. ``tensor_parallel``: conv-channel tensor parallelism
   (``parallel/tp.py``, ``parallel.mesh.model``) at the shipped widths (G
   with 6 input channels and 7 blocks, D with 12 filters and 2 layers,
   seeded weights), batch 80 of 80x80 patches of the train phase's
   keyframes, bf16 and 32. On any card count: each rank's share of the
   sharded eval forward of G and D in turn on the one card
   (``TurnGroup``), at model 2 and 4: every site's conv slice and B1 on
   its channel slice, the assembled B1 outputs within ``_in_check``'s
   tolerance of the plain version on the assembled input, the launches by
   variant and card as ``plan`` gives each slice (the sample variant
   where C/m x the item size is not a multiple of 16 bytes), the
   generator within 1 count of the one-card forward at 32 (bf16's
   distance printed); ``fit`` at ``training.devices=1
   parallel.mesh.model=2`` bitwise the train phase's plain ``fit`` (JAX
   builds no mesh at one device). One line says what did not run for want
   of cards. Then B1's forward and backward at each (slice shape,
   activation, dtype) those forwards gave a rank, dy a rank's channel slice
   of the gathered gradient: the variant ``plan_for`` and
   ``plan_backward_for`` pick (the sample variant at D's 6- and 12-channel
   slices, reading dy through its stride) against the plain version (the
   tolerances of instance_norm and instance_norm_backward), each timed
   beside its bound, the plain version and the library's; at the sample
   variant's sites also the streaming kernels that took them before, dy's
   copy, and the sample variant at twice the CTAs a sample; per-step sums
   by variant. Then B1 under autograd (``InstanceNormAct``) at a rank's 25
   sites of one step: dy copies a step a rank against the plans' count
   (the strided dy slices the sample variant does not take), launches by
   variant, and the sample sites' dx bitwise the copied dy's. With 2+ cards (``--multi-gpu``, after the multi_gpu phase,
   whose data-parallel runs are the yardsticks), NCCL ranks that
   ``parallel.spawn`` starts: the sharded forward at model 2 (and 4 with
   4 cards) against the one-card forward as above, the ranks of a model
   group bitwise equal; ``fit`` at data 1 x model 2, data 2 x model 2 and
   data 1 x model 4 (those that fit): ms a step beside data parallelism on
   the same cards and one card, every rank's whole parameters (gathered
   over the model group) bitwise equal, two runs of data 2 x model 2
   bitwise equal, the update after 12 steps within 1e-1 (32) / 5e-1 (bf16)
   in relative L2 of the d-rank data-parallel run's, B1's launches by
   variant and card and the dy copies a step a rank; one step's
   collectives (recorded
   in ``fit``, then replayed alone with the ranks in step, CUDA events):
   the activation gathers with and without their interleave copy, the
   input-gradient all-reduces, the small ones, the data group's gradient
   all-reduce, against the ring bound of their bytes over the link; one
   small-width step held to the fp64 one-device step that takes the ranks'
   branches (5e-5); the precision-32 checkpoint of a one-step ``fit`` at
   full width served on one card within 1 count of the same-data
   data-parallel run's (d ranks) served the same way; the 12-step
   checkpoints' served distance printed beside data parallelism's own 2-
   and 4-rank against 1-rank distance.

15. ``orbax``: the JAX package's Orbax checkpoint
   ``docs/quality_2000/ours_ckpt/last`` (the shipped model at full width,
   step 2000) with jax, orbax, tensorstore, zstandard and the JAX package
   unimportable: ``utils/orbax.py`` (the port's OCDBT reader and zstd
   decoder, ``native/zstd.cpp``) reads every leaf, each held to the
   committed digest ``tests/data/orbax/quality_2000_last.json`` (SHA-256
   of JAX's restore), the read's seconds and the decoder's MB/s printed;
   ``process_directory`` serves 6 frames of 512x910 from the directory,
   tiled and full-frame at bf16, with the counters zeroed just before and
   read just after (19 B1 launches a generator call, one B2 launch a
   tiled group); precision 32 on a masked frame, card against the CPU
   engine on the same directory (limit 1 count); ``fit`` resumed from the
   directory for 3 steps at batch 80, bf16: Adam's moments as loaded
   bitwise the digest-checked tree, the step and Adam's counts going on
   from the checkpoint's, 25 forward and 25 backward B1 cluster launches a
   step; ``tools/export_checkpoint_torch.py`` exports the directory (jax
   and the rest still unimportable) and the exported file serves the 6
   frames tiled, bitwise the directory's.
16. ``deep_vgg`` (after ``train_rest``): ``fit`` at batch 80, bf16, with
   the perceptual VGG19 to features index 21 and no weights file (JAX's
   seed-42 draw, timed where ``fit`` makes it): 1 + 3 steps, 25 forward
   and 25 backward B1 cluster launches a step, the losses finite.
17. ``cli``: the CLIs as a user runs them, each a process of its own
   (``CLI_SERVICE``) with PyYAML unimportable, the config read and written
   by ``config/yamlio.py``: ``python train_torch.py`` at the shipped
   configuration from a directory without the sample scene (the CLI makes
   the 7-frame 270x480 scene under ``test_dataset/``),
   ``training.max_steps=12`` at precision 32 and bf16: ms a step over steps
   3-12, 25 forward and 25 backward B1 cluster launches a step counted in
   the process, ``<run>/config.yaml`` read back equal to ``compose``'s
   tree and byte for byte ``yamlio.dump``'s; then ``python
   generator_torch.py model=default ...`` serves the scene from the
   precision-32 ``last.ckpt`` (tiled, bf16), its B1 and B2 launches
   counted in the process and equal to an in-process
   ``StyleTransferInference``'s on the same checkpoint and config, every
   frame bitwise that engine's.

Then, on lines of their own: the kernels' JSON record, the card's name and
power limit (nvidia-smi), and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero before the last line; nothing falls back
to the CPU or to a plain version. A process alarm ends a run that hangs.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import math
import logging
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from patch_toon_tpu_torch import _build, parallel
from patch_toon_tpu_torch.config.defaults import (
    inference_config,
    training_config,
)
from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
from patch_toon_tpu_torch.data.io import decode_rgb_uint8
from patch_toon_tpu_torch.infer.common import SIGNED_UNIT, _to_signed_unit
from patch_toon_tpu_torch.infer.engine import (
    StyleTransferInference,
    _resolve_dtype,
)
from patch_toon_tpu_torch.infer.pipeline import GroupPipeline
from patch_toon_tpu_torch.infer.temporal import (
    FlowGraphs,
    _device_gray,
    _temporal_device_flow,
)
from patch_toon_tpu_torch.infer.programs import gather_tiles, make_tile_plan
from patch_toon_tpu_torch.data import resample
from patch_toon_tpu_torch.native.frameio import (
    decode_counts,
    decode_native,
    decode_png,
    library as frameio_library,
    encode_jpeg,
    encode_png,
    resize_lanczos,
    zero_decode_counts,
)
from patch_toon_tpu_torch.models import discriminator as disc_module
from patch_toon_tpu_torch.models import generator as gen_module
from patch_toon_tpu_torch.models import layers
from patch_toon_tpu_torch.models.discriminator import DiscriminatorN_IN
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.infer.tiling import (
    bucket_size,
    pack_boxes_multi,
    tile_boxes_from_mask,
)
from patch_toon_tpu_torch.ops import blend, instance_norm
from patch_toon_tpu_torch.ops import quant
from patch_toon_tpu_torch.ops import splat as ops_splat
from patch_toon_tpu_torch.ops.flow import dense_flow
from patch_toon_tpu_torch.ops.masks import erode_full_support_np
from patch_toon_tpu_torch.parallel import comm
from patch_toon_tpu_torch.parallel.tp import (
    ModelShard,
    TurnGroup,
    gather_from_model,
    model_shard,
    shard_module_,
)
from patch_toon_tpu_torch.train import optim
from patch_toon_tpu_torch.train.checkpoints import (
    CheckpointManager,
    whole_state,
)
from patch_toon_tpu_torch.train.logging import build_comparison_grid
from patch_toon_tpu_torch.train import loop as loop_module
from patch_toon_tpu_torch.train.loop import fit
from patch_toon_tpu_torch.train.model import (
    StyleTransferModel,
    training_backends,
)
from patch_toon_tpu_torch.utils import orbax as orbax_reader
from patch_toon_tpu_torch.utils.weights import (
    generator_state_from_jax,
    load_quant_scales,
)
from patch_toon_tpu_torch.train.parity import (
    Kinks,
    assert_device_step_parity,
    assert_first_step_close,
    device_step_parity,
    first_step_agreement,
    run_step,
    state_pairs,
)

REPO = Path(__file__).resolve().parent
CKPT = REPO / "docs" / "quality_2000" / "torch_train.ckpt"
ALARM_S = 1100            # the whole run, build included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM, fp32 outside the tensor cores
INT8_OPS = 1979e12         # H100 SXM, dense int8 tensor-core operations
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
HP, WP = 512, 912


def _ff_sites(hp: int, wp: int) -> list:
    """((H, W, C), activation) of each InstanceNorm site of one full-frame
    generator pass over a frame padded to hp x wp
    (infer/programs.py::make_fullframe_fn): stem, 2 downsamples, 7 residual
    blocks x 2, 2 upsamples."""
    return ([((hp, wp, 32), "leaky_relu"),
             ((hp // 2, wp // 2, 64), "leaky_relu"),
             ((hp // 4, wp // 4, 128), "leaky_relu")]
            + [((hp // 4, wp // 4, 128), "relu"),
               ((hp // 4, wp // 4, 128), None)] * 7
            + [((hp // 2, wp // 2, 128), "relu"), ((hp, wp, 128), "relu")])


# the sites of a 512x910 frame, padded to 512x912
FF_SITES = _ff_sites(HP, WP)
BT = 80  # patches per training step (config/training/default.yaml)
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
# the InstanceNorm sites of one training step, forward and backward alike:
# the generator's 19, then the discriminator's 2 (20x20x24, 19x19x48 at 12
# filters) in each of its 3 calls (real and fake in the D phase, fake in
# the G phase)
TRAIN_SITES = SITES + [((20, 20, 24), "leaky_relu"),
                       ((19, 19, 48), "leaky_relu")] * 3


PHASE_SECONDS: dict = {}  # each phase's wall seconds, printed at the end


@contextlib.contextmanager
def _clock(name: str):
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_lines() -> list:
    """Each card's name and power limit, as nvidia-smi prints them."""
    return [line.strip() for line in subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()]


def card_line() -> str:
    return card_lines()[0]


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
    if lib.ptt_instance_norm_resident_bytes() != \
            instance_norm.RESIDENT_CTA_BYTES:
        raise AssertionError("csrc/b1_common.cuh and ops/instance_norm.py "
                             "disagree on a resident CTA's chunk budget")
    for ppc, c, item, bwd in ((400, 12, 2, 0), (361, 6, 4, 1), (2, 301, 2, 1),
                              (1950, 13, 4, 0)):
        if lib.ptt_instance_norm_sample_smem(ppc, c, item, bwd) != \
                instance_norm.sample_smem(ppc, c, item, bool(bwd)):
            raise AssertionError("csrc/instance_norm_sample.cu and "
                                 "ops/instance_norm.py disagree on a sample "
                                 "CTA's shared memory")


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
    """The cluster and streaming variants, and the sample variant forced
    where a sample fits 8 CTAs (18 of the 19 sites), against the plain
    version at every (shape, activation, dtype) of the main path, then
    timed in turns in this one process (streaming, cluster, sample,
    sample, cluster, streaming); the per-call numbers sum the 19 sites of
    one 512-tile generator call. Then the same call at odd C (C - 1
    channels a site, as ``plan`` gives them: the sample variant, the
    streaming one at 80x80x127), each site against the plain version and
    timed beside the cluster variant at the even C."""
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
            sp = instance_norm.sample_plan(B, *shape, dtype)
            fns = dict(variants)
            if sp is not None:
                fns["sample"] = lambda xc, act: instance_norm. \
                    instance_norm_act_sample(xc, act, p=sp)
            bound = 2 * x.nbytes / HBM_BYTES_PER_S * 1e3
            for act in (None, "relu", "leaky_relu"):
                want = instance_norm.instance_norm_act_plain(x, act)
                r = {f"err_{v}": _in_check(fn(x, act), want, dtype)
                     for v, fn in fns.items()}
                del want
                ms = {v: [] for v in fns}
                for v in ("streaming", "cluster", "sample", "sample",
                          "cluster", "streaming"):
                    if v in fns:
                        ms[v].append(time_ms(lambda: fns[v](x, act), 10))
                r.update({f"ms_{v}": sum(t) / len(t) for v, t in ms.items()})
                r["plain_ms"] = time_ms(
                    lambda: instance_norm.instance_norm_act_plain(x, act), 3)
                r["library_ms"] = time_ms(lambda: _library_in(x, act), 3)
                per[(dtype, shape, act)] = r
                say("instance_norm", dtype=str(dtype).split(".")[1],
                    shape=f"{B}x{shape[0]}x{shape[1]}x{shape[2]}", act=act,
                    k=p.k, G=p.group, cta_kb=f"{p.cta_bytes / 1024:.1f}",
                    sample_k=sp.k if sp else None,
                    **{f"{v}_ms": f"{r[f'ms_{v}']:.4f}" for v in ms},
                    **{f"{v}_runs": "/".join(f"{t:.4f}" for t in ms[v])
                       for v in ms},
                    bound_ms=f"{bound:.4f}",
                    **{f"{v}_share_of_bound": f"{bound / r[f'ms_{v}']:.3f}"
                       for v in ms},
                    plain_ms=f"{r['plain_ms']:.4f}",
                    library_ms=f"{r['library_ms']:.4f}",
                    **{f"max_abs_err_{v}": f"{r[f'err_{v}']:.3g}"
                       for v in fns})
            del x
    rec = {"variants": {v: {} for v in variants}, "sample_tile_call": {},
           "odd_c_tile_call": {}}
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
        # the sample variant forced at the sites a sample fits 8 CTAs,
        # beside the cluster variant at the same sites
        fit = [r for r in rows if "ms_sample" in r]
        rec["sample_tile_call"].update({
            f"sites{tag}": len(fit),
            f"ms{tag}": sum(r["ms_sample"] for r in fit),
            f"cluster_ms{tag}": sum(r["ms_cluster"] for r in fit),
            f"max_abs_err{tag}": max(r["err_sample"] for r in fit)})
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
            library_ms=f"{rec['library_ms' + tag]:.4f}",
            sample_sites=rec["sample_tile_call"]["sites" + tag],
            sample_forced_ms=f"{rec['sample_tile_call']['ms' + tag]:.4f}",
            cluster_at_those_sites_ms=
            f"{rec['sample_tile_call']['cluster_ms' + tag]:.4f}")
    # the tile call at odd C: each site's C - 1 channels, the plan's
    # variant (sample, or streaming where a sample exceeds 8 CTAs)
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        odd = {}
        for (h, w, c), act in sorted(set(SITES), key=str):
            x = (torch.randn((B, h, w, c - 1), device=dev, generator=gen)
                 * 2.0 + 0.5).to(dtype)
            v = instance_norm.plan_for(x).variant
            if v not in ("sample", "streaming"):
                raise AssertionError(f"{x.shape} {dtype}: plan {v}")
            fn = B1_WRAPPERS[v]
            err = _in_check(fn(x, act), instance_norm.instance_norm_act_plain(
                x, act), dtype)
            odd[((h, w, c), act)] = (v, time_ms(lambda: fn(x, act), 10), err)
            del x
        sites = [odd[k] for k in SITES]
        rec["odd_c_tile_call"].update({
            f"ms{tag}": sum(t for _, t, _ in sites),
            f"sample_sites{tag}": sum(v == "sample" for v, _, _ in sites),
            f"sample_ms{tag}": sum(t for v, t, _ in sites if v == "sample"),
            f"streaming_ms{tag}": sum(t for v, t, _ in sites
                                      if v == "streaming"),
            f"max_abs_err{tag}": max(e for _, _, e in sites)})
        say("instance_norm", per_call_at_odd_c=str(dtype).split(".")[1],
            sites=len(sites),
            variants=",".join(f"{h}x{w}x{c - 1}:{act}:{v}:{t:.4f}"
                              for ((h, w, c), act), (v, t, _)
                              in sorted(odd.items(), key=str)),
            ms=f"{rec['odd_c_tile_call']['ms' + tag]:.4f}",
            sample_sites=rec["odd_c_tile_call"]["sample_sites" + tag],
            sample_ms=f"{rec['odd_c_tile_call']['sample_ms' + tag]:.4f}",
            streaming_ms=
            f"{rec['odd_c_tile_call']['streaming_ms' + tag]:.4f}",
            cluster_at_even_c_ms=f"{rec['ms' + tag]:.4f}",
            max_abs_err=f"{rec['odd_c_tile_call']['max_abs_err' + tag]:.3g}")
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


def _ff_runs(fns: dict, copies: list, picked: str) -> dict:
    """Device ms (``queued_ms`` over the input copies) of the variants in
    turns: the resident variant and the split variant A B B A, then the
    streaming variant, where the plan picks the resident one; else split
    and streaming A B B A. -> runs by variant."""
    order = ((picked, "split", "split", picked, "streaming")
             if picked == "resident" else
             ("split", "streaming", "streaming", "split"))
    reps = max(4, 2 * len(copies))
    ms = {v: [] for v in order}
    for v in order:
        ms[v].append(queued_ms([fns[v](xc) for xc in copies], reps))
    return ms


def phase_instance_norm_fullframe(dev) -> dict:
    """B1 at the 19 sites of one full-frame generator pass over a 512x910
    frame (padded to 512x912), bf16 and fp32. At each site the variant
    ``plan`` picks (the resident variant where the plane's chunks fit the
    SMs' shared memory, the split variant where they do not) and, where it
    picks the resident one, the split variant too (at the plan
    ``split_plan`` gives), each against the plain version (``_in_check``),
    its statistics against the plain version's, and two calls bitwise
    equal; at the quarter-resolution sites the cluster variant at the least
    G that fits 8 CTAs as well, which ``plan`` does not take. Then timed as
    device time (``queued_ms``, over input copies beyond twice the L2
    cache): the plan's variant and the split variant A B B A where the plan
    picks the resident one (then the streaming variant), else split and
    streaming A B B A; the quarter-resolution cluster alternative, the
    plain version and the library (``F.instance_norm`` + activation).
    Per-frame totals over the 19 sites against the bound (one read and one
    write of each site's tensor), and per variant over the sites the plan
    gives it."""
    gen = torch.Generator(device=dev).manual_seed(4)
    per = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, act in sorted(set(FF_SITES), key=str):
            x = (torch.randn((1,) + shape, device=dev, generator=gen) * 2.0
                 + 0.5).to(dtype)
            p = instance_norm.plan_for(x)
            if p.variant not in ("resident", "split"):
                raise AssertionError(f"{shape} {dtype}: plan {p}")
            sp = instance_norm.split_plan(1, *shape, dtype)
            fns = {"resident": lambda xc: lambda: instance_norm.
                   instance_norm_act_resident(xc, act),
                   "split": lambda xc: lambda: instance_norm.
                   instance_norm_act_split(xc, act, p=sp),
                   "streaming": lambda xc: lambda: instance_norm.
                   instance_norm_act_streaming(xc, act)}
            want, pmean, prstd = instance_norm._plain_forward(x, act, 0.2,
                                                              1e-5)
            r = {"variant": p.variant}
            for v in dict.fromkeys((p.variant, "split")):
                kw = {"p": sp} if v == "split" else {}
                got, mean, rstd = B1_WRAPPERS[v](x, act, stats=True, **kw)
                err = _in_check(got, want, dtype)
                stats_err = max(float((mean - pmean).abs().max()),
                                float(((rstd - prstd) / prstd).abs().max()))
                if stats_err > 1e-5:
                    raise AssertionError(f"{shape} {dtype} {v}: statistics "
                                         f"{stats_err}")
                if not torch.equal(got, B1_WRAPPERS[v](x, act, **kw)):
                    raise AssertionError(f"{shape} {dtype}: the {v} variant "
                                         "is not repeatable")
                r[f"err_{v}"], r[f"stats_err_{v}"] = err, stats_err
            r["err"], r["stats_err"] = r[f"err_{p.variant}"], \
                r[f"stats_err_{p.variant}"]
            small = _fitting_cluster(shape, dtype)
            if small is not None:
                r["err_cluster"] = _in_check(
                    instance_norm.instance_norm_act_cluster(x, act, p=small),
                    want, dtype)
            del want, got
            copies = _input_copies(x)
            ms = _ff_runs(fns, copies, p.variant)
            r.update({f"ms_{v}": sum(t) / len(t) for v, t in ms.items()})
            r["ms"] = r[f"ms_{p.variant}"]
            if small is not None:
                r["ms_cluster"] = queued_ms(
                    [lambda xc=xc: instance_norm.instance_norm_act_cluster(
                        xc, act, p=small) for xc in copies],
                    max(4, 2 * len(copies)))
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
                variant=p.variant, G=p.group, chunks=p.chunks,
                pixels_a_chunk=p.ppc, chunk_kb=f"{p.cta_bytes / 1024:.1f}",
                ms=f"{r['ms']:.4f}",
                **{f"{v}_ms": f"{r[f'ms_{v}']:.4f}" for v in ms},
                **{f"{v}_runs": "/".join(f"{t:.4f}" for t in ms[v])
                   for v in ms},
                bound_ms=f"{r['bound_ms']:.4f}",
                share_of_bound=f"{r['bound_ms'] / r['ms']:.3f}",
                split_share_of_bound=f"{r['bound_ms'] / r['ms_split']:.3f}",
                cluster_small_g=(f"G{small.group}k{small.k}"
                                 if small else None),
                cluster_ms=(f"{r['ms_cluster']:.4f}" if small else None),
                plain_ms=f"{r['plain_ms']:.4f}",
                library_ms=f"{r['library_ms']:.4f}",
                max_abs_err=f"{r['err']:.3g}",
                max_abs_err_split=f"{r['err_split']:.3g}",
                max_abs_err_cluster=(f"{r['err_cluster']:.3g}"
                                     if small else None),
                stats_err=f"{r['stats_err']:.3g}")
    rec = {"resident": {}, "split": {}}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        sites = [(s, a, per[(dtype, s, a)]) for s, a in FF_SITES]
        rows = [r for _, _, r in sites]
        elems = sum(s[0] * s[1] * s[2] for s, _ in FF_SITES)
        bytes_ms = 2 * elems * dtype.itemsize / HBM_BYTES_PER_S * 1e3
        ops_ms = 8 * elems / FP32_FLOPS * 1e3
        rec.update({
            f"ms{tag}": sum(r["ms"] for r in rows),
            f"split_ms{tag}": sum(r["ms_split"] for r in rows),
            f"streaming_ms{tag}": sum(r["ms_streaming"] for r in rows),
            f"plain_ms{tag}": sum(r["plain_ms"] for r in rows),
            f"library_ms{tag}": sum(r["library_ms"] for r in rows),
            f"bound_ms{tag}": max(bytes_ms, ops_ms),
            f"bound_by{tag}": "bytes" if bytes_ms >= ops_ms else "operations",
            f"max_abs_err{tag}": max(r["err"] for r in rows),
            f"quarter_sites_ms{tag}": sum(
                r["ms"] for r in rows if "ms_cluster" in r),
            f"quarter_sites_cluster_ms{tag}": sum(
                r["ms_cluster"] for r in rows if "ms_cluster" in r)})
        # each variant over the sites the plan gives it, for the kernels
        # line (bound: its sites' bytes; 8 operations an element beside)
        for v in ("resident", "split"):
            mine = [(s, r) for s, _, r in sites if r["variant"] == v]
            e = sum(s[0] * s[1] * s[2] for s, _ in mine)
            b_ms = 2 * e * dtype.itemsize / HBM_BYTES_PER_S * 1e3
            o_ms = 8 * e / FP32_FLOPS * 1e3
            rec[v].update({
                f"sites{tag}": len(mine),
                f"ms{tag}": sum(r["ms"] for _, r in mine),
                f"split_ms{tag}": sum(r["ms_split"] for _, r in mine),
                f"plain_ms{tag}": sum(r["plain_ms"] for _, r in mine),
                f"library_ms{tag}": sum(r["library_ms"] for _, r in mine),
                f"bound_ms{tag}": max(b_ms, o_ms),
                f"bound_by{tag}": "bytes" if b_ms >= o_ms else "operations",
                f"max_abs_err{tag}": max((r["err"] for _, r in mine),
                                         default=0.0)})
        say("instance_norm_fullframe", per_frame=str(dtype).split(".")[1],
            sites=len(FF_SITES), elements=elems,
            resident_sites=rec["resident"]["sites" + tag],
            split_sites=rec["split"]["sites" + tag],
            ms=f"{rec['ms' + tag]:.4f}",
            bound_ms=f"{rec['bound_ms' + tag]:.4f}",
            share_of_bound=f"{rec['bound_ms' + tag] / rec['ms' + tag]:.3f}",
            split_at_every_site_ms=f"{rec['split_ms' + tag]:.4f}",
            split_share_of_bound=
            f"{rec['bound_ms' + tag] / rec['split_ms' + tag]:.3f}",
            resident_sites_ms=f"{rec['resident']['ms' + tag]:.4f}",
            resident_sites_split_ms=
            f"{rec['resident']['split_ms' + tag]:.4f}",
            streaming_ms=f"{rec['streaming_ms' + tag]:.4f}",
            quarter_sites_ms=f"{rec['quarter_sites_ms' + tag]:.4f}",
            quarter_sites_cluster_ms=
            f"{rec['quarter_sites_cluster_ms' + tag]:.4f}",
            plain_ms=f"{rec['plain_ms' + tag]:.4f}",
            library_ms=f"{rec['library_ms' + tag]:.4f}",
            below_half_of_bound=[
                f"{s[0]}x{s[1]}x{s[2]}:{a}" for (d, s, a), r in per.items()
                if d == dtype and r["bound_ms"] / r["ms"] < 0.5])
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
    plans = [_padded_vs_real(eng, frames[:n], masks[:n], card)
             for eng in (engines["bf16"], engines["32"], _engine("32_fast"))
             for n in (len(frames), 1)]
    return {"instance_norm_act": n_in, "instance_norm_act_streaming": n_st,
            "blend_tiles": n_bl, "plans": plans,
            "fp32_rows": _fp32_row_policies(engines["32"], card)}


def _hand_pack(eng, group_boxes, h: int, w: int, rows: int):
    """A group's tiles packed into ``rows`` rows by hand, padding rows of
    zero weight: ``bucket_size`` rows is JAX's padded plan (its XLA
    bucket), the tile count the real tiles alone."""
    fboxes, weights, _ = pack_boxes_multi(list(group_boxes), eng.patch_size,
                                          rows)
    return (make_tile_plan(fboxes, h, w, eng.patch_size, eng.device),
            torch.from_numpy(weights).to(eng.device))


PLAN_SLOWER = 1.05  # the engine's plan against the padded one: call spread


def _padded_vs_real(eng, frames, masks, card: str, rounds: int = 1,
                    reps: int = 3) -> dict:
    """One group through JAX's padded plan (``bucket_size`` rows) and
    through a plan of the real tiles alone, each built once by hand: the
    generator's rows each way (a forward pre-hook); the tiled call's
    device ms each way (``dispatch`` on frames already on the card, queued
    behind a spin so the host's dispatch is not timed: ``queued_ms``,
    ``reps`` calls, else one; where not even one call can be queued ahead,
    the calls' elapsed ms, which the device's time then dominates:
    ``timing``), turns A B B A after a warm-up of each (which also sets up
    cuDNN at each batch size); one call's elapsed ms as it runs, host
    included, each way; the outputs, within 1 count. The engine's own plan
    must have ``pack_rows`` rows (the bucket at precision 32, the real
    tiles at bf16 and ``32_fast``), agree within 1 count, and be no slower than the padded plan by
    more than the call spread (``PLAN_SLOWER``). At precision 32 a lone
    frame's call is also traced both ways (device operations, the kernels
    of most device time)."""
    group_boxes = [eng.boxes_for(m, (H, W)) for m in masks]
    frames_d = torch.from_numpy(np.ascontiguousarray(frames)).to(eng.device)
    masks_d = torch.from_numpy(np.stack(
        [eng._mask_tensor(m, (H, W)) for m in masks])).to(eng.device)
    n = sum(len(b) for b in group_boxes)
    hand = {"real": _hand_pack(eng, group_boxes, H, W, n),
            "padded": _hand_pack(eng, group_boxes, H, W, bucket_size(n))}
    own = "padded" if eng.pack_rows(n) == bucket_size(n) else "real"
    rows = []
    hook = eng.model.register_forward_pre_hook(
        lambda _m, args: rows.append(int(args[0].shape[0])))

    def call(which: str):
        if which in hand:
            eng._pack = lambda *_: hand[which]
        try:
            return eng.dispatch(frames_d, masks_d, group_boxes)
        finally:
            eng.__dict__.pop("_pack", None)

    def elapsed(which: str) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call(which)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def device_ms(which: str) -> float:
        # fewer calls queued where the device's launch queue fills first;
        # once neither can be, the rest are timed elapsed
        for k in (reps, 1) if "elapsed" not in timing else ():
            try:
                return queued_ms([lambda: call(which)], k)
            except AssertionError:
                timing.add(f"not {k} queued")
        timing.add("elapsed")
        return sum(elapsed(which) for _ in range(reps)) / reps

    timing = set()
    traces = {}
    try:
        outs = {w: call(w) for w in ("real", "padded", "engine")}
        torch.cuda.synchronize()
        warm_rows = list(rows)
        ms = {"real": [], "padded": []}
        wall = {"real": [], "padded": []}
        for _ in range(rounds):
            for which in ("real", "padded", "padded", "real"):
                ms[which].append(device_ms(which))
                wall[which].append(elapsed(which))
        if str(eng.precision) == "32" and len(frames) == 1:
            traces = {w: _traced(lambda: call(w)) for w in ("real", "padded")}
    finally:
        hook.remove()
    d = int((outs["real"].int() - outs["padded"].int()).abs().max())
    d_own = int((outs["engine"].int() - outs["padded"].int()).abs().max())
    mean = {w: sum(v) / len(v) for w, v in ms.items()}
    rec = {"precision": str(eng.precision), "frames": len(frames),
           "tiles": n,
           "rows_real": warm_rows[0], "rows_padded": warm_rows[1],
           "rows_engine": warm_rows[2], "engine_plan": own,
           "max_abs": d, "max_abs_engine": d_own,
           "ms_real": mean["real"], "ms_padded": mean["padded"],
           "ms_real_runs": ms["real"], "ms_padded_runs": ms["padded"],
           "call_ms_real": sum(wall["real"]) / len(wall["real"]),
           "call_ms_padded": sum(wall["padded"]) / len(wall["padded"]),
           "timing": ", ".join(sorted(timing)) or "queued"}
    say("main_path", plans=f"{len(frames)} frame(s)",
        precision=rec["precision"], tiles=n, rows_real=rec["rows_real"],
        rows_padded=rec["rows_padded"], rows_engine=rec["rows_engine"],
        engine_plan=own, max_abs=d, max_abs_engine=d_own,
        device_ms_real=f"{rec['ms_real']:.4f}",
        device_ms_padded=f"{rec['ms_padded']:.4f}",
        ratio=f"{rec['ms_real'] / rec['ms_padded']:.4f}",
        rows_ratio=f"{n / rec['rows_padded']:.4f}",
        runs_real="/".join(f"{t:.3f}" for t in ms["real"]),
        runs_padded="/".join(f"{t:.3f}" for t in ms["padded"]),
        call_ms_real=f"{rec['call_ms_real']:.3f}",
        call_ms_padded=f"{rec['call_ms_padded']:.3f}",
        timing=rec["timing"], card=f"'{card}'")
    for which, t in traces.items():
        rec[f"trace_{which}"] = {"device_ms": t["device_ms"],
                                 "device_ops": t["device_ops"],
                                 "top": t["top"][:3]}
        say("main_path", trace=which, precision=rec["precision"], tiles=n,
            wall_ms=f"{t['wall_ms']:.2f}", device_ms=f"{t['device_ms']:.2f}",
            device_ops=t["device_ops"], top="; ".join(
                f"{ms_:.2f} ms {name[:60]}" for name, ms_ in t["top"][:3]))
    if warm_rows != [n, bucket_size(n), eng.pack_rows(n)] or d > 1 \
            or d_own > 1:
        raise AssertionError(f"padded vs real plan: rows {warm_rows} (want "
                             f"{[n, bucket_size(n), eng.pack_rows(n)]}), "
                             f"{d} / {d_own} counts apart (limit 1)")
    if mean[own] > PLAN_SLOWER * mean["padded"]:
        raise AssertionError(
            f"{rec['precision']}, {len(frames)} frame(s): the engine's plan "
            f"({own}) took {mean[own]:.3f} ms against the padded plan's "
            f"{mean['padded']:.3f} (limit x{PLAN_SLOWER})")
    return rec


FP32_ROWS = (100, 170, 360, 510)  # tiles: masked frames, 1, 2 and 3 frames


def _pow2_chunks(n: int) -> list:
    """``n`` as a sum of powers of two, largest first."""
    return [1 << b for b in range(n.bit_length() - 1, -1, -1) if n >> b & 1]


def _fp32_row_policies(eng, card: str, reps: int = 1) -> dict:
    """The precision-32 generator alone on ``n`` tiles (uniform in [-1, 1]
    from a numpy seed, channels-last fp32 on the card), for each ``n`` of
    ``FP32_ROWS``, three row policies: one batch of the ``n`` tiles, one
    of ``bucket_size(n)`` rows (the engine's), and sub-batches of
    power-of-two sizes summing to ``n``; elapsed ms by CUDA events (the
    device dominates at fp32), turns A B C C B A after a warm-up of each;
    each policy's tiles within 1e-4 of the one batch's."""
    rng = np.random.default_rng(5)
    out = {}
    for n in FP32_ROWS:
        x = torch.from_numpy(rng.uniform(
            -1, 1, (bucket_size(n), PS, PS, eng.total_channels)).astype(
                np.float32)).to(eng.device)
        chunks = _pow2_chunks(n)
        starts = np.cumsum([0] + chunks[:-1])

        def one():
            return eng.model(x[:n])

        def bucket():
            return eng.model(x)[:n]

        def pow2():
            return torch.cat([eng.model(x[a:a + c])
                              for a, c in zip(starts, chunks)])

        fns = {"one": one, "bucket": bucket, "pow2": pow2}
        with torch.no_grad():
            ref = {k: f() for k, f in fns.items()}
            ms = {k: [] for k in fns}
            for _ in range(reps):
                for k in ("one", "bucket", "pow2", "pow2", "bucket", "one"):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fns[k]()
                    end.record()
                    end.synchronize()
                    ms[k].append(start.elapsed_time(end))
        diff = max(float((ref[k] - ref["one"]).abs().max())
                   for k in ("bucket", "pow2"))
        rec = {k: sum(v) / len(v) for k, v in ms.items()}
        rec.update(bucket_rows=bucket_size(n), chunks=chunks, max_abs=diff)
        out[str(n)] = rec
        say("main_path", fp32_rows=n, ms_one=f"{rec['one']:.2f}",
            ms_bucket=f"{rec['bucket']:.2f}", bucket_rows=bucket_size(n),
            ms_pow2=f"{rec['pow2']:.2f}",
            chunks="+".join(map(str, chunks)), max_abs=f"{diff:.3g}",
            card=f"'{card}'")
        if diff > 1e-4:
            raise AssertionError(f"fp32 rows {n}: the policies' tiles "
                                 f"{diff:.3g} apart (limit 1e-4)")
    return out


def _dir_engine(precision: str, scene: Path, out: Path, mode: str = "tiled",
                device=None, ckpt: Path = CKPT, **inference):
    return StyleTransferInference(inference_config(
        paths={"checkpoint": str(ckpt), "input_dir": str(scene / "input"),
               "mask_dir": str(scene / "mask"), "output_dir": str(out),
               "additional_channels": {"point_vector": {
                   "path": str(scene / "tracking"), "depth": 3}}},
        inference={"precision": precision, "mode": mode, **inference}),
        device=device)


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
def _without_modules(names):
    """``names`` and their submodules made unimportable, those already
    imported put back afterwards."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] in names}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n in names:
            del sys.modules[n]
        sys.modules.update(saved)


@contextlib.contextmanager
def _without_pil():
    """PIL made unimportable: the card's serving path needs none."""
    with _without_modules(("PIL",)):
        yield


B1_WRAPPERS = {"cluster": instance_norm.instance_norm_act_cluster,
               "resident": instance_norm.instance_norm_act_resident,
               "split": instance_norm.instance_norm_act_split,
               "sample": instance_norm.instance_norm_act_sample,
               "streaming": instance_norm.instance_norm_act_streaming}


# the launch counts a serving phase sums over its runs, for the kernels line
LAUNCH_KINDS = ("cluster", "resident", "split", "blend")


def _zero_counts() -> None:
    for fn in (*B1_WRAPPERS.values(), blend.blend_tiles):
        fn.launches = 0


def _read_counts() -> dict:
    out = {k: fn.launches for k, fn in B1_WRAPPERS.items()}
    out["blend"] = blend.blend_tiles.launches
    return out


def _ff_launches(prec: str, h: int = H, w: int = W) -> dict:
    """B1 launches of one full-frame pass at precision ``prec`` over an
    h x w frame (zero-padded to multiples of 4), by variant, as ``plan``
    gives the 19 sites: the resident variant where a site's plane fits the
    SMs' shared memory, the split variant where it does not."""
    dtype = _resolve_dtype(prec)
    out = {"resident": 0, "split": 0}
    for (sh, sw, c), _ in _ff_sites(-(-h // 4) * 4, -(-w // 4) * 4):
        out[instance_norm.plan(1, sh, sw, c, dtype, True).variant] += 1
    return out


def _want_counts(frames: int, tiled: bool, prec: str,
                 hw: tuple = (H, W)) -> dict:
    """19 B1 launches a generator call, in the cluster variant and with one
    B2 launch a call when tiled (one call a frame in these phases), in the
    resident and split variants as ``_ff_launches`` gives them and no B2
    launch in full-frame mode; never sample or streaming."""
    ff = dict.fromkeys(("resident", "split"), 0) if tiled \
        else _ff_launches(prec, *hw)
    return {"cluster": 19 * frames if tiled else 0,
            **{k: n * frames for k, n in ff.items()}, "sample": 0,
            "streaming": 0, "blend": frames if tiled else 0}


def _check_counts(what: str, got: dict, frames: int, tiled: bool,
                  prec: str, hw: tuple = (H, W)) -> None:
    """The launches ``_want_counts`` gives, or raise."""
    want = _want_counts(frames, tiled, prec, hw)
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def phase_fullframe(dev, card: str, tmp: Path, tiled: dict) -> dict:
    """``process_directory`` in full-frame mode over the serve_directory
    phase's 36 frames of 512x910 (one generator pass a frame, 512x912 after
    padding), PIL unimportable, precision bf16 and 32: a set-up run, then a
    timed run with the counters zeroed just before and read just after (19
    B1 launches a frame, resident and split as ``_ff_launches`` gives them,
    none of the other variants, no B2), beside the
    tiled run on the same frames (``tiled``: the serve_directory records).
    Its files against ``stylize_group`` frame by frame on 3 frames (limit 1
    count). Then at precision 32 the card against the CPU engine on a
    256x456 crop of a frame with a partial mask (limit 1 count)."""
    scene = tmp / "scene"
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    rec, launches = {}, {"resident": 0, "split": 0}
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
            _check_counts(f"fullframe {prec}", counts, DIR_FRAMES, False,
                          prec)
            for k in launches:
                launches[k] += counts[k]
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
                resident_launches=counts["resident"],
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
    return {"rec": rec, "launches": launches}


TEMPORAL_FRAMES, TEMPORAL_MISSING = 12, 5  # chain length, missing flow


def _temporal_scene(scene: Path, root: Path, n: int, crop=None,
                    start: int = 0) -> Path:
    """``n`` frames of ``scene`` from its frame ``start`` (cropped to
    ``crop``, (y0, y1, x0, x1), when given) with a 3-band guide and masks,
    and seeded smooth backward flows ``flow_bwd/%03d.npy`` numbered from
    0, the one of frame ``TEMPORAL_MISSING`` left out."""
    rng = np.random.default_rng(6 + start)
    for sub in ("input", "tracking", "mask", "flow_bwd"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(sorted(p.name for p in (
            scene / "input").glob("*.png"))[start:start + n]):
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
                     device=None, mask: str = "mask", knobs=None,
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
                                "flow_upload": "auto", **temporal},
                   **(knobs or {})})
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
    rec, launches = {}, dict.fromkeys(LAUNCH_KINDS, 0)
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
                              TEMPORAL_FRAMES, mode == "tiled", prec)
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
    kernels' and copies' times), device operations, the host's launch
    calls (kernels, graphs, asynchronous copies and sets), the eight
    device operations of most device time and the eight ``aten::`` calls
    whose kernels took most of it (name, ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device_us = ops = calls = 0
    per, aten = [], []
    for ev in prof.key_averages():
        if ev.key.startswith("aten::"):
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
            if us > 0:
                aten.append((ev.key, us / 1e3))
        if ev.key in LAUNCH_CALLS:
            calls += ev.count
        elif ev.device_type == torch.autograd.DeviceType.CUDA \
                and not ev.key.startswith("host/"):
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                device_us += us
                ops += ev.count
                per.append((ev.key, us / 1e3))
    return {"wall_ms": wall, "device_ms": device_us / 1e3,
            "device_ops": ops, "launch_calls": calls,
            "top": sorted(per, key=lambda kv: -kv[1])[:8],
            "top_aten": sorted(aten, key=lambda kv: -kv[1])[:8]}


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
    launches = dict.fromkeys(LAUNCH_KINDS, 0)
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
                          mode == "tiled", prec)
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


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |d|, max |d| / (2e-5 + 2e-5 |want|)) of two outputs."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / (2e-5 + 2e-5 * want.float().abs()))
                                 .max())


def _conv_errors(model, x, n: int = 4) -> dict:
    """Every conv of ``model`` (precision ``32_fast``) on the card, at the
    inputs a forward over ``x`` gives it, over ``n`` samples, the largest
    |d| over the largest |y|: the split against the conv in fp64 on the
    CPU; beside it the strict fp32 conv and one TF32 pass against the same,
    and the split's hi*hi pass alone against hi*hi in fp64 (the tensor
    cores' own accumulation error: their inputs are exact there). -> the
    worst of each, the conv where the split's is worst, and the convs
    where the split is beyond 2e-6 and further than one TF32 pass or more
    than 2e-6 beyond 1.5 times its hi*hi pass's error (a conv that cuDNN
    runs outside the tensor cores, such as the 1x1 head to 3 channels, is
    fp32 in every pass: within 2e-6 either way). The split removes the
    rounding of the inputs to TF32, not the tensor cores' accumulation:
    where that dominates (the 7x7 conv over 166 channels, K = 8,134) the
    split is about twice as close as one pass, elsewhere up to 50 times."""
    from patch_toon_tpu_torch.models.layers import Conv2d, _split, _tf32_convs

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((mod, inp[0][:n], out[:n])))
        for m in model.modules() if isinstance(m, Conv2d)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    worst = {k: 0.0 for k in ("split", "strict", "one_pass", "hihi")}
    worst.update(convs=len(seen), at=None, beyond=[])

    def rel(got, want):
        return float((got.cpu().double() - want).abs().max()) \
            / float(want.abs().max())

    def d64(t):
        return None if t is None else t.cpu().double()

    for i, (mod, xi, yi) in enumerate(seen):
        w = mod.weight.detach()
        b = None if mod.bias is None else mod.bias.detach()

        def conv(a, k, c, mod=mod):
            return F.conv2d(a, k, c, mod.stride, mod.padding)

        (xh, _), (wh, _) = _split(xi), _split(w)
        with torch.no_grad():
            strict = conv(xi, w, b)
            with _tf32_convs():
                one, hihi = conv(xi, w, b), conv(xh, wh, b)
        y64 = conv(d64(xi), d64(w), d64(b))
        e = {"split": rel(yi, y64), "strict": rel(strict, y64),
             "one_pass": rel(one, y64),
             "hihi": rel(hihi, conv(d64(xh), d64(wh), d64(b)))}
        if e["split"] > worst["split"]:
            worst["at"] = f"{i}:{tuple(w.shape)}"
        for k, v in e.items():
            worst[k] = max(worst[k], v)
        if e["split"] > 2e-6 and (e["split"] > e["one_pass"]
                                  or e["split"] > 1.5 * e["hihi"] + 2e-6):
            worst["beyond"].append((i, tuple(w.shape), {
                k: f"{v:.3g}" for k, v in e.items()}))
    return worst


def _against_fp64(model, x, y32, yfast, n: int = 16) -> dict:
    """Precision 32 and ``32_fast`` against fp64 on the CPU (the network
    in fp64: the card's kernels take fp32 and bf16 only), over the ``n``
    samples where the two differ most (each sample is its own: the
    InstanceNorm statistics are a sample's, the BatchNorm's fixed).
    -> the samples' count and each precision's largest |d| from fp64."""
    import copy

    worst = (yfast - y32).abs().flatten(1).amax(1)
    idx = worst.argsort(descending=True)[:n].cpu()
    ref = copy.deepcopy(model).cpu().double().eval()
    with torch.no_grad():
        y64 = ref(x[idx].cpu().double())
    return {"fp64_samples": len(idx),
            "max_abs_32": float((y32[idx].cpu().double() - y64).abs().max()),
            "max_abs_32_fast": float((yfast[idx].cpu().double() - y64)
                                     .abs().max())}


def phase_precision_32_fast(dev, card: str, tmp: Path) -> dict:
    """Precision ``32_fast`` in serving: (a) the 19-site generator call at
    B = 512 tiles and one full-frame pass over a 512x912 frame, at 32,
    ``32_fast`` and bf16, timed by CUDA events, ``32_fast``'s largest |d|
    from 32 printed (JAX's test holds 2e-5 absolute and relative on a
    randomly initialized generator; where the two part by more, both are
    printed against fp64 over the samples that part most), and every conv
    of the ``32_fast`` generator at the inputs the call gives it held
    against fp64 (``_conv_errors``): within 2e-6, or closer than one TF32
    pass and within 2e-6 of 1.5 times the error of its own hi*hi pass,
    whose inputs are exact in TF32, so that what is left is the tensor
    cores' accumulation (the split's products are exact to 2^-21: hi has
    TF32's 10 mantissa bits, lo loses its last bits, lo*lo is dropped);
    (b) ``process_directory`` over the
    serve_directory phase's 36 frames, tiled and full-frame, at
    ``32_fast``, timed, with the launch counters zeroed just before and
    read just after, each file within 1 count of the precision-32 run's
    (the differing pixels printed); (c) a precision-32 engine built after
    them finds TF32 off in cuDNN and matmuls."""
    rec, launches = {}, dict.fromkeys(LAUNCH_KINDS, 0)
    engines = {p: _engine(p) for p in ("32", "32_fast", "bf16")}
    g = torch.Generator(device=dev).manual_seed(4)
    inputs = {"tiles": torch.rand((B, PS, PS, 6), device=dev, generator=g)
              * 2 - 1,
              "frame": torch.rand((1, HP, WP, 6), device=dev, generator=g)
              * 2 - 1}
    outs = {}
    for prec, eng in engines.items():
        for tag, x in inputs.items():
            xin = x.to(eng.dtype)

            def run(model=eng.model, xin=xin):
                with torch.no_grad():
                    return model(xin)

            outs[prec, tag] = run()
            rec[f"{tag}_ms_{prec}"] = time_ms(run, 3)
    for tag in inputs:
        d, share = _max_rel(outs["32_fast", tag], outs["32", tag])
        db, _ = _max_rel(outs["bf16", tag], outs["32", tag])
        rec[f"{tag}_max_abs_32_fast_vs_32"] = d
        extra = {}
        if share > 1.0:  # beyond JAX's network bar: which of the two?
            extra = _against_fp64(engines["32"].model, inputs[tag],
                                  outs["32", tag], outs["32_fast", tag])
            rec[f"{tag}_against_fp64"] = extra
        convs = _conv_errors(engines["32_fast"].model,
                             inputs[tag].to(torch.float32))
        rec[f"{tag}_conv_errors"] = convs
        extra.update(conv_split_worst_rel=convs["split"],
                     conv_strict_worst_rel=convs["strict"],
                     conv_one_tf32_pass_worst_rel=convs["one_pass"],
                     conv_hihi_pass_worst_rel=convs["hihi"],
                     conv_split_worst_at=convs["at"], convs=convs["convs"],
                     convs_beyond_bar=len(convs["beyond"]))
        say("precision_32_fast", call=f"generator, {tag}",
            shape="x".join(map(str, inputs[tag].shape)),
            **{f"ms_{p}": f"{rec[f'{tag}_ms_{p}']:.3f}" for p in engines},
            max_abs_32_fast_vs_32=f"{d:.3g}",
            share_of_2e5_bar=f"{share:.3f}",
            max_abs_bf16_vs_32=f"{db:.3g}",
            **{k: f"{v:.3g}" if isinstance(v, float) else v
               for k, v in extra.items()}, card=f"'{card}'")
        if convs["beyond"]:
            raise AssertionError(f"32_fast {tag}: convs beyond 2e-6 and "
                                 "further from fp64 than one TF32 pass, or "
                                 "beyond their hi*hi pass's own error: "
                                 f"{convs}")
    del engines, outs
    scene = tmp / "scene"
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    with _without_pil():
        for mode, ref in (("tiled", "dir_32"), ("fullframe", "ff_32")):
            out = tmp / f"fast_{mode}"
            eng = _dir_engine("32_fast", scene, out, mode=mode)
            eng.process_directory()  # set-up
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = eng.process_directory()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _read_counts()
            calls = DIR_FRAMES if mode == "fullframe" else -(-DIR_FRAMES // (
                eng._group_size(len(eng.boxes_for(_full_mask(), (H, W))))))
            if written != DIR_FRAMES:
                raise AssertionError(f"32_fast {mode}: {written} frames")
            _check_counts(f"32_fast {mode}", counts, calls, mode == "tiled",
                          "32_fast")
            for k in launches:
                launches[k] += counts[k]
            worst, differ = _compare_dirs(out, tmp / ref, names)
            ms = 1e3 * seconds / calls
            rec[f"directory_{mode}"] = {
                "ms_per_call": ms, "eq_frames_per_s": DIR_FRAMES / seconds,
                "vs_32_max_abs": worst, "vs_32_differing_pixels": differ}
            say("precision_32_fast", entry="process_directory", mode=mode,
                frames=written, **{("ms_per_group" if mode == "tiled" else
                                    "ms_per_frame"): f"{ms:.2f}"},
                eq_frames_per_s=f"{DIR_FRAMES / seconds:.2f}",
                **{f"{k}_launches": v for k, v in counts.items()},
                vs_precision_32_max_abs=worst,
                vs_precision_32_differing_pixels=differ, card=f"'{card}'")
            if worst > 1:
                raise AssertionError(f"32_fast {mode}: {worst} counts from "
                                     "precision 32 (limit 1)")
            del eng
    _engine("32")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    say("precision_32_fast", strict_engine_after="precision 32",
        cudnn_allow_tf32=flags[0], matmul_allow_tf32=flags[1],
        float32_matmul_precision=flags[2])
    if flags != (False, False, "highest"):
        raise AssertionError(f"the strict flags after 32_fast: {flags}")
    return {"rec": rec, "launches": launches}


SINGLE_H, SINGLE_W = 540, 960


def phase_single_image(dev, card: str, tmp: Path) -> dict:
    """The single-image calls on one 540x960 frame (RGB and a 3-band guide
    from numpy seed 3) with an elliptical mask, tiled and full-frame, at
    bf16 and 32, PIL unimportable: ``process_image`` (files in, a PNG out)
    timed with the counters zeroed just before and read just after (19 B1
    launches, cluster with one B2 launch when tiled, split when full-frame),
    its file bitwise equal to ``stylize_group`` on the same frame; then
    ``process_large_image`` with a fractional mask (a band of 0.5),
    timed, and at precision 32 within 1 count of the CPU engine."""
    root = tmp / "single"
    for sub in ("input", "tracking", "mask", "out"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (SINGLE_H // 10, SINGLE_W // 10, 6),
                        dtype=np.uint8)
    u8 = np.repeat(np.repeat(base, 10, axis=0), 10, axis=1)
    yy, xx = np.mgrid[0:SINGLE_H, 0:SINGLE_W].astype(np.float32)
    ell = ((yy - 0.5 * SINGLE_H) / (0.43 * SINGLE_H)) ** 2 \
        + ((xx - 0.49 * SINGLE_W) / (0.4 * SINGLE_W)) ** 2
    encode_png(root / "input" / "0000.png", u8[..., :3], compress_level=1)
    encode_png(root / "tracking" / "0000.png", u8[..., 3:], compress_level=1)
    encode_png(root / "mask" / "0000.png",
               np.where(ell < 1.0, 255, 0).astype(np.uint8), compress_level=1)
    inp, mask_path = root / "input" / "0000.png", root / "mask" / "0000.png"
    rec = {}
    launches = dict.fromkeys(LAUNCH_KINDS, 0)
    with _without_pil():
        for mode in ("tiled", "fullframe"):
            for prec in ("bf16", "32"):
                tag = f"{mode}_{prec}"
                cfg = dict(paths={"checkpoint": str(CKPT),
                                  "additional_channels": {"point_vector": {
                                      "path": str(root / "tracking"),
                                      "depth": 3}}},
                           inference={"precision": prec, "mode": mode})
                eng = StyleTransferInference(inference_config(**cfg))
                out = root / "out" / f"{tag}.png"
                eng.process_image(inp, mask_path, out)  # set-up
                _zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.process_image(inp, mask_path, out)
                ms = 1e3 * (time.perf_counter() - t0)
                counts = _read_counts()
                _check_counts(f"single_image {tag}", counts, 1,
                              mode == "tiled", prec, (SINGLE_H, SINGLE_W))
                for k in launches:
                    launches[k] += counts[k]
                frame = eng.load_frame(inp)
                eroded = eng.load_eroded_mask(mask_path, frame.shape[:2])
                got = decode_png(out)
                want = eng.stylize_group(frame[None], [eroded])[0]
                bitwise = bool(np.array_equal(got, want))
                frac = eroded.copy()
                frac[(ell > 0.5) & (ell < 0.8)] *= 0.5
                unit = SIGNED_UNIT[frame]
                eng.process_large_image(unit, frac)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frac_out = eng.process_large_image(unit, frac)
                frac_ms = 1e3 * (time.perf_counter() - t0)
                extra = {}
                if prec == "32":
                    cpu = StyleTransferInference(inference_config(**cfg),
                                                 device="cpu")
                    cpu_out = cpu.process_large_image(unit, frac)
                    d = np.abs(frac_out.astype(int) - cpu_out)
                    extra = {"fractional_card_vs_cpu_max_abs": int(d.max()),
                             "fractional_card_vs_cpu_differing_pixels":
                             int((d.max(axis=-1) > 0).sum())}
                    if d.max() > 1:
                        raise AssertionError(f"single_image {tag}: the "
                                             "fractional mask card vs CPU "
                                             f"{d.max()} counts (limit 1)")
                rec[tag] = {"process_image_ms": ms,
                            "process_large_image_ms": frac_ms,
                            "tiles": len(eng.boxes_for(eroded, (
                                SINGLE_H, SINGLE_W))) if mode == "tiled"
                            else 0, **extra}
                say("single_image", mode=mode, precision=prec,
                    frame=f"{SINGLE_H}x{SINGLE_W}", tiles=rec[tag]["tiles"],
                    process_image_ms=f"{ms:.2f}",
                    process_large_image_fractional_ms=f"{frac_ms:.2f}",
                    **{f"{k}_launches": v for k, v in counts.items()},
                    vs_stylize_group_bitwise=bitwise,
                    fractional_changed_pixels=int(
                        (frac_out != got).any(axis=-1).sum()),
                    **extra, card=f"'{card}'")
                if not bitwise or got.std() < 1.0:
                    raise AssertionError(f"single_image {tag}: process_image "
                                         "differs from stylize_group")
                del eng
    return {"rec": rec, "launches": launches}


# the watch phase's service: generator_torch.py as __main__ with PyYAML
# unimportable (the card's machine has none), its B1 and B2 launch counts
# printed on its way out
WATCH_SERVICE = r"""
import json, runpy, sys
sys.modules["yaml"] = None
sys.argv = ["generator_torch.py"] + sys.argv[1:]
try:
    runpy.run_path("generator_torch.py", run_name="__main__")
finally:
    from patch_toon_tpu_torch.ops import blend, instance_norm as b1
    print("LAUNCHES " + json.dumps({
        "cluster": b1.instance_norm_act_cluster.launches,
        "resident": b1.instance_norm_act_resident.launches,
        "split": b1.instance_norm_act_split.launches,
        "streaming": b1.instance_norm_act_streaming.launches,
        "blend": blend.blend_tiles.launches}), flush=True)
"""
WATCH_POLL, WATCH_IDLE, WATCH_BURSTS = 0.1, 3.0, 4  # bursts of 3 frames


def _watch_args(inp: Path, mask: Path, track: Path, out: Path, ckpt: Path,
                precision: str, *extra) -> list:
    return [f"paths.checkpoint={ckpt}", f"paths.input_dir={inp}",
            f"paths.mask_dir={mask}", f"paths.output_dir={out}",
            f"paths.additional_channels.point_vector.path={track}",
            f"inference.precision={precision}", "inference.mode=tiled",
            "inference.watch.enabled=true",
            f"inference.watch.poll_seconds={WATCH_POLL}",
            f"inference.watch.idle_timeout_seconds={WATCH_IDLE}", *extra]


def _feed(src: Path, inp: Path, mask_src, mask: Path, track: Path, names,
          out: Path, bursts: int, wait_s: float = 120.0) -> list:
    """Write ``names`` into the watched directories in ``bursts`` bursts,
    each frame's mask (when ``mask_src`` has one) and guide before the
    frames, the frames of a burst given one mtime so that they settle
    together; each burst waits for the last one's outputs. -> per burst
    (the last input's mtime, the time its last output appeared)."""
    per = -(-len(names) // bursts)
    marks = []
    for b in range(bursts):
        chunk = names[b * per:(b + 1) * per]
        for n in chunk:
            if mask_src is not None and (mask_src / n).exists():
                shutil.copyfile(mask_src / n, mask / n)
            shutil.copyfile(src / "tracking" / n, track / n)
        for n in chunk:
            shutil.copyfile(src / "input" / n, inp / n)
        stamp = time.time()
        for n in chunk:
            os.utime(inp / n, (stamp, stamp))
        deadline = time.time() + wait_s
        while not all((out / n).exists() for n in chunk):
            if time.time() > deadline:
                raise AssertionError(f"watch: burst {b} not served in "
                                     f"{wait_s} s")
            time.sleep(0.02)
        marks.append((stamp, time.time()))
    return marks


def _service(args, log: Path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-c", WATCH_SERVICE, *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=open(log, "w"), text=True)


def _service_ready(proc, log: Path, timeout: float = 300.0) -> None:
    """Wait for the service to log that it is watching."""
    deadline = time.time() + timeout
    while "Watching" not in log.read_text():
        if time.time() > deadline or proc.poll() is not None:
            raise AssertionError(f"the watch service did not start: "
                                 f"{log.read_text()[-2000:]}")
        time.sleep(0.05)


def _service_end(proc, what: str, timeout: float = 300.0) -> dict:
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"watch {what}: the service exited "
                             f"{proc.returncode}")
    line = [ln for ln in out.splitlines() if ln.startswith("LAUNCHES ")]
    return json.loads(line[-1][len("LAUNCHES "):])


def phase_watch(dev, card: str, tmp: Path) -> dict:
    """Watch mode through ``python generator_torch.py ...
    inference.watch.enabled=true`` run as a service process on the card
    with PyYAML unimportable, poll 0.1 s, idle timeout 3 s, its launch
    counts printed by the process itself: (1) 12 frames of the
    serve_directory scene written in 4 bursts of 3 (mask and guide first),
    the outputs bitwise equal to ``process_directory``'s for the same 12
    frames; the latency from a burst's last settled input to its last
    output, of which the settle rule holds 0.25 s and the poll up to 0.1 s;
    (2) the same with the temporal chain at ``flow_source: device`` over
    the temporal_device scene, bitwise equal to its one-shot chain; (3)
    SIGTERM once the first outputs of 12 frames at precision 32 are on
    disk: exit 0, every output a whole PNG equal to the one-shot run's."""
    scene = tmp / "scene"
    names = sorted(p.name for p in (scene / "input").glob("*.png"))[:12]
    rec, launches = {}, dict.fromkeys(LAUNCH_KINDS, 0)
    # (1) flat
    root = tmp / "watch_flat"
    dirs = [root / d for d in ("input", "mask", "tracking", "out")]
    for d in dirs:
        d.mkdir(parents=True)
    proc = _service(_watch_args(*dirs, CKPT, "bf16"), root / "log")
    _service_ready(proc, root / "log")
    marks = _feed(scene, dirs[0], scene / "mask", dirs[1], dirs[2], names,
                  dirs[3], WATCH_BURSTS)
    counts = _service_end(proc, "flat")
    for k in launches:
        launches[k] += counts[k]
    _dir_engine("bf16", root, root / "once").process_directory()
    worst, differ = _compare_dirs(dirs[3], root / "once", names)
    lat = [b - a for a, b in marks]
    settle = max(0.25, WATCH_POLL / 2)
    rec["flat"] = {"latency_s": lat, "settle_s": settle,
                   "poll_s": WATCH_POLL, "differing_pixels": differ}
    say("watch", run="flat, 4 bursts of 3, bf16", frames=len(names),
        **{f"{k}_launches": v for k, v in counts.items()},
        vs_process_directory_differing_pixels=differ,
        burst_latency_s="/".join(f"{x:.3f}" for x in lat),
        of_which_settle_s=settle, of_which_poll_up_to_s=WATCH_POLL,
        card=f"'{card}'")
    if differ or counts["cluster"] != 19 * WATCH_BURSTS \
            or counts["blend"] != WATCH_BURSTS:
        raise AssertionError(f"watch flat: {differ} pixels differ from "
                             f"process_directory, launches {counts}")
    # (2) the temporal chain with the device flow
    dscene = tmp / "dscene"
    root = tmp / "watch_chain"
    dirs = [root / d for d in ("input", "mask_ignore", "tracking", "out")]
    for d in dirs:
        d.mkdir(parents=True)
    ckpt = _temporal_ckpt(tmp)
    dnames = sorted(p.name for p in (dscene / "input").glob("*.png"))
    proc = _service(_watch_args(
        *dirs, ckpt, "bf16", "inference.temporal.enabled=true", "inference.temporal.depth=3",
        "inference.temporal.flow_source=device",
        f"inference.temporal.file_format='{FLOW_FMT}'"), root / "log")
    _service_ready(proc, root / "log")
    marks = _feed(dscene, dirs[0], dscene / "mask_ignore", dirs[1], dirs[2],
                  dnames, dirs[3], WATCH_BURSTS)
    counts = _service_end(proc, "chain")
    for k in launches:
        launches[k] += counts[k]
    worst, differ = _compare_dirs(dirs[3], tmp / "td_tiled_bf16_s1", dnames)
    lat = [b - a for a, b in marks]
    rec["chain"] = {"latency_s": lat, "differing_pixels": differ}
    say("watch", run="temporal chain, device flow, 4 bursts of 3, bf16",
        frames=len(dnames), **{f"{k}_launches": v for k, v in counts.items()},
        vs_one_shot_chain_differing_pixels=differ,
        burst_latency_s="/".join(f"{x:.3f}" for x in lat), card=f"'{card}'")
    if differ or counts["cluster"] != 19 * len(dnames):
        raise AssertionError(f"watch chain: {differ} pixels differ from "
                             f"the one-shot chain, launches {counts}")
    # (3) SIGTERM mid-stream
    root = tmp / "watch_term"
    dirs = [root / d for d in ("input", "mask", "tracking", "out")]
    for d in dirs:
        d.mkdir(parents=True)
    for n in names:
        shutil.copyfile(scene / "mask" / n, dirs[1] / n)
        shutil.copyfile(scene / "tracking" / n, dirs[2] / n)
        shutil.copyfile(scene / "input" / n, dirs[0] / n)
    proc = _service(_watch_args(*dirs, CKPT, "32"), root / "log")
    deadline = time.time() + 300
    while not any(dirs[3].glob("*.png")):
        if time.time() > deadline or proc.poll() is not None:
            raise AssertionError("watch SIGTERM run: no output appeared")
        time.sleep(0.01)
    proc.send_signal(signal.SIGTERM)
    counts = _service_end(proc, "SIGTERM")
    on_disk = sorted(p.name for p in dirs[3].glob("*.png"))
    worst, differ = _compare_dirs(dirs[3], tmp / "dir_32", on_disk)
    interrupted = "Watch interrupted" in (root / "log").read_text()
    rec["sigterm"] = {"on_disk": len(on_disk), "differing_pixels": differ}
    say("watch", run="SIGTERM after the first output, 12 frames, 32",
        exit_code=0, interrupted_in_log=interrupted, on_disk=len(on_disk),
        vs_one_shot_differing_pixels=differ,
        **{f"{k}_launches": v for k, v in counts.items()})
    for k in launches:
        launches[k] += counts[k]
    if differ or not on_disk or not interrupted:
        raise AssertionError(f"watch SIGTERM: {len(on_disk)} on disk, "
                             f"{differ} pixels differ, interrupted "
                             f"{interrupted}")
    return {"rec": rec, "launches": launches}


MS_STREAMS, MS_FRAMES = ("shot_a", "shot_b", "shot_c"), 12


def _ms_scene(base: Path, root: Path, partial: bool = False) -> Path:
    """Three streams of ``MS_FRAMES`` frames each (frames 0-11, 12-23 and
    24-35 of ``base``), each laid out as ``_temporal_scene`` lays one out
    (guide, full masks, seeded flows, frame 5's missing) under
    ``root/<stream>/``; with ``partial``, masks of an ellipse of 255 in a
    ring of 128 instead. -> ``root/ms``, the multi-stream view:
    ``input/``, ``tracking/``, ``mask/`` and ``flow_bwd/``, each holding
    one link a stream."""
    for k, s in enumerate(MS_STREAMS):
        one = _temporal_scene(base, root / s, MS_FRAMES,
                              start=k * MS_FRAMES)
        if partial:
            for i, p in enumerate(sorted((one / "mask").glob("*.png"))):
                yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
                r = ((yy - H * 0.5) / (H * 0.42)) ** 2 \
                    + ((xx - W * (0.45 + 0.01 * i)) / (W * 0.38)) ** 2
                encode_png(p, np.where(r < 0.8, 255, np.where(
                    r < 1.0, 128, 0)).astype(np.uint8), compress_level=1)
    for sub in ("input", "tracking", "mask", "flow_bwd"):
        (root / "ms" / sub).mkdir(parents=True, exist_ok=True)
        for s in MS_STREAMS:
            (root / "ms" / sub / s).symlink_to(root / s / sub)
    return root / "ms"


MS_RUNS = [("device", "bf16", False), ("device", "32", False),
           ("files", "bf16", False), ("files", "32", False),
           ("device", "bf16", True)]


def phase_multistream(dev, card: str, tmp: Path) -> dict:
    """Multi-stream temporal serving through ``process_directory``: three
    streams of 12 frames of 512x910 (a subdirectory each), the temporal
    phase's generator, tiled, for each run of ``MS_RUNS`` (flow source,
    precision, partial masks): a set-up run, a timed run with the counters
    zeroed just before and read just after (19 B1 cluster launches and one
    B2 launch a cycle: three frames, 510 tiles with full masks, in one 512
    bucket), a traced run (device ms a cycle, busy share, launch calls a
    cycle), and each stream against the same stream served alone as a
    single-stream chain (within 1 count; the frames where bitwise
    printed). Then ``_watch_multistream`` over the device-flow bf16
    streams fed in 4 bursts of 3 frames a stream by a thread: its outputs
    bitwise equal to the one-shot multi-stream run's."""
    ckpt = _temporal_ckpt(tmp)
    views = {False: _ms_scene(tmp / "scene", tmp / "ms_full"),
             True: _ms_scene(tmp / "scene", tmp / "ms_part", partial=True)}
    rec, launches = {}, dict.fromkeys(LAUNCH_KINDS, 0)
    with _without_pil():
        for source, prec, partial in MS_RUNS:
            tag = f"{source}_{prec}" + ("_partial" if partial else "")
            view = views[partial]
            out = tmp / f"ms_{tag}"
            extra = dict(flow_source=source)
            if source == "files":
                extra["flow_upload"] = "f32"
            eng = _temporal_engine(prec, view, out, ckpt, "tiled", **extra)
            eng.process_directory()  # set-up
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = eng.process_directory()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _read_counts()
            if written != len(MS_STREAMS) * MS_FRAMES:
                raise AssertionError(f"multistream {tag}: {written}")
            _check_counts(f"multistream {tag}", counts, MS_FRAMES, True,
                          prec)
            for k in launches:
                launches[k] += counts[k]
            tr = _traced(eng.process_directory)
            bitwise, worst = [], 0
            for s in MS_STREAMS:
                solo = tmp / f"ms_{tag}_solo_{s}"
                _temporal_engine(prec, view.parent / s, solo, ckpt, "tiled",
                                 **extra).process_directory()
                snames = sorted(p.name for p in (solo).glob("*.png"))
                w, _ = _compare_dirs(out / s, solo, snames)
                worst = max(worst, w)
                bitwise.append(sum(np.array_equal(
                    decode_png(out / s / n), decode_png(solo / n))
                    for n in snames))
            ms = 1e3 * seconds / MS_FRAMES
            rec[tag] = {"ms_per_cycle": ms,
                        "frames_per_s": written / seconds,
                        "traced_device_ms_per_cycle":
                        tr["device_ms"] / MS_FRAMES,
                        "busy_share": tr["device_ms"] / tr["wall_ms"],
                        "launch_calls_per_cycle":
                        tr["launch_calls"] / MS_FRAMES,
                        "vs_single_stream_max_abs": worst,
                        "bitwise_frames_per_stream": bitwise}
            say("multistream", flow_source=source, precision=prec,
                masks="partial" if partial else "full",
                streams=len(MS_STREAMS), frames=written,
                ms_per_cycle=f"{ms:.2f}",
                frames_per_s=f"{written / seconds:.2f}",
                device_ms_per_cycle=f"{tr['device_ms'] / MS_FRAMES:.2f}",
                busy_share=f"{tr['device_ms'] / tr['wall_ms']:.3f}",
                launch_calls_per_cycle=
                f"{tr['launch_calls'] / MS_FRAMES:.1f}",
                **{f"{k}_launches": v for k, v in counts.items()},
                vs_single_stream_max_abs=worst,
                bitwise_frames_per_stream="/".join(map(str, bitwise)),
                card=f"'{card}'")
            if worst > 1:
                raise AssertionError(f"multistream {tag}: {worst} counts "
                                     "from the single-stream chains")
            del eng
        # watched, fed in bursts
        view = views[False]
        win = tmp / "ms_watch"
        for sub in ("input", "tracking", "mask"):
            for s in MS_STREAMS:
                (win / sub / s).mkdir(parents=True)
        eng = _temporal_engine("bf16", win, tmp / "ms_watch_out", ckpt,
                               "tiled", flow_source="device")
        eng.cfg["inference"]["watch"].update(
            enabled=True, poll_seconds=WATCH_POLL,
            idle_timeout_seconds=WATCH_IDLE)
        errors = []

        def feeder():
            try:
                snames = {s: sorted(p.name for p in (view / "input" / s)
                                    .glob("*.png")) for s in MS_STREAMS}
                for b in range(WATCH_BURSTS):
                    chunk = [(s, n) for s in MS_STREAMS
                             for n in snames[s][b * 3:(b + 1) * 3]]
                    for s, n in chunk:
                        for sub in ("mask", "tracking"):
                            shutil.copyfile(view / sub / s / n,
                                            win / sub / s / n)
                    for s, n in chunk:
                        shutil.copyfile(view / "input" / s / n,
                                        win / "input" / s / n)
                    stamp = time.time()
                    for s, n in chunk:
                        os.utime(win / "input" / s / n, (stamp, stamp))
                    deadline = time.time() + 120
                    while not all((tmp / "ms_watch_out" / s / n).exists()
                                  for s, n in chunk):
                        if time.time() > deadline:
                            raise AssertionError(f"burst {b} not served")
                        time.sleep(0.02)
            except Exception as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)

        # the first burst is there before the watch starts
        thread = threading.Thread(target=feeder)
        thread.start()
        while not all(any((win / "input" / s).iterdir())
                      for s in MS_STREAMS):
            if not thread.is_alive():
                raise errors[0] if errors else AssertionError("no frames")
            time.sleep(0.01)
        _zero_counts()
        eng.watch_directory()
        counts = _read_counts()
        thread.join()
        if errors:
            raise errors[0]
        _check_counts("multistream watch", counts, MS_FRAMES, True, "bf16")
        for k in launches:
            launches[k] += counts[k]
        differ = sum(_compare_dirs(tmp / "ms_watch_out" / s,
                                   tmp / "ms_device_bf16" / s,
                                   sorted(p.name for p in (
                                       view / "input" / s).glob("*.png")))[1]
                     for s in MS_STREAMS)
        say("multistream", run="_watch_multistream, device flow, bf16, "
            "4 bursts of 3 frames a stream",
            **{f"{k}_launches": v for k, v in counts.items()},
            vs_one_shot_differing_pixels=differ, card=f"'{card}'")
        if differ:
            raise AssertionError(f"watched multi-stream: {differ} pixels "
                                 "differ from the one-shot run")
    return {"rec": rec, "launches": launches}


# (name, H, W, Cin, Cout, k, stride, sites) of the 22 w8a8 convolutions of
# one tile call at full width (80x80 tiles, 6 input channels), forward order
INT8_SITES = [("initial_conv", 80, 80, 6, 32, 7, 1, 1),
              ("downsample1", 80, 80, 32, 64, 3, 2, 1),
              ("downsample2", 40, 40, 64, 128, 3, 2, 1),
              ("resnet", 20, 20, 128, 128, 3, 1, 14),
              ("upsample2", 40, 40, 256, 128, 3, 1, 1),
              ("upsample1", 80, 80, 192, 128, 3, 1, 1),
              ("conv11", 80, 80, 166, 64, 7, 1, 1),
              ("smoother", 80, 80, 64, 64, 3, 1, 2)]
# shapes off the tile: Cin 6 and 166, stride 2, odd H and W, Cout 8 and 40
# (N padded to 16 and 64)
INT8_ODD = [(13, 17, 6, 32, 7, 1), (11, 9, 166, 64, 7, 1),
            (15, 21, 32, 64, 3, 2), (9, 7, 64, 128, 3, 2),
            (7, 5, 40, 8, 3, 1), (9, 11, 32, 40, 3, 1)]
INT8_CHECK_TILES = 16
INT8_PSNR_DB = 35.0  # JAX's bar, tests/test_quant.py:152
QUANT_WRAPPERS = {"conv_s8": quant.conv_s8,
                  "quantize_act": quant.quantize_act}


def _quant_counts() -> dict:
    return {k: fn.launches for k, fn in QUANT_WRAPPERS.items()}


def _conv_s8_kernels() -> dict:
    """conv_s8's launches by kernel in one generator call: the plan of each
    of the 22 sites, times its count (a plan does not depend on the
    image's size, so tiles and full frames alike)."""
    n = dict.fromkeys(quant.VARIANTS, 0)
    for _, h, w, cin, cout, k, stride, count in INT8_SITES:
        kp = -(-k * k * quant.padded_channels(cin) // quant.KP_ALIGN) \
            * quant.KP_ALIGN
        p = quant.conv_plan(cout, kp, torch.bfloat16, k, stride)
        n[quant.VARIANTS[p.variant]] += count
    return n


def _int8_inputs(n, h, w, cin, cout, k, dtype, dev, seed):
    """An activation (N, H, W, Cin) in ``dtype``, its dynamic scale, a
    quantized and packed seeded weight, its scales and a bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((n, h, w, cin), device=dev, generator=g) * 1.5
         ).to(dtype)
    weight = torch.randn((cout, cin, k, k), device=dev, generator=g) * 0.05
    s = quant.activation_scale(torch.zeros((), device=dev), x)
    wq, w_s = quant.quantize_weight(weight)
    wp = quant.pack_weight(wq, quant.padded_channels(cin))
    bias = (torch.randn((cout,), device=dev, generator=g) * 0.1).to(dtype)
    return x, s, wp, w_s, bias, weight


def _int8_check(n, shape, dtype, dev, seed) -> None:
    """Both kernels bitwise their plain versions at one shape: the int8
    activation, the int32 accumulator, the output with its bias."""
    h, w, cin, cout, k, stride = shape
    x, s, wp, w_s, bias, _ = _int8_inputs(n, h, w, cin, cout, k, dtype, dev,
                                          seed)
    xq = quant.quantize_act(x, s)
    if not torch.equal(xq, quant.quantize_act_plain(x, s)):
        raise AssertionError(f"quantize_act differs from its plain version "
                             f"at {n}x{shape} {dtype}")
    del x
    pad = k // 2
    acc = quant.conv_s8(xq, wp, s, w_s, None, k, stride, pad, torch.int32)
    want = quant.conv_s8_acc_plain(xq, wp, k, stride, pad)
    if not torch.equal(acc, want):
        bad = int((acc != want).sum())
        raise AssertionError(f"conv_s8's accumulator differs from its plain "
                             f"version in {bad} values at {n}x{shape}")
    y = quant.conv_s8(xq, wp, s, w_s, bias, k, stride, pad, dtype)
    if not torch.equal(y, quant.dequantize_plain(want, s, w_s, bias, dtype)):
        raise AssertionError(f"conv_s8's output differs from its plain "
                             f"version at {n}x{shape} {dtype}")


INT_MM_BYTES = 2e9  # the largest im2col the yardstick builds


def _plan_text(p) -> str:
    return (f"{quant.VARIANTS[p.variant]}/N{p.bn}x{p.n_tiles}/"
            f"{p.stages}st/{'resident' if p.resident else 'streamed'}/"
            f"{p.smem_bytes // 1024}KB")


def _int8_int_mm(xq, wp, s, w_s, k, stride, pad, ho, wo) -> dict:
    """``torch._int_mm`` over an explicit im2col of the site, the int8
    yardstick (the port never calls it): on the first images whose im2col
    stays within ``INT_MM_BYTES``, checked against ``conv_s8``'s
    accumulator there, timed, and scaled to all ``B`` images; the im2col's
    own time is excluded (timed apart on the same slice)."""
    n, cp = xq.shape[0], xq.shape[-1]
    kdim = k * k * cp
    nb = max(1, min(n, int(INT_MM_BYTES // (ho * wo * kdim))))
    xp = F.pad(xq[:nb], (0, 0, pad, pad, pad, pad))
    span_y, span_x = stride * (ho - 1) + 1, stride * (wo - 1) + 1

    def im2col():
        return torch.cat([xp[:, ky:ky + span_y:stride, kx:kx + span_x:stride]
                          for ky in range(k) for kx in range(k)],
                         dim=-1).reshape(nb * ho * wo, kdim)

    cols = im2col()
    wt = wp[:, :kdim].contiguous()
    got = torch._int_mm(cols, wt.t())
    acc = quant.conv_s8(xq[:nb], wp, s, w_s, None, k, stride, pad,
                        torch.int32)
    if not torch.equal(got.view(nb, ho, wo, -1), acc):
        raise AssertionError("torch._int_mm over im2col differs from "
                             "conv_s8's accumulator")
    slice_ms = time_ms(lambda: torch._int_mm(cols, wt.t()), 3)
    rec = dict(int_mm_images=nb, int_mm_slice_ms=slice_ms,
               int_mm_ms=slice_ms * n / nb, im2col_ms=time_ms(im2col, 2),
               im2col_mb=cols.numel() / 1e6)
    del cols, xp, got, acc
    return rec


def _int8_site_times(dev) -> dict:
    """Each distinct site at B = 512 in bf16: conv_s8 and quantize_act as
    device time (``queued_ms``), their plain versions, cuDNN's bf16
    ``F.conv2d`` at the same shape (the yardstick; the port never calls
    it for an int8 site), the bounds; per call, each site times its count
    (22 sites). Beside them the int8 yardstick at each site,
    ``torch._int_mm`` over an explicit im2col (``_int8_int_mm``)."""
    rows, tot = [], dict(conv_ms=0.0, quant_ms=0.0, conv_plain_ms=0.0,
                         quant_plain_ms=0.0, library_ms=0.0,
                         conv_bound_ms=0.0, quant_bound_ms=0.0,
                         conv_ops_ms=0.0, conv_bytes_ms=0.0, ops=0,
                         int_mm_ms=0.0, int_mm_slice_ms=0.0)
    for i, (name, h, w, cin, cout, k, stride, count) in \
            enumerate(INT8_SITES):
        x, s, wp, w_s, bias, weight = _int8_inputs(
            B, h, w, cin, cout, k, torch.bfloat16, dev, 100 + i)
        pad, cp = k // 2, quant.padded_channels(cin)
        ho, wo = quant.out_size(h, k, stride, pad), \
            quant.out_size(w, k, stride, pad)
        xq = quant.quantize_act(x, s)
        q_ms = queued_ms([lambda: quant.quantize_act(x, s)], 10)
        c_ms = queued_ms([lambda: quant.conv_s8(
            xq, wp, s, w_s, bias, k, stride, pad, torch.bfloat16)], 5)
        q_plain = time_ms(lambda: quant.quantize_act_plain(x, s), 2)
        c_plain = time_ms(lambda: quant.conv_s8_plain(
            xq, wp, s, w_s, bias, k, stride, pad, torch.bfloat16), 1)
        x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        w_cl = weight.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        lib = time_ms(lambda: F.conv2d(x_cl, w_cl, bias, stride, pad), 5)
        ops = 2 * B * ho * wo * cout * cin * k * k  # over the real channels
        c_bytes = B * h * w * cp + wp.numel() + B * ho * wo * cout * 2 \
            + 6 * cout
        c_ops_ms, c_bytes_ms = ops / INT8_OPS * 1e3, \
            c_bytes / HBM_BYTES_PER_S * 1e3
        q_bound = max((B * h * w * (2 * cin + cp)) / HBM_BYTES_PER_S,
                      4 * B * h * w * cin / FP32_FLOPS) * 1e3
        r = dict(site=name, sites=count, shape=f"{B}x{h}x{w}x{cin}",
                 cout=cout, k=k, stride=stride, conv_ms=c_ms,
                 conv_bound_ms=max(c_ops_ms, c_bytes_ms),
                 conv_bound_by="operations" if c_ops_ms >= c_bytes_ms
                 else "bytes", conv_plain_ms=c_plain, library_ms=lib,
                 quant_ms=q_ms, quant_bound_ms=q_bound,
                 quant_plain_ms=q_plain, tops=ops / c_ms / 1e9)
        rows.append(r)
        for key, v in (("conv_ms", c_ms), ("quant_ms", q_ms),
                       ("conv_plain_ms", c_plain),
                       ("quant_plain_ms", q_plain), ("library_ms", lib),
                       ("conv_bound_ms", r["conv_bound_ms"]),
                       ("quant_bound_ms", q_bound),
                       ("conv_ops_ms", c_ops_ms),
                       ("conv_bytes_ms", c_bytes_ms), ("ops", ops)):
            tot[key] += v * count
        say("int8", site=name, shape=r["shape"], cout=cout, k=k,
            stride=stride, sites=count, conv_ms=f"{c_ms:.4f}",
            plan=_plan_text(quant.conv_plan(cout, wp.shape[1],
                                            torch.bfloat16, k, stride)),
            conv_bound_ms=f"{r['conv_bound_ms']:.4f}",
            conv_share_of_bound=f"{r['conv_bound_ms'] / c_ms:.3f}",
            int8_tops=f"{r['tops']:.1f}", library_bf16_ms=f"{lib:.4f}",
            conv_plain_ms=f"{c_plain:.2f}", quantize_ms=f"{q_ms:.4f}",
            quantize_bound_ms=f"{q_bound:.4f}",
            quantize_plain_ms=f"{q_plain:.4f}")
        r.update(_int8_int_mm(xq, wp, s, w_s, k, stride, pad, ho, wo))
        tot["int_mm_ms"] += r["int_mm_ms"] * count
        tot["int_mm_slice_ms"] += r["int_mm_slice_ms"] * count
        say("int8", site=name, int_mm_ms=f"{r['int_mm_ms']:.4f}",
            int_mm_images=r["int_mm_images"],
            int_mm_slice_ms=f"{r['int_mm_slice_ms']:.4f}",
            im2col_ms=f"{r['im2col_ms']:.4f}",
            im2col_mb=f"{r['im2col_mb']:.1f}", conv_s8_ms=f"{c_ms:.4f}",
            conv_s8_vs_int_mm=f"{r['int_mm_ms'] / c_ms:.2f}")
        del x, xq, x_cl
    say("int8", per_call="22 sites, 512 tiles, bf16",
        conv_ms=f"{tot['conv_ms']:.4f}",
        conv_bound_ms=f"{tot['conv_bound_ms']:.4f}",
        conv_share_of_bound=f"{tot['conv_bound_ms'] / tot['conv_ms']:.3f}",
        t_int8_ops=f"{tot['ops'] / 1e12:.3f}",
        library_bf16_ms=f"{tot['library_ms']:.4f}",
        conv_plain_ms=f"{tot['conv_plain_ms']:.2f}",
        quantize_ms=f"{tot['quant_ms']:.4f}",
        quantize_bound_ms=f"{tot['quant_bound_ms']:.4f}",
        quantize_plain_ms=f"{tot['quant_plain_ms']:.4f}",
        int_mm_ms=f"{tot['int_mm_ms']:.4f}")
    return {"sites": rows, **tot}


def _psnr(got: Path, want: Path, names) -> float:
    """PSNR over every pixel of the files ``names`` of two directories (the
    masks are full: the masked PSNR)."""
    se, n = 0.0, 0
    for name in names:
        d = decode_png(got / name).astype(np.float64) \
            - decode_png(want / name).astype(np.float64)
        se += float((d * d).sum())
        n += d.size
    return 10 * np.log10(255.0 ** 2 / max(se / n, 1e-12))


def phase_int8(dev, card: str, tmp: Path, served: dict, full: dict) -> dict:
    """w8a8 serving (``inference.quantize: int8``): both int8 kernels
    bitwise their plain versions at the 22 sites' shapes on 16 tiles, at
    one full-frame 512x912 pass and at shapes off the CTA tile, fp32 and
    bf16; their times at B = 512 against the bounds, the plain versions,
    cuDNN's bf16 convolution and ``torch._int_mm`` over im2col; the
    serve_directory phase's 36 frames tiled and full-frame at bf16 with
    int8 (calibrated once; 22 launches of each kernel a generator call;
    masked PSNR against the bf16 runs at least 35 dB; eq-frames/s beside
    them); one int8 generator call against one bf16 call; the card
    against the CPU at precision 32 on a 256x456 crop, the card's scales
    copied to the CPU engine (limit 1 count)."""
    before = _quant_counts()
    if any(before.values()):
        raise AssertionError(f"int8 kernels launched before the int8 phase: "
                             f"{before}")
    t0 = time.perf_counter()
    ff = [(HP if h == 80 else HP // (80 // h), WP if w == 80
           else WP // (80 // w), cin, cout, k, stride)
          for _, h, w, cin, cout, k, stride, _ in INT8_SITES]
    seed = 0
    for dtype in (torch.bfloat16, torch.float32):
        for shapes, n in (([r[1:7] for r in INT8_SITES], INT8_CHECK_TILES),
                          (ff, 1), (INT8_ODD, 3)):
            for shape in shapes:
                seed += 1
                _int8_check(n, shape, dtype, dev, seed)
    torch.cuda.synchronize()
    say("int8", bitwise_equal=True,
        check_seconds=f"{time.perf_counter() - t0:.1f}",
        site_shapes=len(INT8_SITES), tiles=INT8_CHECK_TILES,
        fullframe=f"{HP}x{WP}", odd_shapes=len(INT8_ODD),
        dtypes="bf16,fp32")
    times = _int8_site_times(dev)

    scene = tmp / "scene"
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    rec, launches, engines = {"sites": times}, {}, {}
    with _without_pil():
        for mode, base, ref in (("tiled", served["bf16"], "dir_bf16"),
                                ("fullframe", full["bf16"], "ff_bf16")):
            out = tmp / f"int8_{mode}"
            eng = engines[mode] = _dir_engine("bf16", scene, out, mode=mode,
                                              quantize="int8")
            log, level = _LogNames(), eng.logger.level
            log.setLevel(logging.INFO)
            eng.logger.setLevel(logging.INFO)
            eng.logger.addHandler(log)
            eng.process_directory()  # set-up: calibration, cuDNN, codec
            _zero_counts()
            for fn in QUANT_WRAPPERS.values():
                fn.launches = 0
            quant.conv_s8.by_variant = dict.fromkeys(quant.VARIANTS, 0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            written = eng.process_directory()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
            eng.logger.removeHandler(log)
            eng.logger.setLevel(level)
            counts, q = _read_counts(), _quant_counts()
            calls = DIR_FRAMES if mode == "fullframe" else -(-DIR_FRAMES // (
                eng._group_size(len(eng.boxes_for(_full_mask(), (H, W))))))
            calibrations = sum("int8 serving: calibrated 22 activation "
                               "scales on the first frame" in t
                               for t in log.text)
            if written != DIR_FRAMES or calibrations != 1:
                raise AssertionError(f"int8 {mode}: {written} frames, "
                                     f"{calibrations} calibrations")
            _check_counts(f"int8 {mode}", counts, calls, mode == "tiled",
                          "bf16")
            if q != {"conv_s8": 22 * calls, "quantize_act": 22 * calls}:
                raise AssertionError(f"int8 {mode}: launches {q}, expected "
                                     f"22 of each a call x {calls}")
            # each site on the kernel its plan names (the halo kernel at
            # conv11 and the smoothers)
            by_variant = dict(quant.conv_s8.by_variant)
            want = {v: n * calls for v, n in
                    _conv_s8_kernels().items()}
            if by_variant != want or not all(want.values()):
                raise AssertionError(f"int8 {mode}: conv_s8 launches by "
                                     f"kernel {by_variant}, expected {want}")
            launches[mode] = {**q, **counts,
                              **{f"conv_s8_{v}": n
                                 for v, n in by_variant.items()}}
            psnr = _psnr(out, tmp / ref, names)
            rec[mode] = {"eq_frames_per_s": DIR_FRAMES / seconds,
                         "bf16_eq_frames_per_s": base["eq_frames_per_s"],
                         "psnr_vs_bf16_db": psnr, "calls": calls}
            say("int8", mode=mode, frames=written, calls=calls,
                eq_frames_per_s=f"{DIR_FRAMES / seconds:.2f}",
                bf16_eq_frames_per_s=f"{base['eq_frames_per_s']:.2f}",
                psnr_vs_bf16_db=f"{psnr:.2f}", calibrations=calibrations,
                conv_s8_launches=q["conv_s8"],
                conv_s8_gather_launches=by_variant["gather"],
                conv_s8_halo_launches=by_variant["halo"],
                quantize_act_launches=q["quantize_act"],
                b1_b2_launches=json.dumps(counts).replace(" ", ""),
                card=f"'{card}'")
            if psnr < INT8_PSNR_DB:
                raise AssertionError(f"int8 {mode}: {psnr:.2f} dB against "
                                     f"bf16 (limit {INT8_PSNR_DB})")

    # one generator call of 512 tiles: int8 against bf16
    g = torch.Generator(device=dev).manual_seed(7)
    tiles = (torch.rand((B, PS, PS, 6), device=dev, generator=g) * 2 - 1
             ).to(torch.bfloat16)
    bf16 = _dir_engine("bf16", scene, tmp / "unused", quantize="off").model
    int8 = engines["tiled"].model
    with torch.no_grad():
        n0, v0 = _quant_counts(), dict(quant.conv_s8.by_variant)
        int8(tiles)
        one = {k: v - n0[k] for k, v in _quant_counts().items()}
        one.update({v: n - v0[v] for v, n in
                    quant.conv_s8.by_variant.items()})
        if one != {"conv_s8": 22, "quantize_act": 22,
                   **_conv_s8_kernels()}:
            raise AssertionError(f"one int8 call launched {one}")
        ms_int8 = time_ms(lambda: int8(tiles), 5)
        ms_bf16 = time_ms(lambda: bf16(tiles), 5)
        ms_int8_2 = time_ms(lambda: int8(tiles), 5)
    rec["generator_call"] = {"int8_ms": (ms_int8 + ms_int8_2) / 2,
                             "int8_runs_ms": [ms_int8, ms_int8_2],
                             "bf16_ms": ms_bf16}
    say("int8", generator_call=f"{B} tiles", int8_ms=f"{ms_int8:.2f}/"
        f"{ms_int8_2:.2f}", bf16_ms=f"{ms_bf16:.2f}",
        int8_conv_s8_ms=f"{times['conv_ms']:.2f}",
        int8_quantize_ms=f"{times['quant_ms']:.2f}",
        bf16_library_conv_ms=f"{times['library_ms']:.2f}")
    del bf16, int8, tiles

    # the card against the CPU at precision 32, the card's scales copied
    frame = engines["tiled"].load_frame(scene / "input" / names[0])
    frame = frame[100:356, 200:656][None]
    mask = np.zeros((256, 456), np.float32)
    mask[20:230, 40:400] = 1
    eroded = erode_full_support_np(mask)
    eng = _dir_engine("32", scene, tmp / "unused", quantize="int8")
    sites = eng.model.quant_layers()
    seen = {}

    def keep(path):
        def hook(m, inp, out):  # the int8 pass, not calibration's
            if m.quant_mode == "int8":
                seen.setdefault(path, (inp[0], out))
        return hook

    hooks = [layer.register_forward_hook(keep(p))
             for p, layer in sites.items()]
    try:
        got = eng.stylize_group(frame, [eroded])
    finally:
        for h in hooks:
            h.remove()
    cpu = _dir_engine("32", scene, tmp / "unused", device="cpu",
                      quantize="int8")
    load_quant_scales(cpu.model, {p: layer.a_scale for p, layer
                                  in sites.items()})
    cpu._quant_ready = True
    # each site of the card's pass, on the card's own input, bitwise the
    # CPU's layer (its first 4 tiles: the convs are per tile)
    cpu_sites = cpu.model.quant_layers()
    with torch.no_grad():
        for p, (x, y) in seen.items():
            want = cpu_sites[p](x[:4].cpu())
            if not torch.equal(y[:4].cpu(), want):
                raise AssertionError(f"int8 site {p}: the card's output "
                                     "differs from the CPU layer's on the "
                                     "same input")
    del seen
    want = cpu.stylize_group(frame, [eroded])
    dm = np.abs(got.astype(int) - want.astype(int))
    share = float((dm.max(axis=-1) > 0).mean())
    psnr = 10 * np.log10(255.0 ** 2 / max(float((dm ** 2).mean()), 1e-12))
    # the yardstick: the card against itself with 10 % of every
    # InstanceNorm output moved up by one ulp (seeded)
    g = torch.Generator(device=dev).manual_seed(3)
    real_norm = layers.instance_norm_act_autograd

    def one_ulp_up(x, act):
        y = real_norm(x, act)
        up = torch.rand(y.shape, device=y.device, generator=g) < 0.1
        return torch.where(up, torch.nextafter(
            y, torch.full_like(y, float("inf"))), y)

    layers.instance_norm_act_autograd = one_ulp_up
    try:
        nudged = eng.stylize_group(frame, [eroded])
    finally:
        layers.instance_norm_act_autograd = real_norm
    dn = np.abs(got.astype(int) - nudged.astype(int))
    rec["card_vs_cpu"] = {
        "max_abs": int(dm.max()), "differing_pixel_share": share,
        "psnr_db": psnr, "sites_bitwise": len(sites),
        "one_ulp_nudge_max_abs": int(dn.max()),
        "one_ulp_nudge_share": float((dn.max(axis=-1) > 0).mean())}
    say("int8", card_vs_cpu="256x456", precision="32", max_abs=int(dm.max()),
        differing_pixel_share=f"{share:.6f}", psnr_db=f"{psnr:.2f}",
        sites_bitwise_on_the_cards_inputs=len(sites),
        card_one_ulp_nudge_max_abs=int(dn.max()),
        card_one_ulp_nudge_share=
        f"{rec['card_vs_cpu']['one_ulp_nudge_share']:.6f}")
    if psnr < INT8_PSNR_DB or got.std() < 1.0:
        raise AssertionError(f"int8 card vs CPU: {psnr:.2f} dB (limit "
                             f"{INT8_PSNR_DB})")
    rec["seconds"] = time.perf_counter() - t0
    say("int8", seconds=f"{rec['seconds']:.1f}")
    return {"rec": rec, "launches": launches, "after": _quant_counts()}


TRANSPORT_FRAMES = 12
TRANSPORT_OFF = {"crop_readback": "off", "crop_upload": "off",
                 "mask_upload": "plane"}
UP_SPANS = ("host/upload", "host/readback_wait", "host/writer_drain")


def _transport_scene(root: Path, n: int = TRANSPORT_FRAMES) -> Path:
    """``write_scene``'s frames (RGB and a 3-band guide, 10x10 blocks of
    seeded colour) with partial masks: an ellipse of about a quarter of
    the 512x910 frame, drifting 3 px down and 5 px right a frame."""
    write_scene(root, n, H, W, seed=5)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i, name in enumerate(sorted(p.name for p in
                                    (root / "input").glob("*.png"))):
        r = ((yy - (0.45 * H + 3 * i)) / (0.3 * H)) ** 2 \
            + ((xx - (0.4 * W + 5 * i)) / (0.27 * W)) ** 2
        encode_png(root / "mask" / name,
                   np.where(r <= 1.0, 255, 0).astype(np.uint8),
                   compress_level=1)
    return root


class _Wire:
    """Bytes through the pinned buffers while installed: ``up`` through
    ``eng``'s upload pools (frames, masks, flows), ``down`` through every
    other pool (the pipeline's readbacks), with the distinct readback
    shapes (one pinned pool each); and each dispatched group, kept."""

    def __init__(self, eng):
        self.eng, self.up, self.down, self.shapes = eng, 0, 0, set()
        self.up_shapes = set()
        self.groups = []

    def __enter__(self):
        from patch_toon_tpu_torch.infer.pipeline import PinnedPools

        self._call, wire = PinnedPools.__call__, self

        def counted(pools, shape, dtype):
            n = int(np.prod(shape)) * torch.empty((), dtype=dtype
                                                  ).element_size()
            if pools is wire.eng.upload_pools:
                wire.up += n
                wire.up_shapes.add((tuple(shape), dtype))
            else:
                wire.down += n
                wire.shapes.add(tuple(shape))
            return wire._call(pools, shape, dtype)

        PinnedPools.__call__ = counted
        real = self.eng.dispatch_staged

        def noted(group):
            self.groups.append(list(group))
            return real(group)

        self.eng.dispatch_staged = noted
        return self

    def __exit__(self, *exc):
        from patch_toon_tpu_torch.infer.pipeline import PinnedPools

        PinnedPools.__call__ = self._call
        del self.eng.dispatch_staged
        return False


def _transport_run(eng, frames: int) -> dict:
    """One timed ``process_directory`` with the counters and the host
    spans zeroed just before and read just after, and the bytes over the
    bus counted. -> seconds, launches, bytes a frame, spans, groups."""
    _zero_counts()
    eng.spans.reset()
    with _Wire(eng) as wire:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = eng.process_directory()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if written != frames:
        raise AssertionError(f"transport: {written} of {frames} frames")
    spans = eng.spans.snapshot()
    return {"seconds": seconds, "counts": _read_counts(),
            "up": wire.up / frames, "down": wire.down / frames,
            "readback_shapes": sorted(f"{s[0]}x{s[1]}" for s in wire.shapes),
            "upload_pools": len(wire.up_shapes), "groups": wire.groups,
            "spans": {k: spans.get(k, {"ms": 0.0})["ms"] / frames
                      for k in UP_SPANS}}


def _masked_psnr(got: Path, want: Path, masks: Path, names) -> float:
    """PSNR over the pixels inside each frame's mask (> 128)."""
    se, n = 0.0, 0
    for name in names:
        sel = decode_png(masks / name)[..., 0] > 128
        d = decode_png(got / name)[sel].astype(np.float64) \
            - decode_png(want / name)[sel].astype(np.float64)
        se += float((d * d).sum())
        n += d.size
    return 10 * np.log10(255.0 ** 2 / max(se / n, 1e-12))


def _window_kernels(eng, group, dev) -> dict:
    """B1 and B2 at the first upload-cropped group's shapes: the group's
    tiles gathered from its windows through one bf16 generator call, each
    InstanceNorm site's output (B1's cluster variant) against the plain
    version with ``_in_check``'s tolerance; its canvas (F x (bh + 80)) x
    (bw + 80) blended by B2 and by the plain version, bitwise."""
    frames = torch.stack([s.frame for s in group])
    f, bh, bw, _ = frames.shape
    plan, weights = eng._pack([s.boxes for s in group], bh, bw, dev)
    tiles = gather_tiles(frames, plan.fboxes, PS).to(torch.bfloat16)
    sites, real = [], layers.instance_norm_act_autograd

    def keep(x, act):
        y = real(x, act)
        sites.append((x, act, y))
        return y

    layers.instance_norm_act_autograd = keep
    try:
        with torch.no_grad():
            gen = eng.model(tiles).float().contiguous()
    finally:
        layers.instance_norm_act_autograd = real
    worst = 0.0
    for x, act, y in sites:
        if instance_norm.plan_for(x).variant != "cluster":
            raise AssertionError(f"window site {tuple(x.shape)}: plan "
                                 f"{instance_norm.plan_for(x)}")
        worst = max(worst, _in_check(
            y, instance_norm.instance_norm_act_plain(x, act), x.dtype))
    ch, cw = f * (bh + PS), bw + PS
    got = blend.blend_tiles(gen, weights, plan.positions, plan.offsets,
                            plan.ids, ch, cw)
    want = blend.blend_tiles_plain(gen, weights, plan.positions, ch, cw)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("blend_tiles differs from its plain version on "
                             f"the {ch}x{cw} window canvas")
    return {"window": f"{bh}x{bw}", "frames": f, "tiles": int(
        (plan.positions[:, 0] >= 0).sum()), "bucket": len(plan.fboxes),
        "canvas": f"{ch}x{cw}", "b1_sites": len(sites),
        "b1_max_abs_err": worst, "b2_bitwise": True}


def phase_transport(dev, card: str, tmp: Path) -> dict:
    """The transport knobs on the card (``crop_upload``, ``crop_readback``,
    ``mask_upload: packed``; JAX's defaults) over 12 frames of 512x910 with
    a drifting quarter-frame ellipse mask, full width: tiled bf16 and 32,
    full-frame bf16 (readback crop only) and the device-flow chain (tiled
    bf16, ``phase_temporal_device``'s masks), each with the defaults and
    with every knob off, the two runs' files bitwise equal; bytes up and
    down a frame, eq-frames/s, the host split and the window and box sizes
    of each; B1 and B2 at the first cropped group's shapes against their
    plain versions; int8 with the defaults, 35 dB masked PSNR against the
    bf16 default run."""
    t0 = time.perf_counter()
    scene = _transport_scene(tmp / "tscene")
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    n = TRANSPORT_FRAMES
    rec, launches = {}, dict.fromkeys(LAUNCH_KINDS, 0)
    q_launches = dict.fromkeys(QUANT_WRAPPERS, 0)
    kernels = None
    with _without_pil():
        for tag, prec, mode, runs in (("tiled_bf16", "bf16", "tiled", 2),
                                      ("tiled_32", "32", "tiled", 1),
                                      ("fullframe_bf16", "bf16", "fullframe",
                                       1)):
            engs = {k: _dir_engine(prec, scene, tmp / f"tr_{tag}_{k}",
                                   mode=mode, **knobs)
                    for k, knobs in (("defaults", {}),
                                     ("off", TRANSPORT_OFF))}
            for eng in engs.values():
                eng.process_directory()  # set-up: cuDNN, codec, pools
            res = {k: [] for k in engs}
            order = ["defaults", "off", "off", "defaults"][:2 * runs]
            for k in order:
                res[k].append(_transport_run(engs[k], n))
            r = rec[tag] = {}
            for k, rs in res.items():
                last = rs[-1]
                groups = len(last["groups"])
                want = _want_counts(n if mode == "fullframe" else groups,
                                    mode == "tiled", prec)
                for run in rs:
                    if run["counts"] != want:
                        raise AssertionError(
                            f"transport {tag} {k}: launches "
                            f"{run['counts']}, expected {want}")
                    for c in LAUNCH_KINDS:
                        launches[c] += run["counts"][c]
                wins = sorted({(s.cropwin[1] - s.cropwin[0],
                                s.cropwin[3] - s.cropwin[2])
                               for g in last["groups"] for s in g
                               if s.cropwin is not None})
                r[k] = {"eq_frames_per_s": n * len(rs)
                        / sum(x["seconds"] for x in rs),
                        "bytes_up_per_frame": last["up"],
                        "bytes_down_per_frame": last["down"],
                        "groups": groups,
                        "readback_boxes": last["readback_shapes"],
                        "upload_pools": last["upload_pools"],
                        "upload_windows": [f"{a}x{b}" for a, b in wins],
                        "host_ms_per_frame": last["spans"]}
                if k == "defaults" and mode == "tiled" and kernels is None:
                    first = next(g for g in last["groups"]
                                 if g[0].cropwin is not None)
                    kernels = _window_kernels(engs[k], first, dev)
            # JAX's claim is per dispatch: the knobs-off engine re-serves
            # the defaults' groups one call each (a window shape change
            # closes a group, and a batch of another size may round
            # otherwise on the card), and must be bitwise equal
            groups = {k: [[s.path.name for s in g]
                          for g in res[k][-1]["groups"]] for k in res}
            same = [n_ for g in groups["defaults"] if g in groups["off"]
                    for n_ in g]
            eng = engs["off"]
            eng.cfg["paths"]["output_dir"] = str(tmp / f"tr_{tag}_regrouped")
            for g in groups["defaults"]:
                eng.process_directory(files=[scene / "input" / x for x in g])
            if tag == "tiled_bf16":  # where the card's time goes, masked
                tr = _traced(engs["defaults"].process_directory)
                r["traced"] = {
                    "device_ms_per_frame": tr["device_ms"] / n,
                    "busy_share": tr["device_ms"] / tr["wall_ms"],
                    "top_device_ms": tr["top"], "top_aten_ms": tr["top_aten"]}
                say("transport", run=tag, traced="defaults",
                    device_ms_per_frame=f"{tr['device_ms'] / n:.3f}",
                    busy_share=f"{tr['device_ms'] / tr['wall_ms']:.3f}",
                    top=json.dumps([(k[:60], round(v, 3))
                                    for k, v in tr["top"]]),
                    top_aten=json.dumps([(k, round(v, 3))
                                         for k, v in tr["top_aten"]]))
            worst, differ = _compare_dirs(tmp / f"tr_{tag}_defaults",
                                          tmp / f"tr_{tag}_regrouped", names)
            nat = {x: _compare_dirs(tmp / f"tr_{tag}_defaults",
                                    tmp / f"tr_{tag}_off", [x])
                   for x in names}
            r["defaults_vs_off_max_abs"] = worst
            r["natural_groups_max_abs"] = max(v[0] for v in nat.values())
            r["natural_differing_frames"] = [x for x, v in nat.items()
                                             if v[0]]
            d, o = r["defaults"], r["off"]
            say("transport", run=tag, frames=n, bitwise_equal=worst == 0,
                differing_pixels=differ,
                group_sizes="/".join(",".join(str(len(g)) for g in groups[k])
                                     for k in ("defaults", "off")),
                natural_max_abs=r["natural_groups_max_abs"],
                natural_differing_frames=",".join(
                    r["natural_differing_frames"]) or "none",
                bytes_up_per_frame=f"{d['bytes_up_per_frame']:.0f}/"
                f"{o['bytes_up_per_frame']:.0f}",
                bytes_down_per_frame=f"{d['bytes_down_per_frame']:.0f}/"
                f"{o['bytes_down_per_frame']:.0f}",
                eq_frames_per_s=f"{d['eq_frames_per_s']:.2f}/"
                f"{o['eq_frames_per_s']:.2f}",
                groups=f"{d['groups']}/{o['groups']}",
                upload_windows=",".join(d["upload_windows"]) or "none",
                readback_boxes=",".join(d["readback_boxes"]) + "/"
                + ",".join(o["readback_boxes"]),
                pinned_pools=f"{len(d['readback_boxes']) + d['upload_pools']}"
                f"/{len(o['readback_boxes']) + o['upload_pools']}",
                **{f"{s.split('/')[1]}_ms_per_frame":
                   f"{d['host_ms_per_frame'][s]:.3f}/"
                   f"{o['host_ms_per_frame'][s]:.3f}" for s in UP_SPANS},
                ways="defaults/off", card=f"'{card}'")
            bad = [x for x in same if nat[x][0]]
            if worst != 0 or bad:
                raise AssertionError(f"transport {tag}: the defaults' files "
                                     f"differ from the knobs-off run's by "
                                     f"{worst} counts ({differ} pixels) in "
                                     f"the same dispatches; {bad} differ "
                                     f"in groups the two runs share")
        say("transport", check="B1 and B2 at the first cropped group",
            **{k: (f"{v:.3g}" if isinstance(v, float) else v)
               for k, v in kernels.items()})
        rec["window_kernels"] = kernels

        # the device-flow chain: readback crop and packed flow masks
        ckpt = _temporal_ckpt(tmp)
        cscene = _device_flow_scene(scene, tmp / "tchain", n)
        chain = {}
        for k, knobs in (("defaults", {}), ("off", TRANSPORT_OFF)):
            eng = _temporal_engine("bf16", cscene, tmp / f"tr_chain_{k}",
                                   ckpt, "tiled", mask="mask_ignore",
                                   flow_source="device",
                                   file_format=FLOW_FMT, knobs=knobs)
            eng.process_directory()  # set-up: cuDNN, the flow graphs
            eng._temporal_prev = eng._temporal_prev_gray = None
            run = _transport_run(eng, n)
            if run["counts"] != _want_counts(n, True, "bf16"):
                raise AssertionError(f"transport chain {k}: launches "
                                     f"{run['counts']}")
            for c in LAUNCH_KINDS:
                launches[c] += run["counts"][c]
            chain[k] = {"eq_frames_per_s": n / run["seconds"],
                        "bytes_up_per_frame": run["up"],
                        "bytes_down_per_frame": run["down"],
                        "readback_boxes": run["readback_shapes"],
                        "graphs": eng.flow_graphs.captures,
                        "host_ms_per_frame": run["spans"]}
        worst, differ = _compare_dirs(tmp / "tr_chain_defaults",
                                      tmp / "tr_chain_off", names)
        chain["defaults_vs_off_max_abs"] = worst
        rec["chain_bf16"] = chain
        d, o = chain["defaults"], chain["off"]
        say("transport", run="device_flow_chain_tiled_bf16", frames=n,
            bitwise_equal=worst == 0, differing_pixels=differ,
            bytes_up_per_frame=f"{d['bytes_up_per_frame']:.0f}/"
            f"{o['bytes_up_per_frame']:.0f}",
            bytes_down_per_frame=f"{d['bytes_down_per_frame']:.0f}/"
            f"{o['bytes_down_per_frame']:.0f}",
            eq_frames_per_s=f"{d['eq_frames_per_s']:.2f}/"
            f"{o['eq_frames_per_s']:.2f}",
            flow_graphs=f"{d['graphs']}/{o['graphs']}",
            readback_boxes=",".join(d["readback_boxes"]) + "/"
            + ",".join(o["readback_boxes"]),
            ways="defaults/off", card=f"'{card}'")
        if worst != 0:
            raise AssertionError(f"transport chain: the defaults' files "
                                 f"differ from the knobs-off run's by "
                                 f"{worst} counts ({differ} pixels)")

        # int8 with the defaults: calibrated on the first window; the int8
        # counters zeroed around the timed run, then given back their sum
        q_start = _quant_counts()
        eng = _dir_engine("bf16", scene, tmp / "tr_int8", quantize="int8")
        eng.process_directory()  # set-up: calibration, cuDNN, codec
        saved = _quant_counts()
        for fn in QUANT_WRAPPERS.values():
            fn.launches = 0
        run = _transport_run(eng, n)
        calls = len(run["groups"])
        q = _quant_counts()
        for k, fn in QUANT_WRAPPERS.items():
            fn.launches = saved[k] + q[k]
        if q != {"conv_s8": 22 * calls, "quantize_act": 22 * calls} \
                or run["counts"] != _want_counts(calls, True, "bf16"):
            raise AssertionError(f"transport int8: launches {q}, "
                                 f"{run['counts']} over {calls} calls")
        for c in LAUNCH_KINDS:
            launches[c] += run["counts"][c]
        for c in q_launches:
            q_launches[c] += q[c]
        psnr = _masked_psnr(tmp / "tr_int8", tmp / "tr_tiled_bf16_defaults",
                            scene / "mask", names)
        rec["int8"] = {"eq_frames_per_s": n / run["seconds"],
                       "masked_psnr_vs_bf16_db": psnr, "calls": calls,
                       "bytes_up_per_frame": run["up"],
                       "bytes_down_per_frame": run["down"]}
        say("transport", run="int8_tiled_bf16", frames=n, calls=calls,
            masked_psnr_vs_bf16_db=f"{psnr:.2f}",
            eq_frames_per_s=f"{n / run['seconds']:.2f}",
            conv_s8_launches=q["conv_s8"], card=f"'{card}'")
        if psnr < INT8_PSNR_DB:
            raise AssertionError(f"transport int8: {psnr:.2f} dB against "
                                 f"bf16 (limit {INT8_PSNR_DB})")
    rec["seconds"] = time.perf_counter() - t0
    say("transport", seconds=f"{rec['seconds']:.1f}")
    return {"rec": rec, "launches": launches, "int8": q_launches,
            "int8_total": {k: v - q_start[k]
                           for k, v in _quant_counts().items()}}


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
    dispatch cost included). The sample variant, forced where a sample's
    x and dy fit 8 CTAs, is checked and timed beside them (cluster, sample,
    streaming in turns). The per-step numbers sum the 25 sites; the
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
            sp = instance_norm.sample_plan(BT, *shape, dtype, backward=True)
            fns = dict(BWD_VARIANTS)
            if sp is not None:
                fns["sample"] = lambda *a: instance_norm. \
                    instance_norm_act_backward_sample(*a, p=sp)
            r = {}
            for v, fn in fns.items():
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

            ms = {v: [] for v in fns}
            for v in ("cluster", "sample", "streaming") * 3:
                if v not in fns:
                    continue
                fn = fns[v]
                ms[v].append(queued_ms(calls(
                    lambda xc, dc: lambda: fn(xc, dc, mean, rstd, act)),
                    reps))
            r.update({f"ms_{v}": sorted(t)[1] for v, t in ms.items()})
            r.update({f"b2b_ms_{v}": time_ms(
                lambda: fn(x, dy, mean, rstd, act), 10)
                for v, fn in fns.items()})
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
                sample_k=sp.k if sp else None,
                sample_ms=f"{r['ms_sample']:.4f}" if sp else None,
                sample_runs="/".join(f"{t:.4f}" for t in ms["sample"])
                if sp else None,
                max_abs_err_sample=f"{r['err_sample']:.3g}" if sp else None,
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
    rec["sample_train_sites"] = {}
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
        # the sample variant forced at the sites whose x and dy fit 8 CTAs,
        # beside the cluster variant at the same sites
        fit = [r for r in rows if "ms_sample" in r]
        rec["sample_train_sites"].update({
            f"sites{tag}": len(fit),
            f"ms{tag}": sum(r["ms_sample"] for r in fit),
            f"cluster_ms{tag}": sum(r["ms_cluster"] for r in fit),
            f"max_abs_err{tag}": max(r["err_sample"] for r in fit)})
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
            sample_forced_sites=rec["sample_train_sites"]["sites" + tag],
            sample_forced_ms=f"{rec['sample_train_sites']['ms' + tag]:.4f}",
            cluster_at_those_sites_ms=
            f"{rec['sample_train_sites']['cluster_ms' + tag]:.4f}",
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
                 max_steps: int = 0, model: int = 1, feature_layers=None):
    over = {"training": {"precision": precision, "batch_size": batch,
                         "max_steps": max_steps},
            "parallel": {"mesh": {"data": -1, "model": model}}}
    if small or feature_layers:
        over["model"] = training_config()["model"]
    if small:  # the CPU tests' widths (tests/test_torch_train.py)
        over["model"]["generator"]["args"].update(
            filters=[8, 16, 32, 32, 32, 16], resnet_blocks=2)
        over["model"]["discriminator"]["args"]["num_filters"] = 8
    if feature_layers:  # the VGG prefix drawn as JAX's seed-42 init
        over["model"]["perception_loss"]["perception_model"]["args"].update(
            feature_layers=list(feature_layers), path=None)
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


def _set_counts(counts) -> None:
    """Sets the four counters that ``_counts`` reads, in its order."""
    (instance_norm.instance_norm_act_cluster.launches,
     instance_norm.instance_norm_act_streaming.launches,
     instance_norm.instance_norm_act_backward_cluster.launches,
     instance_norm.instance_norm_act_backward_streaming.launches) = counts


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


def _fast_step_parity(dev) -> dict:
    """One ``32_fast`` step on the card against one precision-32 step on
    the card from the same parameters and batch (full width, batch 2):
    ``first_step_agreement`` of the two within 1e-2 in relative L2 (where
    an activation input lies within the split's roundoff of 0 the two take
    other branches, each flip moving every gradient upstream by about 3e-3;
    the flips are counted), and the ``32_fast`` step against the fp64 step
    that takes its own branches within 5e-5, the bar precision 32 meets
    (``train/parity.py``)."""
    rng = np.random.default_rng(1)
    batch = {"pre": rng.standard_normal((2, PS, PS, 3)),
             "channels": rng.standard_normal((2, PS, PS, 3)),
             "post": rng.random((2, PS, PS, 3)) * 2 - 1}
    m32, mfast = _train_model("32", batch=2), _train_model("32_fast", batch=2)
    with training_backends(torch.float32):
        # one seed: the same parameters, the networks' convs split or not
        start, start_fast = m32.init_state(0, "cpu"), mfast.init_state(0,
                                                                       "cpu")
        if any(not torch.equal(a, b) for a, b in zip(
                _net_tensors(start).values(),
                _net_tensors(start_fast).values())):
            raise AssertionError("32 and 32_fast start from other weights")
        k32, kfast = Kinks(), Kinks()
        st32, _ = run_step(m32, start, batch, dev, k32)
        stfast, _ = run_step(mfast, start_fast, batch, dev, kfast)
        ref, _ = run_step(mfast, start_fast, batch, "cpu",
                          Kinks(replay=kfast.masks), torch.float64)
    vs32 = first_step_agreement(state_pairs(st32, stfast))
    own = first_step_agreement(state_pairs(ref, stfast))
    flips = sum(int((a != b).sum()) for a, b in zip(k32.masks, kfast.masks))
    say("train", first_step="32_fast against 32 on the card, full width, "
        "batch 2", grad_rel_l2=f"{vs32['grad_rel_l2']:.3g}",
        kernel_rel_l2=f"{vs32['kernel_rel_l2']:.3g}",
        params_beyond_tolerance=vs32["beyond"], branch_flips=flips,
        own_fp64_grad_rel_l2=f"{own['grad_rel_l2']:.3g}",
        own_fp64_kernel_rel_l2=f"{own['kernel_rel_l2']:.3g}",
        limits="1e-2 against 32, 5e-5 against its own fp64")
    if vs32["grad_rel_l2"] > 1e-2:
        raise AssertionError(f"32_fast step against 32: {vs32}")
    assert_first_step_close(own, 5e-5, "32_fast against its fp64")
    return {"vs_32_grad_rel_l2": vs32["grad_rel_l2"],
            "own_fp64_grad_rel_l2": own["grad_rel_l2"], "flips": flips}


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
            _set_counts((0, 0, 0, 0))
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
    launches = {"forward": 0, "backward": 0, "backward_streaming": 0,
                "forward_32_fast": 0, "backward_32_fast": 0}
    final = {}
    for prec in ("32", "bf16", "32_fast"):
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
        if prec == "32_fast":
            launches["forward_32_fast"] += fwd
            launches["backward_32_fast"] += bwd
        if prec in ("32", "bf16"):  # the multi_gpu phase's reference
            final[prec] = _net_tensors(state)
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

    for prec in ("32", "bf16", "32_fast"):  # determinism: two fit runs
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

    rec["32_fast_first_step"] = _fast_step_parity(dev)

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
    return {"rec": rec, "launches": launches, "final": final}

# ----------------------------------------------------------- train_rest

REST_STEPS = 12       # steps of the grid and permutation runs
ACC_STEPS = 4         # micro-steps of each accumulation determinism run
PERM_DRAWS = 2500     # batches of the sampler-alone coverage check
_REAL_MULTISTEP = optim.MultiSteps.step


def _perm_coverage(data, draws: int) -> dict:
    """The permutation sampler alone, ``draws`` batches of ``BT``: every
    draw that does not straddle a reset marks its slot in a per-image hit
    table on the device; when an image's cursor wraps, each of its
    centres must have been hit exactly once in that cycle. The straddling
    draws (PARITY_NOTES #16: they re-read the old permutation modulo the
    count) are counted apart."""
    sample = data.make_sampler(BT)
    counts = data.counts.to(torch.int64)
    slot_ok = torch.arange(data.centers.shape[1], device=data.device)[
        None, :] < counts[:, None]
    hits = torch.zeros(slot_ok.shape, dtype=torch.int32, device=data.device)
    tally = torch.zeros(3, dtype=torch.int64, device=data.device)
    real = data.sample_batch_permutation
    images = torch.arange(data.num_images, device=data.device)

    def spy(state, imgs, fresh, aug_u=None, rows=slice(None)):
        imgs = imgs.to(torch.int64)
        occ = torch.tril(imgs[:, None] == imgs[None, :], -1).sum(1)
        ahead = state["cursor"][imgs] + occ
        keep = ahead < counts[imgs]
        slots = state["perm"][imgs, ahead % counts[imgs]]
        hits.index_put_((imgs[keep], slots[keep]), torch.ones_like(
            slots[keep], dtype=torch.int32), accumulate=True)
        wrapped = state["cursor"] + (imgs[None, :] == images[:, None]).sum(
            1) >= counts
        whole = ((hits == 1) | ~slot_ok).all(dim=1)
        tally.add_(torch.stack([wrapped.sum(), (wrapped & ~whole).sum(),
                                (~keep).sum()]))
        hits.mul_((~wrapped)[:, None].to(torch.int32))
        return real(state, imgs, fresh, aug_u, rows)

    data.sample_batch_permutation = spy
    try:
        gen = torch.Generator(device=data.device).manual_seed(4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(draws):
            sample(gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        del data.sample_batch_permutation
    cycles, broken, straddles = tally.tolist()
    return {"cycles": cycles, "broken_cycles": broken,
            "straddling_draws": straddles, "draws": draws,
            "ms_per_draw_with_check": 1e3 * seconds / draws}


class _SpyLogger:
    """``MetricsLogger`` in ``fit``: keeps the images, logs nothing."""
    images: list = []

    def __init__(self, log_dir):
        _SpyLogger.images = []

    def log_scalars(self, metrics, step):
        pass

    def log_image(self, tag, image, step):
        _SpyLogger.images.append((tag, image, step))

    def close(self):
        pass


@contextlib.contextmanager
def _patched(obj, name: str, value):
    saved = obj.__dict__[name]
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


class _AccumulationCheck:
    """Wraps ``MultiSteps.step`` during a ``fit``: after a micro-step that
    does not update, every parameter must be bitwise as before; after one
    that does, the parameters are held against one ``Adam`` step, taken by
    a copy of the optimizer's state before the update, on the Welford mean
    that this check computes on the card from the held mean and the
    micro-step's gradients (the largest |d| over the largest |p| of each
    tensor)."""

    def __init__(self):
        self.moved_between = 0
        self.updates = 0
        self.worst_rel = 0.0

    def __call__(self, opt, grads):
        before = [p.detach().clone() for p in opt.params]
        emit = opt.mini_step == opt.every_k - 1
        if emit:
            inner = opt.inner
            ref = optim.Adam([torch.nn.Parameter(b.clone()) for b in before],
                             inner.lr, (inner.b1, inner.b2),
                             inner.weight_decay, inner.eps, inner.clip_norm)
            ref.count = inner.count
            ref.mu = [m.clone() for m in inner.mu]
            ref.nu = [v.clone() for v in inner.nu]
            mean = [a + (g.detach().float() - a) / float(opt.mini_step + 1)
                    for a, g in zip(opt.acc, grads)]
        _REAL_MULTISTEP(opt, grads)
        if not emit:
            self.moved_between += sum(
                not torch.equal(b, p) for b, p in zip(before, opt.params))
            return
        ref.step(mean)
        self.updates += 1
        for r, p in zip(ref.params, opt.params):
            scale = float(p.detach().abs().max()) or 1.0
            self.worst_rel = max(self.worst_rel, float(
                (r.detach() - p.detach()).abs().max()) / scale)


def _fit_run(model, data, run_dir: Path, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = fit(model, data, str(run_dir), progress=False, **kw)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def _rest_model(precision: str, max_steps: int, **training):
    model = _train_model(precision, max_steps=max_steps)
    model.training_config.update(training)
    model.accumulate = int(training.get("accumulate_grad_batches", 1))
    return model


DEEP_VGG_LAYERS = (0, 3, 5, 10, 21)  # features up to conv4_2 (index 21)
DEEP_VGG_STEPS = 3


def phase_deep_vgg(dev, card: str, tmp: Path) -> dict:
    """``fit`` at batch 80, the shipped width, bf16, with the perceptual
    VGG19 taken to features index 21 and no weights file: the prefix is
    JAX's seed-42 draw (``models/perception.py::init_vgg_state``, numpy on
    the host; its seconds timed alone first). One warm-up step, then
    ``DEEP_VGG_STEPS`` timed with the B1 counters zeroed just before and
    read just after (25 forward and 25 backward cluster launches a step:
    the VGG has no InstanceNorm); the losses finite, the perceptual term
    among them. The draw is timed where ``fit`` makes it (the model's
    ``init_state``), once a run."""
    from patch_toon_tpu_torch.models import perception

    draws = []
    draw = perception.init_vgg_state

    def timed_draw(*args, **kwargs):
        t0 = time.perf_counter()
        state = draw(*args, **kwargs)
        draws.append((state, time.perf_counter() - t0))
        return state

    frames, pres, posts, masks, guides = _keyframes()
    data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, device=dev)
    model = _train_model("bf16", max_steps=1 + DEEP_VGG_STEPS,
                         feature_layers=DEEP_VGG_LAYERS)
    win = _Window(1, 1 + DEEP_VGG_STEPS)
    with _patched(perception, "init_vgg_state", timed_draw):
        state, sec = _fit_run(model, data, tmp / "deep_vgg", seed=0,
                              on_step=win)
    if len(draws) != 1:
        raise AssertionError(f"deep_vgg: the prefix drawn {len(draws)} "
                             "times in one run (want 1)")
    vgg, draw_s = draws[0]
    fwd, st, bwd, bst = win.counts
    vals = {k: float(v) for k, v in win.metrics.items()}
    convs = len(vgg) // 2
    say("deep_vgg", feature_layers=list(DEEP_VGG_LAYERS), convs=convs,
        params=sum(v.numel() for v in vgg.values()),
        draw_s=f"{draw_s:.3f}", batch=BT, precision="bf16",
        steps=DEEP_VGG_STEPS,
        ms_per_step=f"{1e3 * win.seconds / DEEP_VGG_STEPS:.2f}",
        seconds_with_setup=f"{sec:.2f}", forward_launches=fwd,
        backward_launches=bwd, streaming=st + bst,
        g_perception_loss=f"{vals.get('g_perception_loss', float('nan')):.5f}",
        card=f"'{card}'")
    finite = all(np.isfinite(v) for v in vals.values()) and all(
        bool(torch.isfinite(t).all()) for t in _net_tensors(state).values())
    if (fwd, st, bwd, bst) != (25 * DEEP_VGG_STEPS, 0, 25 * DEEP_VGG_STEPS,
                               0) or not finite or convs != 10 \
            or "g_perception_loss" not in vals:
        raise AssertionError(f"deep_vgg: launches {(fwd, st, bwd, bst)}, "
                             f"finite {finite}, {convs} convs, metrics "
                             f"{sorted(vals)}")
    return {"rec": {"feature_layers": list(DEEP_VGG_LAYERS), "convs": convs,
                    "draw_s": draw_s, "steps": DEEP_VGG_STEPS,
                    "ms_per_step": 1e3 * win.seconds / DEEP_VGG_STEPS,
                    "seconds_with_setup": sec, "metrics": vals},
            "launches": {"forward": fwd, "backward": bwd}}


def phase_train_rest(dev, card: str, tmp: Path) -> dict:
    """The training knobs of this slice through ``fit`` at the shipped
    width, batch 80, on the train phase's keyframes: (a) permutation
    sampling, (b) gradient accumulation, (c) the comparison grid, (d) the
    profiler trace. B1's launches are counted over the whole phase."""
    from patch_toon_tpu_torch.train import loop as train_loop

    frames, pres, posts, masks, guides = _keyframes()
    data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, device=dev)
    perm = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, sampling="permutation",
                                device=dev)
    rec = {}
    _set_counts((0, 0, 0, 0))

    # (a) the permutation sampler alone; (a, c) two bf16 fit runs with it,
    # the grid every 4 steps, a spy logger keeping the images
    cov = _perm_coverage(perm, PERM_DRAWS)
    say("train_rest", sampler="permutation", batch=BT, **{
        k: (f"{v:.3f}" if isinstance(v, float) else v)
        for k, v in cov.items()},
        centres_per_image="/".join(str(int(c)) for c in perm.counts_np))
    if cov["cycles"] < perm.num_images or cov["broken_cycles"]:
        raise AssertionError(f"permutation coverage: {cov}")
    grids, runs = [], []
    real_grid = train_loop.comparison_grid

    def keep_grid(model, state, dataset, batch):
        grid = real_grid(model, state, dataset, batch)
        grids.append(({k: v.clone() for k, v in batch.items()}, grid))
        return grid

    with _patched(train_loop, "MetricsLogger", _SpyLogger), \
            _patched(train_loop, "comparison_grid", keep_grid):
        for i in range(2):
            grids.clear()
            state, sec = _fit_run(_rest_model("bf16", REST_STEPS,
                                              image_log_freq=4),
                                  perm, tmp / f"perm_{i}", seed=3)
            runs.append(_net_tensors(state))
    logged = [s for _, _, s in _SpyLogger.images]
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    b1 = _counts()
    # the last grid against the copied numpy function on the card's arrays:
    # the step's batch and an eval-mode forward with the final parameters
    batch, grid = grids[-1]
    gnet = state.generator.eval()
    with torch.no_grad():
        generated = gnet(perm.model_input(batch).to(torch.bfloat16))
    gnet.train()
    host = {k: v.float().cpu().numpy() for k, v in batch.items()}
    want = build_comparison_grid(host["pre"], generated.float().cpu().numpy(),
                                 host["post"], host["channels"], [3])
    grid_equal = bool(np.array_equal(grid, want)) \
        and bool(np.array_equal(grid, _SpyLogger.images[-1][1]))
    say("train_rest", entry="fit", sampling="permutation", precision="bf16",
        steps=REST_STEPS, runs_bitwise_equal=not differ,
        differing_tensors=len(differ), image_log_freq=4,
        log_image_steps="/".join(map(str, logged)),
        grid_shape="x".join(map(str, grid.shape)), grid_bitwise=grid_equal,
        seconds=f"{sec:.2f}")
    if differ or logged != [4, 8, 12] or not grid_equal \
            or grid.shape != (8 * (PS + 4), 4 * (PS + 4), 3):
        raise AssertionError(f"permutation runs differ in {differ[:5]}, "
                             f"images at {logged}, grid {grid.shape}, "
                             f"bitwise {grid_equal}")
    _set_counts(b1)

    # ms a bf16 step with permutation sampling against uniform, in turns;
    # the timing runs' launches are not counted (the window zeroes them)
    ms = {}
    for name, ds in (("permutation", perm), ("uniform", data),
                     ("uniform", data), ("permutation", perm)):
        win = _Window(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
        _fit_run(_rest_model("bf16", TRAIN_WARMUP + TRAIN_STEPS), ds,
                 tmp / f"samp_t_{name}", seed=0, on_step=win)
        ms.setdefault(name, []).append(1e3 * win.seconds / TRAIN_STEPS)
    _set_counts(b1)
    say("train_rest", entry="fit", precision="bf16", steps=TRAIN_STEPS,
        ms_per_step_permutation="/".join(f"{t:.2f}" for t in
                                         ms["permutation"]),
        ms_per_step_uniform="/".join(f"{t:.2f}" for t in ms["uniform"]),
        card=f"'{card}'")
    rec["permutation"] = {**cov, "ms_per_step": sum(ms["permutation"]) / 2,
                          "ms_per_step_uniform": sum(ms["uniform"]) / 2}

    # (b) accumulate_grad_batches = 2 at 32 and bf16: two runs, the first
    # checked micro-step by micro-step; then ms a micro-step against k = 1
    for prec in ("32", "bf16"):
        check = _AccumulationCheck()
        states = []
        for i in range(2):
            spy = (lambda opt, grads: check(opt, grads)) if i == 0 \
                else _REAL_MULTISTEP
            with _patched(optim.MultiSteps, "step", spy):
                state, _ = _fit_run(_rest_model(
                    prec, ACC_STEPS, accumulate_grad_batches=2), data,
                    tmp / f"acc_{prec}_{i}", seed=5)
            states.append(_net_tensors(state))
        differ = [k for k in states[0]
                  if not torch.equal(states[0][k], states[1][k])]
        ms, saved = {}, _counts()
        for k in (1, 2, 2, 1):  # in turns, launches not counted
            win = _Window(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
            _fit_run(_rest_model(prec, TRAIN_WARMUP + TRAIN_STEPS,
                                 accumulate_grad_batches=k), data,
                     tmp / f"acc_t_{prec}_{k}", seed=0, on_step=win)
            ms.setdefault(k, []).append(1e3 * win.seconds / TRAIN_STEPS)
        _set_counts(saved)
        say("train_rest", entry="fit", accumulate_grad_batches=2,
            precision=prec, micro_steps=ACC_STEPS,
            runs_bitwise_equal=not differ, updates_checked=check.updates,
            tensors_moved_between_updates=check.moved_between,
            update_vs_adam_on_welford_mean_rel=f"{check.worst_rel:.3g}",
            ms_per_micro_step_k2="/".join(f"{t:.2f}" for t in ms[2]),
            ms_per_step_k1="/".join(f"{t:.2f}" for t in ms[1]),
            card=f"'{card}'")
        # 2 networks x 2 updates in 4 micro-steps
        if differ or check.moved_between or check.updates != 4 \
                or check.worst_rel > 1e-6:
            raise AssertionError(
                f"{prec} accumulation: runs differ in {differ[:5]}, "
                f"{check.moved_between} tensors moved between updates, "
                f"{check.updates} updates, worst {check.worst_rel}")
        rec[f"accumulate_2_{prec}"] = {
            "ms_per_micro_step": sum(ms[2]) / 2,
            "ms_per_step_k1": sum(ms[1]) / 2, "worst_rel": check.worst_rel}

    # (d) the profiler trace of epoch 0, and what it costs
    walls = {}
    for traced in (False, True, True, False):
        extra = {"profile_dir": str(tmp / "trace")} if traced else {}
        _, sec = _fit_run(_rest_model("bf16", 6, **extra), data,
                          tmp / f"prof_{traced}", seed=0)
        walls.setdefault(traced, []).append(sec)
    trace = tmp / "trace" / "epoch_0.pt.trace.json"
    names = [ev.get("name", "") for ev in json.loads(trace.read_text()).get(
        "traceEvents", []) if ev.get("cat") == "kernel"]
    b1_events = sum("instance_norm_act" in n for n in names)
    conv_events = sum(any(s in n.lower() for s in ("conv", "cudnn", "xmma",
                                                    "implicit"))
                      for n in names)
    extra_ms = 1e3 * (min(walls[True]) - min(walls[False]))
    say("train_rest", entry="fit", profile_dir="epoch 0", steps=6,
        trace_bytes=trace.stat().st_size, kernel_events=len(names),
        b1_kernel_events=b1_events, conv_kernel_events=conv_events,
        epoch0_extra_ms=f"{extra_ms:.1f}",
        fit_s_plain="/".join(f"{t:.3f}" for t in walls[False]),
        fit_s_traced="/".join(f"{t:.3f}" for t in walls[True]))
    if not b1_events or not conv_events:
        raise AssertionError(f"the trace names {b1_events} B1 and "
                             f"{conv_events} conv kernels")
    rec["profile"] = {"trace_bytes": trace.stat().st_size,
                      "epoch0_extra_ms": extra_ms}
    launches = dict(zip(("forward", "forward_streaming", "backward",
                         "backward_streaming"), _counts()))
    say("train_rest", **{f"b1_{k}_launches": v for k, v in launches.items()})
    return {"rec": rec, "launches": launches}

# --------------------------------------------------------------- guides

GUIDE_FRAMES = 24               # frames 1-24; frame 0 only feeds the flow
GUIDE_KEYS = [1, 11, 21, 24]    # process_pipeline's pick for 24 frames
GUIDE_SIGMAS = (10.0, 15.0)     # process_pipeline's two guides, radius 10


def _guide_scene(root: Path, n: int = GUIDE_FRAMES + 1, h: int = H,
                 w: int = W) -> Path:
    """``n`` frames ``%03d.png`` of a textured plane (10x10 blocks of
    random colour, numpy seed 11) panning 5 px right and 2 px down a frame,
    with PNG masks of an ellipse that moves with it (255 inside, 0
    outside), as ``tools/imageprocessor.py`` leaves a scene."""
    rng = np.random.default_rng(11)
    big = np.repeat(np.repeat(rng.integers(
        0, 256, ((h + 2 * n) // 10 + 2, (w + 5 * n) // 10 + 2, 3),
        dtype=np.uint8), 10, 0), 10, 1)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sub in ("input", "mask"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        y0, x0 = 2 * (n - i), 5 * (n - i)  # the view moves up-left
        encode_png(root / "input" / f"{i:03d}.png",
                   big[y0:y0 + h, x0:x0 + w], compress_level=1)
        r = ((yy - h * 0.5 - 2 * i) / (h * 0.4)) ** 2 \
            + ((xx - w * 0.4 - 5 * i) / (w * 0.3)) ** 2
        encode_png(root / "mask" / f"{i:03d}.png",
                   np.where(r <= 1, 255, 0).astype(np.uint8),
                   compress_level=1)
    return root


def _load_tool(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _png_diff(a: Path, b: Path, names) -> tuple:
    """(max |d|, differing pixels) over the PNGs ``names`` of two dirs."""
    worst = pixels = 0
    for name in names:
        d = np.abs(decode_png(a / name).astype(int)
                   - decode_png(b / name).astype(int))
        worst, pixels = max(worst, int(d.max())), pixels + int(
            (d.max(axis=-1) > 0).sum())
    return worst, pixels


def _splat_bound(h: int, w: int, points: np.ndarray, sigma: float):
    """(bound ms, "bytes" or "operations", covered pairs): the canvas read
    and written once, the points read once; 17 operations (an exp counted
    as one) for each (pixel, point) pair inside a point's window, counted
    from this frame's points."""
    r = ops_splat.splat_radius(sigma)
    pairs = 0
    for x, y in points.astype(np.float32):
        y0, y1 = ops_splat._window(y, r, h)
        x0, x1 = ops_splat._window(x, r, w)
        pairs += max(0, y1 - y0 + 1) * max(0, x1 - x0 + 1)
    bytes_ms = (2 * h * w * 3 * 4 + len(points) * 21) / HBM_BYTES_PER_S * 1e3
    ops_ms = pairs * 17 / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), pairs


def phase_guides(dev, card: str, tmp: Path) -> dict:
    """The guide-channel tools on the card, without Pillow: the flow tool
    over the scene, ``tools/gaussian_filter_torch.py`` at sigma 10 and 15
    (radius 10, keyframes 1, 11, 21, 24) on the card and with the CPU
    asked for (limit 1 count), the splat kernel against its plain version
    on one frame's points, timed, and ``tools/temporal_guide_torch.py``
    over the scene on the card and the CPU (limit 1 count)."""
    flow_tool = _load_tool("optical_flow_torch")
    gauss = _load_tool("gaussian_filter_torch")
    temporal = _load_tool("temporal_guide_torch")
    scene = _guide_scene(tmp / "guides")
    rec = {}
    with _without_pil():
        t0 = time.perf_counter()
        rc = flow_tool.main([str(scene / "input"), str(scene / "mask"),
                             str(scene / "flow_fwd"), str(scene / "flow_bwd"),
                             "--format", "%03d", "--device", str(dev)])
        torch.cuda.synchronize()
        say("guides", tool="tools/optical_flow_torch.py", rc=rc,
            frames=GUIDE_FRAMES + 1, size=f"{H}x{W}",
            seconds=f"{time.perf_counter() - t0:.2f}")
        if rc != 0:
            raise AssertionError(f"the flow tool failed ({rc})")
        names = [f"{f:03d}.png" for f in range(1, GUIDE_FRAMES + 1)]
        launches = 0
        for sigma in GUIDE_SIGMAS:
            outs, tools = {}, {}
            for device in (str(dev), "cpu"):
                out = scene / (f"gauss_s{int(sigma)}_"
                               f"{'cpu' if device == 'cpu' else 'card'}")
                before = ops_splat.splat_points.launches
                t0 = time.perf_counter()
                tool = gauss.GaussianFilter(
                    mask_dir=scene / "mask", flow_fwd_dir=scene / "flow_fwd",
                    flow_bwd_dir=scene / "flow_bwd", output_dir=out,
                    frame_first=1, frame_last=GUIDE_FRAMES,
                    key_frames=GUIDE_KEYS, radius=10.0, sigma=sigma,
                    device=device)
                tool.process()
                seconds = time.perf_counter() - t0
                outs[device], tools[device] = out, tool
                got = sorted(p.name for p in out.glob("*.png"))
                frame = decode_png(out / names[0])
                say("guides", tool="tools/gaussian_filter_torch.py",
                    sigma=sigma, device=device, frames=len(got),
                    seconds=f"{seconds:.2f}",
                    ms_a_frame=f"{1e3 * seconds / len(got):.2f}",
                    **{f"{k}_ms_a_frame": f"{1e3 * v / len(got):.2f}"
                       for k, v in tool.seconds.items()},
                    splat_launches=ops_splat.splat_points.launches - before,
                    points_at_keys="/".join(str(len(tool.pts[k][f]))
                                            for k, f in enumerate(
                                                GUIDE_KEYS)))
                if got != names or frame.shape != (H, W, 3):
                    raise AssertionError(f"gaussian_filter_torch wrote "
                                         f"{got[:3]}... of {frame.shape}")
                if device != "cpu":
                    launches += ops_splat.splat_points.launches - before
                    rec[f"gauss_s{int(sigma)}_ms_a_frame"] = \
                        1e3 * seconds / len(got)
                    rec[f"gauss_s{int(sigma)}_split_ms_a_frame"] = {
                        k: 1e3 * v / len(got)
                        for k, v in tool.seconds.items()}
            worst, pixels = _png_diff(outs[str(dev)], outs["cpu"], names)
            say("guides", sigma=sigma, card_vs_cpu_max_abs=worst,
                differing_pixels=pixels, limit=1)
            if worst > 1:
                raise AssertionError(f"sigma {sigma}: card vs CPU {worst}")
        if launches != len(names) * len(GUIDE_SIGMAS):
            raise AssertionError(f"{launches} splat launches for "
                                 f"{len(names)} frames x 2 sigmas")

        # the splat kernel against its plain version: keyframe 11's points
        # on its mask, each sigma, bitwise; timed at sigma 15
        tool = tools[str(dev)]
        points = tool.pts[1][GUIDE_KEYS[1]].astype(np.float32)
        n = len(points)
        base = torch.from_numpy(decode_rgb_uint8(
            scene / "mask" / f"{GUIDE_KEYS[1]:03d}.png").astype(np.float32)
            / np.float32(255.0)).to(dev)
        pts = torch.from_numpy(points).to(dev)
        cols = torch.from_numpy(np.asarray(
            [gauss.golden_ratio_color(i) for i in range(n)],
            np.float32)).to(dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        for sigma in GUIDE_SIGMAS:
            saved = ops_splat.splat_points.launches
            got = ops_splat.splat_points(base, pts, cols, valid, sigma)
            want = ops_splat.splat_points_plain(base, pts, cols, valid,
                                                sigma)
            torch.cuda.synchronize()
            ops_splat.splat_points.launches = saved
            err = float((got - want).abs().max())
            bound, bound_by, pairs = _splat_bound(H, W, points, sigma)
            say("guides", kernel="splat_points", sigma=sigma, points=n,
                bitwise_equal=bool(torch.equal(got, want)),
                max_abs_err=f"{err:.3g}", covered_pairs=pairs)
            if not torch.equal(got, want):
                raise AssertionError(f"splat_points differs from its plain "
                                     f"version by {err} (bitwise expected)")
        # device time: at tens of microseconds a launch, back-to-back calls
        # would time the host's ctypes dispatch
        ms = queued_ms([lambda: ops_splat.splat_points(base, pts, cols, valid,
                                                       15.0)], 20)
        plain = time_ms(lambda: ops_splat.splat_points_plain(
            base, pts, cols, valid, 15.0), 2)
        ops_splat.splat_points.launches = saved
        say("guides", kernel="splat_points", sigma=15.0, points=n,
            frame=f"{H}x{W}", ms=f"{ms:.4f}", plain_ms=f"{plain:.2f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            share_of_bound=f"{bound / ms:.3f}", library="none: no single "
            "PyTorch call composites ordered alpha blobs", card=f"'{card}'")
        rec["splat"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": None, "points": n,
                        "covered_pairs": pairs, "launches": launches}

        # the temporal guide over the scene: the input frames stand in for
        # the stylized ones (guide i = input i-1 warped by flow_bwd i)
        outs = {}
        for device in (str(dev), "cpu"):
            out = scene / f"temporal_{'cpu' if device == 'cpu' else 'card'}"
            t0 = time.perf_counter()
            rc = temporal.main([str(scene / "input"), str(scene / "input"),
                                str(scene / "flow_bwd"), str(out),
                                "--device", device])
            seconds = time.perf_counter() - t0
            outs[device] = out
            say("guides", tool="tools/temporal_guide_torch.py",
                device=device, rc=rc, frames=GUIDE_FRAMES + 1,
                ms_a_frame=f"{1e3 * seconds / (GUIDE_FRAMES + 1):.2f}")
            if rc != 0:
                raise AssertionError(f"temporal_guide_torch failed ({rc})")
        tnames = [f"{i:03d}.png" for i in range(GUIDE_FRAMES + 1)]
        worst, pixels = _png_diff(outs[str(dev)], outs["cpu"], tnames)
        say("guides", temporal_card_vs_cpu_max_abs=worst,
            differing_pixels=pixels, limit=1)
        if worst > 1:
            raise AssertionError(f"temporal guide: card vs CPU {worst}")
    return {"rec": rec, "launches": launches}


# -------------------------------------------------------------- pipeline

PIPE_FRAMES = 12                 # frames 001-012 of a 1080p shot
PIPE_H, PIPE_W = 1080, 1920
PIPE_WIDTH = 910                 # --resize-value: 511x910 frames
PIPE_FIXTURES = REPO / "tests" / "data" / "jpeg"


def _pipeline_scene(root: Path, n: int = PIPE_FRAMES, h: int = PIPE_H,
                    w: int = PIPE_W) -> Path:
    """A shot as a user hands it to ``tools/process_pipeline_torch.py``:
    ``input/%03d.png`` (1-based) RGBA frames of a textured plane (10x10
    blocks of random colour, numpy seed 13) panning 9 px right and 4 px
    down a frame, under an alpha ellipse that moves with it (255 inside,
    0 outside); ``output/`` RGB companions (each frame upside down) and
    ``tracking/`` 3-band guides (another block texture, seed 14). All
    written by the port's PNG encoder."""
    rng = np.random.default_rng(13)
    big = np.repeat(np.repeat(rng.integers(
        0, 256, ((h + 4 * n) // 10 + 2, (w + 9 * n) // 10 + 2, 3),
        dtype=np.uint8), 10, 0), 10, 1)
    track = np.repeat(np.repeat(np.random.default_rng(14).integers(
        0, 256, (h // 10 + 1, w // 10 + 1, 3), dtype=np.uint8), 10, 0),
        10, 1)[:h, :w]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sub in ("input", "output", "tracking"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(1, n + 1):
        y0, x0 = 4 * (n - i), 9 * (n - i)  # the view moves up-left
        rgb = big[y0:y0 + h, x0:x0 + w]
        r = ((yy - h * 0.5 - 4 * i) / (h * 0.38)) ** 2 \
            + ((xx - w * 0.42 - 9 * i) / (w * 0.3)) ** 2
        alpha = np.where(r <= 1, 255, 0).astype(np.uint8)
        name = f"{i:03d}.png"
        encode_png(root / "input" / name, np.dstack([rgb, alpha]),
                   compress_level=1)
        encode_png(root / "output" / name, rgb[::-1], compress_level=1)
        encode_png(root / "tracking" / name, track, compress_level=1)
    return root


def _pipeline_fixtures() -> dict:
    """The codec against the committed fixtures (Pillow's files, made on a
    machine with Pillow): each baseline JPEG decoded to Pillow's pixels,
    ``src.png`` encoded to Pillow's quality-95 bytes."""
    jpegs = sorted(PIPE_FIXTURES.glob("*.jpg"))
    decoded = [p.name for p in jpegs if p.stem != "src_q95"]
    for name in decoded:
        got = decode_native(PIPE_FIXTURES / name)
        want = decode_png(PIPE_FIXTURES / name.replace(".jpg", ".png"))
        if not np.array_equal(got, want):
            raise AssertionError(f"fixture {name}: the codec's pixels are "
                                 f"not Pillow's")
    with tempfile.TemporaryDirectory() as t:
        encode_jpeg(Path(t) / "o.jpg", decode_png(PIPE_FIXTURES / "src.png"),
                    95)
        same = (Path(t) / "o.jpg").read_bytes() == (
            PIPE_FIXTURES / "src_q95.jpg").read_bytes()
    if not same:
        raise AssertionError("fixture src.png: the codec's quality-95 JPEG "
                             "is not Pillow's bytes")
    return {"decoded_bitwise": decoded, "encoded_bytewise": ["src_q95.jpg"]}


def _decode_ms(path: Path, reps: int = 15) -> float:
    """Median host ms of one native decode of ``path`` (warm cache)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        decode_native(path)
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def phase_pipeline(dev, card: str, tmp: Path) -> dict:
    """The guide pipeline without Pillow on a 1080p shot
    (``_pipeline_scene``): ``tools/process_pipeline_torch.py``'s
    ``process_pipeline`` at ``--resize-mode width --resize-value 910``
    (511x910 frames), the flow and the splats on the card. Checks: the
    C++ resize bitwise its numpy plain version on one frame (L and RGB);
    the codec against the committed Pillow fixtures; the guides within 1
    count of the same tool with the CPU asked for, on the same flows; the
    native JPEG decodes the number of JPEG files the steps read, no PIL
    decode. Then ``process_directory`` serves the prepared scene (JPEG
    frames under .png names, ``mask/*.jpg``, ``gauss_r10_s10`` as the
    3-band guide) at bf16, tiled: 19 B1 cluster launches a group and one
    B2 launch, the output outside each mask its input within 1 count."""
    pipe = _load_tool("process_pipeline_torch")
    src = _pipeline_scene(tmp / "shot")
    out = tmp / "prepared"
    rec = {}
    with _without_pil():
        # the C++ resize against its plain version on frame 1
        frame = decode_png(src / "input" / "001.png")
        oh = int(PIPE_WIDTH * PIPE_H / PIPE_W)
        for name, arr in (("rgb", frame[..., :3]), ("l", frame[..., 3])):
            t0 = time.perf_counter()
            got = resize_lanczos(arr, PIPE_WIDTH, oh)
            ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            want = resample.resize_lanczos(arr, PIPE_WIDTH, oh)
            plain_ms = 1e3 * (time.perf_counter() - t0)
            say("pipeline", resize=name, size=f"{PIPE_H}x{PIPE_W}->"
                f"{oh}x{PIPE_WIDTH}", bitwise_plain=bool(
                    np.array_equal(got, want)), ms=f"{ms:.1f}",
                plain_ms=f"{plain_ms:.1f}")
            if not np.array_equal(got, want):
                raise AssertionError(f"resize {name}: the C++ resize differs "
                                     f"from data/resample.py")
        rec["fixtures"] = _pipeline_fixtures()
        say("pipeline", fixtures_decoded_bitwise=len(
            rec["fixtures"]["decoded_bitwise"]), fixture_encoded_bytewise=1)

        # the pipeline, the flow and the splats on the card
        zero_decode_counts()
        before = ops_splat.splat_points.launches
        t0 = time.perf_counter()
        seconds = pipe.process_pipeline(
            str(src), str(out), resize_mode="width", resize_value=PIPE_WIDTH,
            device=str(dev))
        total = time.perf_counter() - t0
        splats = ops_splat.splat_points.launches - before
        counts = decode_counts()
        keys = list(range(1, PIPE_FRAMES + 1, 10)) + [PIPE_FRAMES]
        names = [f"{i:03d}.png" for i in range(1, PIPE_FRAMES + 1)]
        # JPEG files the steps read: the flow's frames and masks 1..n-1;
        # a guide run's first keyframe mask, its keyframes' masks, every
        # frame's mask
        want_jpeg = PIPE_FRAMES + PIPE_FRAMES - 1 + 2 * (
            1 + len(keys) + PIPE_FRAMES)
        per = {k: v / PIPE_FRAMES for k, v in seconds.items()}
        rec["seconds_a_frame"] = per
        rec["decodes"] = counts
        say("pipeline", tool="tools/process_pipeline_torch.py",
            frames=PIPE_FRAMES, size=f"{PIPE_H}x{PIPE_W}->{oh}x{PIPE_WIDTH}",
            seconds=f"{total:.2f}",
            **{f"{k}_s_a_frame": f"{v:.4f}" for k, v in per.items()},
            png_decodes=counts["png"], jpeg_decodes=counts["jpeg"],
            pil_decodes=counts["pil"], splat_launches=splats,
            card=f"'{card}'")
        if counts != {"png": 3 * PIPE_FRAMES, "jpeg": want_jpeg, "pil": 0}:
            raise AssertionError(f"decodes {counts}: expected "
                                 f"{3 * PIPE_FRAMES} PNG, {want_jpeg} JPEG, "
                                 f"no PIL")
        if splats != 2 * PIPE_FRAMES:
            raise AssertionError(f"{splats} splat launches for "
                                 f"{PIPE_FRAMES} frames x 2 sigmas")
        with open(out / "input" / names[0], "rb") as f:
            if f.read(2) != b"\xff\xd8":
                raise AssertionError("input/ does not hold JPEG bytes")
        for sub in ("gauss_r10_s10", "gauss_r10_s15"):
            got = sorted(p.name for p in (out / sub).glob("*.png"))
            if got != names or decode_png(out / sub / names[0]).shape != (
                    oh, PIPE_WIDTH, 3):
                raise AssertionError(f"{sub}: {got[:3]}...")

        # the codec's decode of one prepared frame: JPEG against PNG
        frame = decode_native(out / "input" / names[0])
        encode_png(tmp / "frame.png", frame)
        jpeg_ms = _decode_ms(out / "input" / names[0])
        png_ms = _decode_ms(tmp / "frame.png")
        rec["decode_ms"] = {"jpeg": jpeg_ms, "png": png_ms}
        say("pipeline", decode_one=f"{oh}x{PIPE_WIDTH}",
            jpeg_ms=f"{jpeg_ms:.3f}", png_zlib6_ms=f"{png_ms:.3f}",
            card=f"'{card}'")

        # the same guide tool with the CPU asked for, on the same flows
        for sigma in (10, 15):
            cpu = tmp / f"gauss_s{sigma}_cpu"
            pipe.GaussianFilter(
                mask_dir=out / "mask", flow_fwd_dir=out / "flow_fwd",
                flow_bwd_dir=out / "flow_bwd", output_dir=cpu,
                frame_first=1, frame_last=PIPE_FRAMES, key_frames=keys,
                radius=10.0, sigma=float(sigma), device="cpu").process()
            worst, pixels = _png_diff(out / f"gauss_r10_s{sigma}", cpu, names)
            rec[f"guides_s{sigma}_card_vs_cpu"] = worst
            say("pipeline", sigma=sigma, card_vs_cpu_max_abs=worst,
                differing_pixels=pixels, limit=1)
            if worst > 1:
                raise AssertionError(f"guides sigma {sigma}: card vs CPU "
                                     f"{worst}")

        # serving the prepared scene
        served = tmp / "prepared_served"
        eng = StyleTransferInference(inference_config(
            paths={"checkpoint": str(CKPT), "input_dir": str(out / "input"),
                   "mask_dir": str(out / "mask"), "output_dir": str(served),
                   "additional_channels": {"point_vector": {
                       "path": str(out / "gauss_r10_s10"), "depth": 3}}},
            inference={"precision": "bf16", "mode": "tiled"}))
        zero_decode_counts()
        run = _transport_run(eng, PIPE_FRAMES)
        counts = decode_counts()
        groups, launches = len(run["groups"]), run["counts"]
        want = {"cluster": 19 * groups, "resident": 0, "split": 0,
                "sample": 0, "streaming": 0, "blend": groups}
        worst = 0
        for name in names:
            got = decode_png(served / name)
            inp = decode_native(out / "input" / name)
            outside = decode_native(out / "mask" / name.replace(
                ".png", ".jpg"))[..., 0] <= 128
            if got.shape != (oh, PIPE_WIDTH, 3):
                raise AssertionError(f"served {name}: {got.shape}")
            worst = max(worst, int(np.abs(got[outside].astype(int)
                                          - inp[outside]).max()))
        rec["serve"] = {"groups": groups, "launches": launches,
                        "seconds": run["seconds"], "decodes": counts}
        say("pipeline", served=PIPE_FRAMES, groups=groups,
            b1_cluster_launches=launches["cluster"],
            blend_launches=launches["blend"],
            eq_frames_per_s=f"{PIPE_FRAMES / run['seconds']:.2f}",
            jpeg_decodes=counts["jpeg"], png_decodes=counts["png"],
            pil_decodes=counts["pil"], outside_mask_max_abs=worst, limit=1)
        if launches != want or counts["pil"] or worst > 1:
            raise AssertionError(f"serving the prepared scene: launches "
                                 f"{launches} (want {want}), PIL decodes "
                                 f"{counts['pil']}, outside the masks "
                                 f"{worst} counts")
    return {"rec": rec, "splat": splats, "cluster": launches["cluster"],
            "blend": launches["blend"]}


# ------------------------------------------------------------ multi_gpu

MG_LINK_BPS = 25e9    # NVLink 4, bytes/s a link and direction (data sheet)
MG_PCIE_BPS = 64e9    # PCIe Gen5 x16, bytes/s a direction (data sheet)
MG_PARITY_BATCH = 8   # the N-rank step against fp64: small widths, batch 8


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _link_bps() -> tuple:
    """(bytes/s a direction between card 0 and card 1, what nvidia-smi
    shows there): ``topo -m``'s NV<k> is k NVLink 4 links, another entry
    PCIe Gen5 x16; where ``topo -m`` fails, the sum of the link rates
    ``nvlink --status`` lists for card 0 (a rate a link and direction)."""
    def smi(*args):
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=60, check=True).stdout

    try:
        for line in smi("topo", "-m").splitlines():
            cells = line.split()
            if cells and cells[0] == "GPU0" and len(cells) > 2:
                link = cells[2]
                if link.startswith("NV") and link[2:].isdigit():
                    return int(link[2:]) * MG_LINK_BPS, link
                return MG_PCIE_BPS, link
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        rates = [float(r) for r in re.findall(
            r"Link \d+: ([\d.]+) GB/s", smi("nvlink", "--status", "-i", "0"))]
    except (OSError, subprocess.SubprocessError):
        rates = []
    if rates:
        return sum(rates) * 1e9, f"NVLink-x{len(rates)}-{rates[0]}GB/s"
    return MG_PCIE_BPS, "unknown"


B1_B2 = {**B1_WRAPPERS, "blend": blend.blend_tiles}


def _zero_by_device() -> None:
    for fn in B1_B2.values():
        fn.launches = 0
        fn.by_device = {}


def _busy_by_device(fn) -> dict:
    """``fn()`` under ``torch.profiler``: each card's busy time (the union
    of its kernels' and copies' intervals) over the wall time, by card
    index."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    _sync_all()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync_all()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(int(getattr(ev, "device_index", 0)), []).append(
                (ev.time_range.start, ev.time_range.end))
    busy = {}
    for i, ivs in sorted(spans.items()):  # the union of the intervals
        total, end = 0.0, float("-inf")
        for a, b in sorted(ivs):
            if b > end:
                total += b - max(a, end)
                end = b
        busy[i] = total / wall_us
    return busy


def _mg_engine(prec: str, mode: str, scene: Path, out: Path,
               devices: int = 1, shard=None):
    inf = {"precision": prec, "mode": mode, "devices": devices}
    if shard is not None:
        inf["file_shard"] = shard
    return StyleTransferInference(inference_config(
        paths={"checkpoint": str(CKPT), "input_dir": str(scene / "input"),
               "mask_dir": str(scene / "mask"), "output_dir": str(out),
               "additional_channels": {"point_vector": {
                   "path": str(scene / "tracking"), "depth": 3}}},
        inference=inf))


def _mg_serve(prec: str, mode: str, devices: int, scene: Path, out: Path,
              busy: bool) -> dict:
    """A set-up run, then ``process_directory`` timed with the launch
    counters zeroed just before and read just after (by card), checked
    against the one-device rule on every card; with ``busy`` a third,
    traced run gives each card's busy share."""
    eng = _mg_engine(prec, mode, scene, out, devices)
    eng.process_directory()
    _zero_by_device()
    _sync_all()
    t0 = time.perf_counter()
    written = eng.process_directory()
    _sync_all()
    seconds = time.perf_counter() - t0
    by_card = {k: dict(fn.by_device) for k, fn in B1_B2.items()}
    d = len(eng.cards)
    per_card = DIR_FRAMES // d  # frames a card: 36 over 1, 2 or 4
    calls = per_card // 3 if mode == "tiled" else per_card  # fpd 3
    want = _want_counts(calls, mode == "tiled", prec)
    for kind, n in want.items():
        for card in eng.cards:
            if by_card[kind].get(card.index, 0) != n:
                raise AssertionError(
                    f"multi_gpu {mode} {prec} D={d}: {kind} launches by "
                    f"card {by_card[kind]}, expected {n} on each of "
                    f"{[c.index for c in eng.cards]}")
    if written != DIR_FRAMES:
        raise AssertionError(f"multi_gpu {mode} {prec} D={d}: {written} "
                             "frames written")
    rec = {"devices": d, "eq_frames_per_s": DIR_FRAMES / seconds,
           "ms": 1e3 * seconds, "launches_by_card": by_card}
    if busy:
        try:
            rec["busy_by_card"] = _busy_by_device(eng.process_directory)
        except (AttributeError, RuntimeError) as e:
            rec["busy_by_card"] = f"not measured ({e})"
    return rec


def _mg_fit_rank(device, out: str, runs: list, parity: bool,
                 flags: tuple) -> None:
    """One rank of the multi_gpu phase's training (``parallel.spawn``, the
    launcher ``train_cli`` uses): ``fit`` on the train phase's keyframes
    at batch 80 over the world, for each (precision, repeat) of ``runs``
    (steps 3-12 timed, the launch counters zeroed after step 2 and read
    after step 12; the final parameters saved); the gradients' all-reduce
    timed on tensors of their shapes; with ``parity`` one small-width step
    held to the fp64 one-device step (rank 0). ``flags``: the parent's
    TF32 and matmul settings, so a rank computes as the parent's plain
    ``fit`` does. Writes rank<r>.json."""
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     precision) = flags
    torch.set_float32_matmul_precision(precision)
    rank, world = parallel.rank(), parallel.world()
    out = Path(out)
    frames, pres, posts, masks, guides = _keyframes()
    data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, device=device)
    rec = {"rank": rank, "world": world, "device": str(device),
           "name": torch.cuda.get_device_name(device), "runs": []}
    state = None
    for prec, rep, batch in runs:
        model = _train_model(prec, batch=batch,
                             max_steps=TRAIN_WARMUP + TRAIN_STEPS)
        win = _Window(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
        state = fit(model, data, str(out / f"run_w{world}_{prec}_{rep}"
                                     f"_{batch}"),
                    seed=0, on_step=win, progress=False)
        fwd, st, bwd, bst = win.counts
        if batch == BT:
            torch.save(_net_tensors(state),
                       out / f"w{world}_{prec}_{rep}_rank{rank}.pt")
        rec["runs"].append({
            "precision": prec, "repeat": rep, "batch": batch,
            "ms_per_step": 1e3 * win.seconds / TRAIN_STEPS,
            "forward_cluster": fwd, "forward_streaming": st,
            "backward_cluster": bwd, "backward_streaming": bst,
            "g_total_loss": float(win.metrics["g_total_loss"])})
    if world > 1:  # the step's two gradient all-reduces, G's then D's
        grads = [[torch.randn_like(p) for p in net.parameters()]
                 for net in (state.generator, state.discriminator)]

        def reduce():
            for g in grads:
                parallel.all_reduce_mean_(g)

        rec["allreduce_ms"] = time_ms(reduce, 20, warmup=3)
        rec["allreduce_bytes"] = sum(4 * t.numel() for g in grads for t in g)
        rec["params"] = [sum(t.numel() for t in g) for g in grads]
    if parity:
        rec["parity"] = _mg_step_parity(device)
    (out / f"rank{rank}_w{world}.json").write_text(json.dumps(rec))


def _mg_step_parity(device):
    """The N-rank step, small widths and batch ``MG_PARITY_BATCH``, each
    rank on its rows, its branches recorded and gathered in rank order;
    rank 0 replays them in the fp64 one-device step over the whole batch
    (``train/parity.py``) and holds its state to it: within 5e-5, the bar
    that holds one card."""
    rank, world = parallel.rank(), parallel.world()
    model = _train_model("32", small=True, batch=MG_PARITY_BATCH)
    rng = np.random.default_rng(1)
    b, ps = MG_PARITY_BATCH, 32
    batch = {"pre": rng.standard_normal((b, ps, ps, 3)),
             "channels": rng.standard_normal((b, ps, ps, 3)),
             "post": rng.random((b, ps, ps, 3)) * 2 - 1}
    rows = parallel.shard_rows(b, rank, world)
    with training_backends(torch.float32):
        start = model.init_state(0, "cpu")
        kinks = Kinks()
        st, _ = run_step(model, start, {k: v[rows] for k, v in
                                        batch.items()}, device, kinks)
        masks = [parallel.gather_rows(m.to(device, torch.uint8)).bool()
                 .cpu() for m in kinks.masks]
        summary = None
        if rank == 0:
            with _patched(comm, "rank", lambda: 0), \
                    _patched(comm, "world", lambda: 1):
                ref, _ = run_step(model, start, batch, "cpu",
                                  Kinks(replay=masks), torch.float64)
            summary = first_step_agreement(state_pairs(ref, st))
            assert_first_step_close(summary, 5e-5,
                                    f"{world} ranks against fp64")
        parallel.barrier()
    return summary


def _mg_train(tmp: Path, worlds: list, plain: dict) -> dict:
    """``fit`` over 1, 2 and 4 ranks (those that fit): ms a step, the
    launches of each rank, ranks bitwise equal, two runs of the largest
    world bitwise equal, world 1 bitwise the plain ``fit`` of the train
    phase (``plain``), the largest world against world 1 (the update's
    relative L2 distance; limits 1e-1 at 32, 5e-1 at bf16), the
    all-reduce against its bound, and the N-rank step against fp64."""
    link_bps, link = _link_bps()
    rec = {"link": link, "link_bytes_per_s": link_bps}
    top = max(worlds)
    for n in worlds:
        out = tmp / f"mg_train_w{n}"
        out.mkdir(parents=True, exist_ok=True)
        runs = [("32", 0, BT), ("bf16", 0, BT)]
        if n == top and n > 1:  # determinism: a second run of each
            runs += [("32", 1, BT), ("bf16", 1, BT)]
        if n == 1 and top > 1:  # one card at the rows a rank takes
            runs += [(prec, 0, BT // m) for m in worlds[1:]
                     for prec in ("32", "bf16")]
        t0 = time.perf_counter()
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32,
                 torch.get_float32_matmul_precision())
        parallel.spawn(_mg_fit_rank, (str(out), runs, n > 1, flags),
                       parallel.local_devices(n))
        wall = time.perf_counter() - t0
        ranks = [json.loads((out / f"rank{r}_w{n}.json").read_text())
                 for r in range(n)]
        for r in ranks:
            for run in r["runs"]:
                if run["forward_cluster"] != 25 * TRAIN_STEPS \
                        or run["backward_cluster"] != 25 * TRAIN_STEPS \
                        or run["forward_streaming"] \
                        or run["backward_streaming"]:
                    raise AssertionError(f"world {n} rank {r['rank']}: B1 "
                                         f"launches {run}")
        tensors = {(prec, rep, r): torch.load(
            out / f"w{n}_{prec}_{rep}_rank{r}.pt", weights_only=True)
            for prec, rep, batch in runs if batch == BT for r in range(n)}
        rank_differ = [f"{prec}/{rep}/rank{r}/{k}"
                       for (prec, rep, r), t in tensors.items()
                       for k in t if not torch.equal(
                           t[k], tensors[prec, rep, 0][k])]
        rep_differ = [f"{prec}/{k}" for prec in ("32", "bf16")
                      if (prec, 1, 0) in tensors
                      for k in tensors[prec, 0, 0] if not torch.equal(
                          tensors[prec, 0, 0][k], tensors[prec, 1, 0][k])]
        w = {"ranks": n, "spawn_and_fit_s": wall,
             "rank_differing_tensors": len(rank_differ),
             "repeat_differing_tensors": len(rep_differ) if n == top
             and n > 1 else None,
             "per_rank": {r["rank"]: {
                 f"{run['precision']}_{run['repeat']}_b{run['batch']}":
                 {k: run[k] for k in ("ms_per_step", "forward_cluster",
                                      "backward_cluster")}
                 for run in r["runs"]} for r in ranks},
             "cards": sorted({r["name"] for r in ranks})}
        for prec in ("32", "bf16"):
            w[f"ms_per_step_{prec}"] = max(
                run["ms_per_step"] for r in ranks for run in r["runs"]
                if run["precision"] == prec and run["repeat"] == 0
                and run["batch"] == BT)
            for run in ranks[0]["runs"]:
                if run["precision"] == prec and run["batch"] != BT:
                    w[f"one_card_ms_per_step_{prec}_b{run['batch']}"] = \
                        run["ms_per_step"]
        if n == 1:
            differ = [f"{prec}/{k}" for prec in ("32", "bf16")
                      for k in plain[prec] if not torch.equal(
                          plain[prec][k], tensors[prec, 0, 0][k])]
            w["vs_plain_fit_differing_tensors"] = len(differ)
            if differ:
                raise AssertionError(f"fit on one spawned rank differs from "
                                     f"the plain fit in {differ[:5]}")
        else:
            r0 = ranks[0]
            size = r0["allreduce_bytes"]
            bound = 2 * (n - 1) / n * size / link_bps * 1e3
            w.update(allreduce_ms=r0["allreduce_ms"], allreduce_bytes=size,
                     params=r0["params"], allreduce_bound_ms=bound,
                     parity=r0["parity"])
        rec[f"w{n}"] = w
        say("multi_gpu", train_ranks=n,
            ms_per_step_32=f"{w['ms_per_step_32']:.2f}",
            ms_per_step_bf16=f"{w['ms_per_step_bf16']:.2f}",
            rank_differing_tensors=len(rank_differ),
            repeat_differing_tensors=w["repeat_differing_tensors"],
            vs_plain_fit_differing_tensors=w.get(
                "vs_plain_fit_differing_tensors"),
            allreduce_ms=f"{w.get('allreduce_ms', 0):.4f}",
            allreduce_bytes=w.get("allreduce_bytes"),
            allreduce_bound_ms=f"{w.get('allreduce_bound_ms', 0):.4f}",
            link=link, parity_grad_rel_l2=(
                f"{w['parity']['grad_rel_l2']:.3g}" if w.get("parity")
                else None),
            launches_per_rank=json.dumps({
                r: {k: v["forward_cluster"] for k, v in runs_.items()}
                for r, runs_ in w["per_rank"].items()}).replace(" ", ""),
            one_card_at_rank_rows=json.dumps({
                k: round(v, 2) for k, v in w.items()
                if k.startswith("one_card_ms")}).replace(" ", ""),
            spawn_and_fit_s=f"{wall:.1f}", cards=w["cards"])
        if rank_differ or rep_differ:
            raise AssertionError(f"world {n}: ranks differ in "
                                 f"{rank_differ[:5]}, repeats in "
                                 f"{rep_differ[:5]}")
    if top > 1:  # the largest world against one rank after 12 steps
        for prec, limit in (("32", 1e-1), ("bf16", 5e-1)):
            one = torch.load(tmp / "mg_train_w1" / f"w1_{prec}_0_rank0.pt",
                             weights_only=True)
            many = torch.load(tmp / f"mg_train_w{top}" /
                              f"w{top}_{prec}_0_rank0.pt", weights_only=True)
            start = _net_tensors(_train_model(prec).init_state(0, "cpu"))
            num = sum(float(torch.sum((many[k] - one[k]) ** 2))
                      for k in one if k in start)
            den = sum(float(torch.sum((one[k] - start[k]) ** 2))
                      for k in one if k in start)
            rel = (num / den) ** 0.5 if den else 0.0
            rec[f"w{top}_vs_w1_update_rel_l2_{prec}"] = rel
            say("multi_gpu", train=f"{top} ranks against 1 after "
                f"{TRAIN_WARMUP + TRAIN_STEPS} steps", precision=prec,
                update_rel_l2=f"{rel:.3g}", limit=limit)
            if rel > limit:
                raise AssertionError(f"{top} ranks against 1 at {prec}: "
                                     f"{rel} (limit {limit})")
    return rec


MG_SHARD_SERVICE = r"""
import json, sys, time
from pathlib import Path
import torch
from patch_toon_tpu_torch.config.defaults import inference_config
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
paths, shard, ready, n = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
eng = StyleTransferInference(inference_config(paths=paths, inference={
    "precision": "bf16", "file_shard": shard}))
eng.process_directory()
Path(ready, shard.replace("/", "_")).touch()
while len(list(Path(ready).iterdir())) < n:
    time.sleep(0.01)
torch.cuda.synchronize()
t0 = time.perf_counter()
written = eng.process_directory()
torch.cuda.synchronize()
print(json.dumps({"shard": shard, "written": written,
                  "seconds": time.perf_counter() - t0,
                  "device": str(eng.device)}))
"""


def _mg_shard_processes(n: int, scene: Path, out: Path, ref: Path,
                        tmp: Path, names) -> dict:
    """``n`` processes with ``file_shard`` k/n, one card each
    (``CUDA_VISIBLE_DEVICES``), tiled bf16: a set-up run, a start
    barrier, a timed run; eq-frames/s over the slowest, and the union of
    their files against the one-process run."""
    ready = tmp / f"mg_ready_{n}"
    ready.mkdir()
    paths = {"checkpoint": str(CKPT), "input_dir": str(scene / "input"),
             "mask_dir": str(scene / "mask"), "output_dir": str(out),
             "additional_channels": {"point_vector": {
                 "path": str(scene / "tracking"), "depth": 3}}}
    procs = [subprocess.Popen(
        [sys.executable, "-c", MG_SHARD_SERVICE, json.dumps(paths),
         f"{k}/{n}", str(ready), str(n)], cwd=str(REPO),
        env={**os.environ, "CUDA_VISIBLE_DEVICES": str(k),
             "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k in range(n)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"a file_shard process failed: {se[-3000:]}")
    recs = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
    worst, differ = _compare_dirs(out, ref, names)
    slowest = max(r["seconds"] for r in recs)
    rec = {"processes": n, "eq_frames_per_s": DIR_FRAMES / slowest,
           "seconds_by_shard": {r["shard"]: r["seconds"] for r in recs},
           "written": sum(r["written"] for r in recs),
           "vs_one_process_max_abs": worst, "differing_pixels": differ}
    say("multi_gpu", file_shard_processes=n,
        eq_frames_per_s=f"{rec['eq_frames_per_s']:.2f}",
        written=rec["written"], vs_one_process_max_abs=worst,
        differing_pixels=differ)
    if rec["written"] != DIR_FRAMES or worst > 1:
        raise AssertionError(f"file_shard processes: {rec}")
    return rec


def _mg_int8(tmp: Path, scene: Path, names) -> dict:
    """int8 serving over 2 cards (``inference.devices=2``, tiled, bf16)
    bitwise the one-card int8 run, every replica with card 0's scales;
    launches of each int8 kernel by card."""
    runs = {}
    for d in (1, 2):
        out = tmp / f"mg_int8_d{d}"
        eng = _dir_engine("bf16", scene, out, quantize="int8", devices=d)
        eng.process_directory()  # set-up and calibration
        for fn in QUANT_WRAPPERS.values():
            fn.by_device.clear()
        _sync_all()
        t0 = time.perf_counter()
        written = eng.process_directory()
        _sync_all()
        seconds = time.perf_counter() - t0
        by_card = {k: dict(fn.by_device) for k, fn in QUANT_WRAPPERS.items()}
        scales = [{p: float(layer.a_scale) for p, layer
                   in m.quant_layers().items()} for m in eng.models]
        runs[d] = {"eq_frames_per_s": DIR_FRAMES / seconds,
                   "launches_by_card": by_card, "scales": scales,
                   "written": written}
    worst, differ = _compare_dirs(tmp / "mg_int8_d2", tmp / "mg_int8_d1",
                                  names)
    same_scales = all(s == runs[1]["scales"][0] for s in runs[2]["scales"])
    say("multi_gpu", int8="tiled bf16", devices=2,
        eq_frames_per_s=f"{runs[2]['eq_frames_per_s']:.2f}",
        one_card_eq_frames_per_s=f"{runs[1]['eq_frames_per_s']:.2f}",
        launches_by_card=json.dumps(runs[2]["launches_by_card"]).replace(
            " ", ""), vs_one_device_max_abs=worst, differing_pixels=differ,
        replicas_share_card0_scales=same_scales)
    if worst or not same_scales or runs[2]["written"] != DIR_FRAMES \
            or len(runs[2]["launches_by_card"]["conv_s8"]) != 2:
        raise AssertionError(f"int8 over 2 cards: {worst} counts from one "
                             f"card, scales shared {same_scales}, launches "
                             f"{runs[2]['launches_by_card']}")
    for r in runs.values():
        del r["scales"]
    return {"runs": runs, "launches": {
        k: sum(sum(r["launches_by_card"][k].values()) for r in runs.values())
        for k in QUANT_WRAPPERS}}


def phase_multi_gpu(tmp: Path, plain_fit=None) -> dict:
    """Several cards through the entry points (see the module's
    docstring): on any card count, ``process_directory`` at
    ``inference.devices=-1`` (tiled, bf16 and 32) bitwise the one-device
    run, two ``file_shard`` engines whose union is bitwise the one-device
    run, and ``fit`` on ``training.devices=-1`` ranks bitwise the plain
    ``fit``; with 2+ cards the 2- and 4-card forms."""
    count = torch.cuda.device_count()
    cards = card_lines()
    for line in cards:
        say("multi_gpu", card=f"'{line}'")
    say("multi_gpu", cards=count, link=_link_bps()[1],
        peer_access_0_1=torch.cuda.can_device_access_peer(0, 1)
        if count > 1 else None)
    scene = tmp / "scene"
    if not (scene / "input").exists():
        write_scene(scene, DIR_FRAMES, H, W)
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    rec = {"cards": count, "card_lines": cards, "serve": {}}
    launches = dict.fromkeys(LAUNCH_KINDS, 0)
    ds = [d for d in (2, 4) if d <= count]
    modes = ("tiled", "fullframe") if ds else ("tiled",)
    with _without_pil():
        for mode in modes:
            for prec in ("bf16", "32"):
                ref = tmp / f"mg_{mode}_{prec}_d1"
                one = _mg_serve(prec, mode, 1, scene, ref, busy=bool(ds))
                runs = {1: one}
                for d in ([-1] if not ds else []) + ds:
                    out = tmp / f"mg_{mode}_{prec}_d{d}"
                    r = runs[d] = _mg_serve(prec, mode, d, scene, out,
                                            busy=bool(ds))
                    worst, differ = _compare_dirs(out, ref, names)
                    r.update(vs_one_device_max_abs=worst,
                             differing_pixels=differ)
                    for k in launches:
                        launches[k] += sum(r["launches_by_card"][k].values())
                    say("multi_gpu", mode=mode, precision=prec,
                        devices=d, cards=r["devices"],
                        eq_frames_per_s=f"{r['eq_frames_per_s']:.2f}",
                        one_card_eq_frames_per_s=
                        f"{one['eq_frames_per_s']:.2f}",
                        busy_by_card=json.dumps(r.get("busy_by_card"))
                        .replace(" ", ""),
                        launches_by_card=json.dumps(r["launches_by_card"])
                        .replace(" ", ""),
                        vs_one_device_max_abs=worst,
                        differing_pixels=differ)
                    if (d == -1 and worst) or worst > 1:
                        raise AssertionError(
                            f"{mode} {prec} devices={d}: {worst} counts "
                            f"from the one-device run ({differ} pixels; "
                            "limit 0 on one card, 1 over several)")
                rec["serve"][f"{mode}_{prec}"] = runs
        # two file_shard engines on one card: their union is the run
        out = tmp / "mg_shard"
        written = 0
        _zero_by_device()
        for k in range(2):
            written += _mg_engine("bf16", "tiled", scene, out,
                                  shard=f"{k}/2").process_directory()
        for k in launches:
            launches[k] += B1_B2[k].launches
        worst, differ = _compare_dirs(out, tmp / "mg_tiled_bf16_d1", names)
        rec["file_shard_engines"] = {"written": written, "max_abs": worst,
                                     "differing_pixels": differ}
        say("multi_gpu", file_shard_engines="0/2 and 1/2", written=written,
            vs_one_device_max_abs=worst, differing_pixels=differ)
        if written != DIR_FRAMES or worst:
            raise AssertionError(f"file_shard union: {written} frames, "
                                 f"{worst} counts from the one-device run")
        int8_launches = dict.fromkeys(QUANT_WRAPPERS, 0)
        if ds:
            rec["int8"] = _mg_int8(tmp, scene, names)
            int8_launches = rec["int8"]["launches"]
        if len(ds) and max(ds) == 4:
            rec["file_shard_processes"] = _mg_shard_processes(
                4, scene, tmp / "mg_shard4", tmp / "mg_tiled_bf16_d1", tmp,
                names)
    if plain_fit is None:  # the train phase's plain fit, when it did not run
        frames, pres, posts, masks, guides = _keyframes()
        data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                    patch_size=PS,
                                    device=torch.device("cuda", 0))
        plain_fit = {prec: _net_tensors(fit(
            _train_model(prec, max_steps=TRAIN_WARMUP + TRAIN_STEPS), data,
            str(tmp / f"mg_plain_{prec}"), seed=0, progress=False))
            for prec in ("32", "bf16")}
    worlds = [1] + ds
    rec["train"] = _mg_train(tmp, worlds, plain_fit)
    ranks = [json.loads(f.read_text()) for n in worlds
             for f in (tmp / f"mg_train_w{n}").glob("rank*_w*.json")]
    rec["launches"] = {**launches, **{
        f"train_{k}": sum(run[f"{k}_cluster"] for r in ranks
                          for run in r["runs"])
        for k in ("forward", "backward")},
        **{f"int8_{k}": n for k, n in int8_launches.items()}}
    if not ds:
        say("multi_gpu", skipped="the 2- and 4-card forms (serving at "
            "devices 2 and 4, full-frame, int8 over 2 cards, file_shard "
            "processes, fit over 2 and 4 ranks) did not run: this machine "
            f"has {count} card")
    return rec


# ------------------------------------------------------- tensor_parallel

TP_SIZES = (2, 4)  # model groups of the one-card forms
# (data, model) layouts of the NCCL forms; the first of the largest world
# is the one run twice
TP_LAYOUTS = ((1, 2), (2, 2), (1, 4))
B1_BWD = {"cluster": instance_norm.instance_norm_act_backward_cluster,
          "sample": instance_norm.instance_norm_act_backward_sample,
          "streaming": instance_norm.instance_norm_act_backward_streaming}


def _u8(t: torch.Tensor) -> torch.Tensor:
    """A [-1, 1] output as the 0-255 counts of a served frame."""
    return ((t.float() + 1) * 127.5).round().clamp(0, 255)


def _tp_batch(dev):
    """80 patches of the train phase's keyframes (the sampler's first draw
    from seed 0): G's input (RGB and the 3-band guide) and D's (the
    target), fp32 on ``dev``."""
    frames, pres, posts, masks, guides = _keyframes()
    data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, device=dev)
    batch = data.sample_batch(torch.Generator(device=dev).manual_seed(0), BT)
    return data.model_input(batch), batch["post"]


def _tp_nets(prec: str, dev):
    """The shipped G and D (config/model/default.yaml; weights from seed
    0, fp32 parameters) in eval mode on ``dev``, and the compute type."""
    model = _train_model(prec)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = GeneratorJ(**model.generator_args,
                       conv_precision=model.conv_precision)
        d = DiscriminatorN_IN(**model.discriminator_args,
                              conv_precision=model.conv_precision)
    return [n.to(dev, memory_format=torch.channels_last).eval()
            for n in (g, d)], model.dtype


class _B1Calls:
    """Within ``with``: every InstanceNorm site call of G and D
    (``layers.norm_act``), as (input, activation, output), in call
    order."""

    def __init__(self):
        self.calls = []

    def _tap(self, y, act, norm=True):
        out = self._real(y, act, norm)
        if norm:
            self.calls.append((y, act, out))
        return out

    def __enter__(self):
        self._real = layers.norm_act
        self._saved = (gen_module.norm_act, disc_module.norm_act)
        gen_module.norm_act = disc_module.norm_act = self._tap
        return self

    def __exit__(self, *exc):
        gen_module.norm_act, disc_module.norm_act = self._saved
        return False


def _b1_by_card() -> dict:
    """B1's launches so far by variant (forward; ``backward_*``) and card,
    and its backward's dy copies."""
    out = {k: dict(fn.by_device) for k, fn in B1_WRAPPERS.items()}
    out.update({f"backward_{k}": dict(fn.by_device)
                for k, fn in B1_BWD.items()})
    out["dy_copies"] = {"all": instance_norm.InstanceNormAct.dy_copies}
    return out


def _b1_delta(before: dict, after: dict) -> dict:
    """The launches between two ``_b1_by_card`` readings, the variants
    that launched."""
    out = {}
    for k, cards in after.items():
        d = {c: n - before.get(k, {}).get(c, 0) for c, n in cards.items()}
        d = {c: n for c, n in d.items() if n}
        if d:
            out[k] = d
    return out


def _tp_turns(G, D, x, post, m: int, dt) -> dict:
    """Every rank's share of the sharded eval forward of G and D in turn
    on one card (``parallel/tp.py::TurnGroup``: rank r's sharded copies,
    the conv slices and B1 on the channel slices at every site). Each
    site's assembled B1 outputs against the plain version on the assembled
    input (``_in_check``); the variant ``plan`` gives each slice against
    the launches counted; every rank's outputs bitwise equal."""
    group = TurnGroup(m)
    ranks = []
    for r in range(m):
        shard = ModelShard(r, m, group.member(r))
        g, d = copy.deepcopy(G), copy.deepcopy(D)
        shard_module_(g, shard)
        shard_module_(d, shard)
        ranks.append((g, d))

    def share(g, d):
        def run():
            with torch.no_grad():
                return g(x.to(dt)), d(post.to(dt))
        return run

    torch.cuda.synchronize()
    before = _b1_by_card()
    with _B1Calls() as tap:
        outs = group.run([share(g, d) for g, d in ranks])
    torch.cuda.synchronize()
    launched = _b1_delta(before, _b1_by_card())
    d_sites = len(D.intermediate) + 1  # 2
    sites = 5 + 2 * len(G.resnet_blocks) + d_sites  # 21
    if len(tap.calls) != sites * m:
        raise AssertionError(f"model {m}: {len(tap.calls)} B1 calls, "
                             f"expected {sites} sites x {m} ranks")
    worst, planned, shapes, slices, keys = 0.0, {}, [], {}, []
    for s in range(sites):
        part = tap.calls[s * m:(s + 1) * m]
        x0 = part[0][0].permute(0, 2, 3, 1)
        keys.append((tuple(x0.shape), part[0][1], x0.dtype))
        slices.setdefault(keys[-1], x0)
        y = torch.cat([c[0] for c in part], dim=1)
        got = torch.cat([c[2] for c in part], dim=1)
        with torch.no_grad():
            want = instance_norm.instance_norm_act_plain(
                y.permute(0, 2, 3, 1).contiguous(), part[0][1])
        worst = max(worst, _in_check(got.permute(0, 2, 3, 1), want, dt))
        for c in part:
            v = instance_norm.plan_for(c[0].permute(0, 2, 3, 1)).variant
            planned[v] = planned.get(v, 0) + 1
        lead = part[0][0]
        shapes.append(f"{tuple(lead.shape[1:])}:" + instance_norm.plan_for(
            lead.permute(0, 2, 3, 1)).variant)
    counted = {k: sum(v.values()) for k, v in launched.items()}
    if counted != planned:
        raise AssertionError(f"model {m}: B1 launches {launched}, plan "
                             f"gives {planned}")
    for g, d in outs[1:]:
        if not (torch.equal(g, outs[0][0]) and torch.equal(d, outs[0][1])):
            raise AssertionError(f"model {m}: the ranks' outputs differ")
    return {"g": outs[0][0], "d": outs[0][1], "b1_max_abs": worst,
            "launches": launched, "site_variants": shapes, "slices": slices,
            # a rank's B1 sites of one training step: G's, then D's in
            # each of its 3 calls
            "step_keys": keys[:-d_sites] + keys[-d_sites:] * 3}


def _sample_k2(x: torch.Tensor, backward: bool = False):
    """The sample variant's plan at twice the CTAs a sample that the plan
    gives ``x`` (a cluster of 2 for one CTA), if that many fit a cluster:
    the alternative the plan's least k is timed against."""
    n, h, w, c = x.shape
    p = instance_norm.sample_plan(n, h, w, c, x.dtype, backward)
    if p is None or 2 * p.k > 8:
        return None
    k = 2 * p.k
    ppc = -(-h * w // k)
    return instance_norm.Plan("sample", 0, k, instance_norm.sample_smem(
        ppc, c, x.dtype.itemsize, backward), k, ppc)


def _tp_slice_kernels(slices: dict, steps: dict, card: str) -> dict:
    """B1's forward and backward at each (slice shape, activation, dtype)
    that tensor parallelism's sites give it (``_tp_turns``: rank 0's
    recorded input there) with a seeded dy that is rank 1's channel slice
    of a two-rank gathered gradient, as the gather's backward hands it to
    B1: the variant ``plan_for`` and ``plan_backward_for`` pick (the
    backward reads the strided dy where the sample variant takes it, else
    a contiguous copy, as ``InstanceNormAct`` does), against the plain
    version with the tolerances of ``phase_instance_norm`` and
    ``phase_instance_norm_backward``; at the sample variant's sites also
    its plan at twice the CTAs a sample. Then each timed by ``queued_ms``
    over copies of its inputs that together exceed twice the L2 cache
    (every call reads them from HBM), beside its bound, the plain version
    and the library's; at the sample variant's sites also the streaming
    kernels that took them before (the old path: dy copied, then the
    streaming backward), the copy alone, and the sample variant at twice
    the CTAs. The per-step numbers sum a rank's 25 sites of one training
    step (``steps``: their keys by model size and dtype) by the variant
    picked. The one-card path runs the backward on no slice
    (``TurnGroup`` runs forward passes only), so this and
    ``_tp_autograd_steps`` are where the backward variants meet these
    shapes on one card."""
    per = {}
    for (shape, act, dtype), x in slices.items():
        gen = torch.Generator(device=x.device).manual_seed(7)
        c = shape[3]
        wide = torch.randn(shape[:3] + (2 * c,), device=x.device,
                           generator=gen).to(dtype)
        dy = wide[..., c:].contiguous()
        fv = instance_norm.plan_for(x).variant
        strided = instance_norm._reads_strided(x, wide[..., c:])
        bv = "sample" if strided else \
            instance_norm.plan_backward_for(x, dy).variant
        fwd, bwd = B1_WRAPPERS[fv], B1_BWD[bv]
        y, mean, rstd = fwd(x, act, stats=True)
        _, pmean, prstd = instance_norm._plain_forward(x, act, 0.2, 1e-5)
        serr = max(float((mean - pmean).abs().max()),
                   float(((rstd - prstd) / prstd).abs().max()))
        if serr > 1e-5:
            raise AssertionError(f"{shape} {dtype}: statistics {serr}")
        want_y = instance_norm.instance_norm_act_plain(x, act)
        want_dx = instance_norm.instance_norm_act_backward_plain(
            x, dy, mean, rstd, act)
        r = {"forward_variant": fv, "backward_variant": bv,
             "forward_max_abs_err": _in_check(y, want_y, dtype),
             "backward_max_abs_err": _bwd_check(
                 bwd(x, wide[..., c:] if strided else dy, mean, rstd, act),
                 want_dx, dtype)}
        k2, k2b = (_sample_k2(x), _sample_k2(x, True)) if fv == "sample" \
            else (None, None)
        if k2 is not None:
            r["forward_max_abs_err"] = max(r["forward_max_abs_err"], _in_check(
                instance_norm.instance_norm_act_sample(x, act, p=k2), want_y,
                dtype))
        if k2b is not None and strided:
            r["backward_max_abs_err"] = max(
                r["backward_max_abs_err"], _bwd_check(
                    instance_norm.instance_norm_act_backward_sample(
                        x, wide[..., c:], mean, rstd, act, p=k2b), want_dx,
                    dtype))
        del y, want_y, want_dx
        n_copies = max(1, -(-int(2 * L2_BYTES) // (4 * x.nbytes)))
        copies = [(x, wide)] + [(x.clone(), wide.clone())
                                for _ in range(n_copies - 1)]
        # the plain and library versions launch many kernels a call: at
        # most 16 calls stay within the launch queue behind the spin
        reps, slow = max(10, 2 * n_copies), min(16, max(3, n_copies))

        def timed(make, n):
            return queued_ms([make(xc, wc[..., c:] if strided else
                                   wc[..., c:].contiguous())
                              for xc, wc in copies], n)

        elems = x.numel()
        fb, fo = 2 * x.nbytes / HBM_BYTES_PER_S * 1e3, \
            8 * elems / FP32_FLOPS * 1e3
        bb, bo = 3 * x.nbytes / HBM_BYTES_PER_S * 1e3, \
            12 * elems / FP32_FLOPS * 1e3
        r.update(
            forward_ms=timed(lambda xc, dc: lambda: fwd(xc, act), reps),
            backward_ms=timed(lambda xc, dc: lambda: bwd(
                xc, dc, mean, rstd, act), reps),
            forward_plain_ms=timed(lambda xc, dc: lambda: instance_norm.
                                   instance_norm_act_plain(xc, act), slow),
            backward_plain_ms=timed(
                lambda xc, dc: lambda: instance_norm.
                instance_norm_act_backward_plain(xc, dc, mean, rstd, act),
                slow),
            forward_library_ms=timed(
                lambda xc, dc: lambda: _library_in(xc, act), slow),
            backward_library_ms=timed(
                lambda xc, dc: _library_in_bwd(xc, dc, act), slow),
            forward_bound_ms=max(fb, fo), backward_bound_ms=max(bb, bo))
        if fv == "sample":
            # the path before the sample variant: the streaming kernels,
            # the backward's on dy copied first (the copy timed alone too)
            old = [(xc, wc[..., c:]) for xc, wc in copies]
            r.update(
                forward_old_ms=queued_ms(
                    [lambda xc=xc: instance_norm.instance_norm_act_streaming(
                        xc, act) for xc, _ in old], reps),
                backward_old_ms=queued_ms(
                    [lambda xc=xc, dc=dc: instance_norm.
                     instance_norm_act_backward_streaming(
                         xc, dc.contiguous(), mean, rstd, act)
                     for xc, dc in old], reps),
                dy_copy_ms=queued_ms([lambda dc=dc: dc.contiguous()
                                      for _, dc in old], reps))
            if k2 is not None:
                r["forward_k2_ms"] = timed(
                    lambda xc, dc: lambda: instance_norm.
                    instance_norm_act_sample(xc, act, p=k2), reps)
            if k2b is not None and strided:
                r["backward_k2_ms"] = timed(
                    lambda xc, dc: lambda: instance_norm.
                    instance_norm_act_backward_sample(xc, dc, mean, rstd,
                                                      act, p=k2b), reps)
        del copies, dy, wide
        per[(shape, act, dtype)] = r
        say("tensor_parallel", form="B1 on a channel slice against its "
            "plain version", dtype=str(dtype).split(".")[1],
            shape="x".join(map(str, shape)), act=act,
            forward_variant=fv, backward_variant=bv,
            backward_dy="strided" if strided else "contiguous copy",
            **{k: f"{v:.4f}" for k, v in r.items() if k.endswith("_ms")},
            forward_max_abs_err=f"{r['forward_max_abs_err']:.3g}",
            backward_max_abs_err=f"{r['backward_max_abs_err']:.3g}",
            stats_err=f"{serr:.3g}")
    out = {}
    extra = ("old_ms", "k2_ms", "dy_copy_ms")
    for tag, step_keys in steps.items():
        rows = [per[k] for k in step_keys]
        tot = {}
        for d in ("forward", "backward"):
            for v in sorted({r[f"{d}_variant"] for r in rows}):
                mine = [r for r in rows if r[f"{d}_variant"] == v]
                tot[f"{d}_{v}"] = {
                    k: sum(r[f"{d}_{k}"] for r in mine)
                    for k in ("ms", "bound_ms", "plain_ms",
                              "library_ms")}
                tot[f"{d}_{v}"].update(
                    sites=len(mine), max_abs_err=max(
                        r[f"{d}_max_abs_err"] for r in mine))
                for q in extra:
                    key = "dy_copy_ms" if q == "dy_copy_ms" else f"{d}_{q}"
                    if d == "forward" and q == "dy_copy_ms":
                        continue
                    if all(key in r for r in mine):
                        tot[f"{d}_{v}"][q] = sum(r[key] for r in mine)
        out[tag] = tot
        say("tensor_parallel", form="B1 on a rank's slices of one "
            f"training step ({len(rows)} sites) by variant", step=tag,
            **{f"{k}_{q}": (f"{v[q]:.4f}" if q.endswith("ms")
                            else v[q])
               for k, v in tot.items()
               for q in ("sites", "ms", "bound_ms", "plain_ms",
                         "library_ms") + extra if q in v}, card=f"'{card}'")
    # the fixed cost of a launch at D's slices: each kernel on 80 one-pixel
    # samples of 6 channels (bf16), where its work is next to nothing
    dev = next(iter(slices.values())).device
    gen = torch.Generator(device=dev).manual_seed(8)
    tiny = [torch.randn((80, 1, 1, 6), device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(16)]
    _, tm, tr = instance_norm.instance_norm_act_sample(tiny[0], None,
                                                       stats=True)
    floor = {
        "sample_forward_ms": queued_ms(
            [lambda t=t: instance_norm.instance_norm_act_sample(t, None)
             for t in tiny], 32),
        "sample_backward_ms": queued_ms(
            [lambda t=t: instance_norm.instance_norm_act_backward_sample(
                t, t, tm, tr, None) for t in tiny], 32),
        "streaming_forward_ms": queued_ms(
            [lambda t=t: instance_norm.instance_norm_act_streaming(t, None)
             for t in tiny], 32)}
    say("tensor_parallel", form="B1's launch floor: each kernel on 80 "
        "one-pixel samples of 6 channels, bf16",
        **{k: f"{v:.4f}" for k, v in floor.items()}, card=f"'{card}'")
    return {"per_step": out, "shapes": len(per), "launch_floor": floor}


def _tp_autograd_steps(slices: dict, steps: dict) -> dict:
    """B1 under autograd (``InstanceNormAct``, what ``fit``'s steps call)
    at a rank's 25 sites of one training step for each (dtype, model m),
    dy at each site rank 1's channel slice of the m-rank gathered
    gradient, as the gather's backward hands it over: the dy copies a
    step a rank (the slices the sample variant does not take, whose dy is
    made contiguous first) against the count the plans give, with B1's
    launches read over these steps alone. Then, at each site the sample
    variant takes, dx bitwise the dx of the same dy made contiguous. ->
    copies by step, the launches by variant and card."""
    def step(x, act, dy):
        xg = x.clone().requires_grad_(True)
        y = instance_norm.InstanceNormAct.apply(xg, act, 0.2, 1e-5)
        return torch.autograd.grad(y, xg, dy)[0]

    out, strided_sites = {}, {}
    torch.cuda.synchronize()
    before = _b1_by_card()
    for tag, keys in steps.items():
        m = int(tag.split("_m")[1])
        copies0 = instance_norm.InstanceNormAct.dy_copies
        want = 0
        for i, key in enumerate(keys):
            x = slices[key].detach()
            gen = torch.Generator(device=x.device).manual_seed(100 + i)
            c = key[0][3]
            wide = torch.randn(key[0][:3] + (m * c,), device=x.device,
                               generator=gen).to(key[2])
            dy = wide[..., c:2 * c]
            if instance_norm._reads_strided(x, dy):
                strided_sites.setdefault(key, (dy, step(x, key[1], dy)))
            else:
                want += 1
                step(x, key[1], dy)
        got = instance_norm.InstanceNormAct.dy_copies - copies0
        if got != want:
            raise AssertionError(f"{tag}: {got} dy copies a step a rank, "
                                 f"the plans give {want}")
        out[tag] = got
    torch.cuda.synchronize()
    launches = _b1_delta(before, _b1_by_card())
    for (shape, act, dtype), (dy, dx) in strided_sites.items():
        if not torch.equal(dx, step(slices[(shape, act, dtype)].detach(),
                                    act, dy.contiguous())):
            raise AssertionError(f"{shape} {dtype}: dx from the strided dy "
                                 "differs from the contiguous one's")
    return {"dy_copies_per_step_per_rank": out, "launches": launches,
            "strided_sites": len(strided_sites)}


def phase_tensor_parallel(dev, card: str, tmp: Path, plain_fit: dict) -> dict:
    """Tensor parallelism (``parallel/tp.py``) on one card: each rank's
    share of the sharded forward in turn, at model 2 and 4, bf16 and 32,
    held to the one-card forward (B1's slices within ``_in_check``'s
    tolerance, the generator within 1 count at 32); ``fit`` at
    ``training.devices=1 parallel.mesh.model=2`` bitwise the plain ``fit``
    (JAX builds no mesh at one device). The NCCL forms need 2+ cards
    (``phase_tensor_parallel_multi``)."""
    x, post = _tp_batch(dev)
    rec = {"forward": {}, "fit_devices1_model2": {}}
    launches, slices, steps = {}, {}, {}
    for prec in ("bf16", "32"):
        (G, D), dt = _tp_nets(prec, dev)
        with training_backends(dt):
            with torch.no_grad():
                one_g, one_d = G(x.to(dt)), D(post.to(dt))
            for m in TP_SIZES:
                r = _tp_turns(G, D, x, post, m, dt)
                for k, v in r.pop("slices").items():
                    slices.setdefault(k, v)
                steps[f"{prec}_m{m}"] = r.pop("step_keys")
                counts = int((_u8(r["g"]) - _u8(one_g)).abs().max())
                g_abs = float((r["g"].float() - one_g.float()).abs().max())
                d_abs = float((r["d"].float() - one_d.float()).abs().max())
                for k, cards in r["launches"].items():
                    launches[k] = launches.get(k, 0) + sum(cards.values())
                rec["forward"][f"{prec}_m{m}"] = {
                    "b1_max_abs_vs_plain": r["b1_max_abs"],
                    "g_vs_one_card_counts": counts,
                    "g_vs_one_card_max_abs": g_abs,
                    "d_vs_one_card_max_abs": d_abs,
                    "launches_by_card": r["launches"],
                    "site_variants": r["site_variants"]}
                say("tensor_parallel", form="each rank's share in turn on "
                    "one card", precision=prec, model=m, batch=BT,
                    b1_sites=len(r["site_variants"]),
                    b1_max_abs_vs_plain=f"{r['b1_max_abs']:.3g}",
                    launches_by_card=json.dumps(r["launches"]).replace(
                        " ", ""),
                    site_variants=",".join(r["site_variants"]).replace(
                        " ", ""),
                    g_vs_one_card_counts=counts,
                    g_vs_one_card_max_abs=f"{g_abs:.3g}",
                    d_vs_one_card_max_abs=f"{d_abs:.3g}", card=f"'{card}'")
                if prec == "32" and counts > 1:
                    raise AssertionError(f"model {m} at 32: the generator "
                                         f"{counts} counts from one card")
        del G, D
    rec["slice_kernels"] = _tp_slice_kernels(slices, steps, card)
    ag = _tp_autograd_steps(slices, steps)
    rec["autograd_steps"] = {
        "dy_copies_per_step_per_rank": ag["dy_copies_per_step_per_rank"],
        "launches_by_card": ag["launches"]}
    say("tensor_parallel", form="B1 under autograd (InstanceNormAct) at a "
        "rank's 25 sites of one step, dy a rank's strided channel slice",
        dy_copies_per_step_per_rank=json.dumps(
            ag["dy_copies_per_step_per_rank"]).replace(" ", ""),
        sample_sites_bitwise_the_copied_dy=ag["strided_sites"],
        launches_by_card=json.dumps(ag["launches"]).replace(" ", ""),
        card=f"'{card}'")
    del slices
    frames, pres, posts, masks, guides = _keyframes()
    data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, device=dev)
    fit_launches = {"forward": 0, "backward": 0}
    for prec in ("32", "bf16"):
        model = _train_model(prec, max_steps=TRAIN_WARMUP + TRAIN_STEPS,
                             model=2)
        win = _Window(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
        state = fit(model, data, str(tmp / f"tp_devices1_{prec}"), seed=0,
                    progress=False, on_step=win)
        got = _net_tensors(state)
        differ = [k for k in got if not torch.equal(got[k],
                                                    plain_fit[prec][k])]
        fwd, st, bwd, bst = win.counts
        fit_launches["forward"] += fwd
        fit_launches["backward"] += bwd
        rec["fit_devices1_model2"][prec] = {
            "differing_tensors": len(differ),
            "ms_per_step": 1e3 * win.seconds / TRAIN_STEPS}
        say("tensor_parallel", form="fit at training.devices=1 "
            "parallel.mesh.model=2 (no mesh, as in JAX)", precision=prec,
            steps=TRAIN_WARMUP + TRAIN_STEPS, tensors=len(got),
            vs_plain_fit_differing_tensors=len(differ),
            forward_cluster=fwd, backward_cluster=bwd)
        if differ or st or bst:
            raise AssertionError(f"fit at devices 1, model 2, {prec}: "
                                 f"differs from the plain fit in "
                                 f"{differ[:5]}, streaming launches {st} "
                                 f"{bst}")
    if torch.cuda.device_count() < 2:
        say("tensor_parallel", skipped="the NCCL forms (the sharded forward "
            "over 2 and 4 ranks, fit at data 1 x model 2, data 2 x model 2 "
            "and data 1 x model 4, the collectives against the link, the "
            "trained checkpoint served) did not run: this machine has "
            f"{torch.cuda.device_count()} card; python3 chip_smoke.py "
            "--multi-gpu runs them on 2 or 4")
    return {"rec": rec, "launches": launches, "fit_launches": fit_launches,
            "autograd_launches": {k: sum(v.values())
                                  for k, v in ag["launches"].items()}}


class _TPWindow(_Window):
    """``_Window`` that also reads B1's launches by variant and card (and
    the dy copies) over the window."""

    def __call__(self, step: int, metrics) -> None:
        super().__call__(step, metrics)
        if step == self.start:
            self.b1 = _b1_by_card()
        elif step == self.stop:
            self.b1 = _b1_delta(self.b1, _b1_by_card())


class _CommLog:
    """A model group's collectives (``parallel.tp.DistGroup``) that, while
    ``on``, records each call's kind, shape and type."""

    def __init__(self, inner):
        self.inner, self.size, self.on, self.calls = inner, inner.size, \
            False, []

    def all_gather(self, x):
        if self.on:
            self.calls.append(("gather", tuple(x.shape), x.dtype))
        return self.inner.all_gather(x)

    def all_reduce_(self, x):
        if self.on:
            self.calls.append(("reduce", tuple(x.shape), x.dtype))
        self.inner.all_reduce_(x)


def _replay_ms(fns, reps: int = 5) -> float:
    """Device ms of one pass over ``fns`` (every rank calls the same ones:
    collectives), the ranks lined up at a barrier first."""
    if not fns:
        return 0.0
    for fn in fns:
        fn()
    parallel.barrier()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for fn in fns:
            fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _tp_comm(device, data, m: int, prec: str, out: Path) -> dict:
    """One step of ``fit`` at data x model m with the model group's
    collectives recorded (the 3rd step), then that step's collectives
    replayed on their own, timed with CUDA events, the ranks in step: the
    activation gathers whole (``parallel.tp.gather_from_model``: the
    collective and the interleave copy), the collectives alone, the
    interleave copies alone, the input-gradient all-reduces, the small
    ones (BatchNorm statistics, the clip's norm) and, over the data group,
    the gradients' all-reduce."""
    logs = []
    real = loop_module.model_shard

    def logged(lay):
        shard = real(lay)
        shard.comm = _CommLog(shard.comm)
        logs.append(shard.comm)
        return shard

    def window(step, metrics):
        logs[0].on = step == TRAIN_WARMUP

    model = _train_model(prec, max_steps=TRAIN_WARMUP + 1, model=m)
    with _patched(loop_module, "model_shard", logged):
        state = fit(model, data, str(out / f"run_m{m}_{prec}_comm"), seed=0,
                    on_step=window, progress=False)
    lay = parallel.set_layout(m)  # built by fit: no collective
    shard = model_shard(lay)
    calls = logs[0].calls
    acts = [(shape, dt) for kind, shape, dt in calls
            if kind == "gather" and len(shape) == 4]
    reds = [(shape, dt) for kind, shape, dt in calls
            if kind == "reduce" and len(shape) == 4]
    small = [(kind, shape, dt) for kind, shape, dt in calls
             if len(shape) != 4]
    ys = [torch.randn(shape, device=device).to(dt).permute(0, 3, 1, 2)
          for shape, dt in acts]
    locs = [y.permute(0, 2, 3, 1).contiguous() for y in ys]
    bufs = [torch.randn((m * sh[0],) + sh[1:], device=device).to(dt)
            for sh, dt in acts]
    gs = [torch.randn(shape, device=device).to(dt) for shape, dt in reds]
    ts = [(kind, torch.randn(shape, device=device).to(dt))
          for kind, shape, dt in small]
    grads = [torch.randn_like(p) for net in (state.generator,
                                             state.discriminator)
             for p in net.parameters()]

    def interleave(b, y):
        n, c, h, w = y.shape
        return b.view(m, n, h, w, c).permute(1, 2, 3, 0, 4).reshape(
            n, h, w, m * c)

    rec = {
        "gathers": len(acts), "all_reduces": len(reds),
        "small_collectives": len(small),
        "gather_ms": _replay_ms([lambda y=y: gather_from_model(y, shard)
                                 for y in ys]),
        "gather_collective_ms": _replay_ms(
            [lambda x=x: shard.comm.all_gather(x) for x in locs]),
        "interleave_ms": _replay_ms([lambda b=b, y=y: interleave(b, y)
                                     for b, y in zip(bufs, ys)]),
        "all_reduce_ms": _replay_ms([lambda g=g: shard.comm.all_reduce_(g)
                                     for g in gs]),
        "small_ms": _replay_ms([
            (lambda t=t: shard.comm.all_gather(t)) if kind == "gather"
            else (lambda t=t: shard.comm.all_reduce_(t))
            for kind, t in ts]),
        "data_grad_ms": _replay_ms([lambda: comm.all_reduce_mean_(
            grads, lay.data_group)]) if lay.data > 1 else 0.0,
        "gathered_bytes": sum(m * math.prod(sh) * dt.itemsize
                              for sh, dt in acts),
        "reduced_bytes": sum(math.prod(sh) * dt.itemsize
                             for sh, dt in reds),
        "data_grad_bytes": 4 * sum(g.numel() for g in grads)}
    del state
    return rec


def _tp_step_parity(device, m: int) -> dict:
    """One small-width step (batch ``MG_PARITY_BATCH``) at data x model
    m: each rank records its branches on its rows and channels; rank 0
    assembles the whole masks (the channel slices of the sharded sites in
    rank order, then the data indices' rows) and holds the gathered whole
    state to the fp64 one-device step that takes those branches
    (``train/parity.py``, 5e-5)."""
    lay = parallel.set_layout(m)
    model = _train_model("32", small=True, batch=MG_PARITY_BATCH)
    rng = np.random.default_rng(1)
    b, ps = MG_PARITY_BATCH, 32
    batch = {"pre": rng.standard_normal((b, ps, ps, 3)),
             "channels": rng.standard_normal((b, ps, ps, 3)),
             "post": rng.random((b, ps, ps, 3)) * 2 - 1}
    rows = parallel.shard_rows(b, lay.data_index, lay.data)
    summary = None
    with training_backends(torch.float32):
        start = model.init_state(0, "cpu")
        kinks = Kinks()
        st, _ = run_step(model, start, {k: v[rows] for k, v in
                                        batch.items()}, device, kinks,
                         shard=model_shard(lay))
        whole = whole_state(st)
        masks = [None] * parallel.world()
        torch.distributed.all_gather_object(masks, (kinks.masks,
                                                    kinks.sites))
        if parallel.rank() == 0:
            with _patched(comm, "rank", lambda: 0), \
                    _patched(comm, "world", lambda: 1):
                shapes = Kinks()
                run_step(model, start, batch, "cpu", shapes)
                replay = []
                for i, want in enumerate(shapes.masks):
                    dim = 3 if shapes.sites[i].startswith("instance_norm") \
                        else 1
                    data_parts = []
                    for j in range(lay.data):
                        part = [masks[j * m + r][0][i] for r in range(m)]
                        if part[0].shape[dim] != want.shape[dim]:
                            part = [torch.cat(part, dim=dim)]
                        data_parts.append(part[0])
                    replay.append(torch.cat(data_parts))
                ref, _ = run_step(model, start, batch, "cpu",
                                  Kinks(replay=replay), torch.float64)
            got = copy.deepcopy(start)
            sd = whole["state_dict"]
            for pre, net in (("generator.", got.generator),
                             ("discriminator.", got.discriminator)):
                net.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                                     if k.startswith(pre)})
            got.g_opt = optim.from_config(got.generator.parameters(),
                                          model.optimizer_config["generator"],
                                          model.clip)
            got.d_opt = optim.from_config(
                got.discriminator.parameters(),
                model.optimizer_config["discriminator"], model.clip)
            for opt, osd in zip((got.g_opt, got.d_opt),
                                whole["optimizer_states"]):
                for dst, src in zip(opt.mu, osd["mu"]):
                    dst.copy_(src)
            summary = first_step_agreement(state_pairs(ref, got))
            assert_first_step_close(summary, 5e-5, f"data {lay.data} x "
                                    f"model {m} against fp64")
        parallel.barrier()
    return summary


def _tp_rank(device, out: str, jobs: list, flags: tuple) -> None:
    """One rank of the NCCL forms (``parallel.spawn``, the launcher
    ``train_cli`` uses), ``jobs`` in order, each (kind, model, precision,
    repeat): ``forward`` (the sharded eval forward of G and D on the
    batch, every rank's outputs saved), ``fit`` (``fit`` 12 steps, batch
    80, at data x model; steps 3-12 timed with B1's launches by variant
    and card; every rank's whole parameters saved, gathered over the model
    group), ``fit1`` (``fit`` one step at batch 80, precision 32, its
    checkpoint kept: at model 1 the data-parallel yardstick),
    ``comm`` (``_tp_comm``), ``parity`` (``_tp_step_parity``).
    ``flags`` as ``_mg_fit_rank``'s. Writes tp_rank<r>_w<n>.json."""
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     precision) = flags
    torch.set_float32_matmul_precision(precision)
    rank, world = parallel.rank(), parallel.world()
    out = Path(out)
    frames, pres, posts, masks, guides = _keyframes()
    data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                patch_size=PS, device=device)
    rec = {"rank": rank, "world": world, "device": str(device),
           "name": torch.cuda.get_device_name(device), "jobs": []}
    for kind, m, prec, rep in jobs:
        job = {"kind": kind, "model": m, "precision": prec, "repeat": rep}
        if kind == "forward":
            shard = model_shard(parallel.set_layout(m))
            (G, D), dt = _tp_nets(prec, device)
            shard_module_(G, shard)
            shard_module_(D, shard)
            x, post = _tp_batch(device)
            with training_backends(dt), torch.no_grad():
                g, d = G(x.to(dt)), D(post.to(dt))
            torch.save({"g": g.float().cpu(), "d": d.float().cpu()},
                       out / f"fwd_m{m}_{prec}_rank{rank}.pt")
        elif kind == "fit":
            model = _train_model(prec, max_steps=TRAIN_WARMUP + TRAIN_STEPS,
                                 model=m)
            win = _TPWindow(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
            state = fit(model, data, str(out / f"run_m{m}_{prec}_{rep}"),
                        seed=0, on_step=win, progress=False)
            job.update(ms_per_step=1e3 * win.seconds / TRAIN_STEPS,
                       b1=win.b1,
                       g_total_loss=float(win.metrics["g_total_loss"]))
            sd = whole_state(state)["state_dict"]
            torch.save({("G." + k[len("generator."):]) if k.startswith(
                "generator.") else "D." + k[len("discriminator."):]:
                v.float() for k, v in sd.items()},
                out / f"m{m}_{prec}_{rep}_rank{rank}.pt")
            del state
        elif kind == "fit1":
            fit(_train_model(prec, max_steps=1, model=m), data,
                str(out / f"run1_m{m}_{prec}"), seed=0, progress=False)
        elif kind == "comm":
            job["comm"] = _tp_comm(device, data, m, prec, out)
        elif kind == "parity":
            job["parity"] = _tp_step_parity(device, m)
        rec["jobs"].append(job)
    (out / f"tp_rank{rank}_w{world}.json").write_text(json.dumps(rec))


def _served_32(path: Path):
    """A trained checkpoint served on card 0 at precision 32: the first
    keyframe through ``stylize_group`` with its eroded mask."""
    frames, pres, posts, masks, guides = _keyframes()
    eng = StyleTransferInference(inference_config(
        paths={"checkpoint": str(path)}, inference={"precision": "32"}))
    return eng.stylize_group(frames[0][None],
                             [erode_full_support_np(masks[0])])


def phase_tensor_parallel_multi(tmp: Path) -> dict:
    """The NCCL forms of tensor parallelism on 2+ cards (see the module's
    docstring), after ``_mg_train`` in the same ``tmp`` (its
    data-parallel runs are the yardsticks)."""
    count = torch.cuda.device_count()
    layouts = [(d, m) for d, m in TP_LAYOUTS if d * m <= count]
    if not layouts:
        return {"skipped": f"{count} card"}
    link_bps, link = _link_bps()
    top = max(layouts, key=lambda lay: lay[0] * lay[1])
    dev0 = parallel.local_devices(1)[0]
    x, post = _tp_batch(dev0)
    one = {}
    for prec in ("32", "bf16"):
        (G, D), dt = _tp_nets(prec, dev0)
        with training_backends(dt), torch.no_grad():
            one[prec] = (G(x.to(dt)).float().cpu(),
                         D(post.to(dt)).float().cpu())
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    rec = {"link": link, "link_bytes_per_s": link_bps, "layouts": {}}
    launches = {}
    served_dp = {n: _served_32(tmp / f"mg_train_w{n}" / f"run_w{n}_32_0_{BT}"
                               / "checkpoints" / "last.ckpt")
                 for n in (1, 2, 4) if n <= count}
    # one step of data parallelism at each layout's d, the served yardstick
    # of one TP step (one card in this process, else d NCCL ranks)
    served_dp1 = {}
    for d in sorted({d for d, _ in layouts}):
        out = tmp / f"tp_dp{d}"
        out.mkdir(parents=True, exist_ok=True)
        if d == 1:
            data = StyleTransferDataset(*_keyframes()[1:], [3],
                                        patch_size=PS, device=dev0)
            fit(_train_model("32", max_steps=1), data,
                str(out / "run1_m1_32"), seed=0, progress=False)
        else:
            parallel.spawn(_tp_rank, (str(out), [("fit1", 1, "32", 0)],
                                      flags), parallel.local_devices(d))
        served_dp1[d] = _served_32(out / "run1_m1_32" / "checkpoints"
                                   / "last.ckpt")
    for n in sorted({d * m for d, m in layouts}):
        out = tmp / f"tp_w{n}"
        out.mkdir(parents=True, exist_ok=True)
        jobs = []
        for d, m in [lay for lay in layouts if lay[0] * lay[1] == n]:
            jobs += [("forward", m, p, 0) for p in ("32", "bf16")]
            jobs += [("fit", m, p, r) for p in ("32", "bf16")
                     for r in ((0, 1) if (d, m) == top else (0,))]
            jobs += [("comm", m, p, 0) for p in ("bf16", "32")]
            jobs += [("parity", m, "32", 0), ("fit1", m, "32", 0)]
        t0 = time.perf_counter()
        parallel.spawn(_tp_rank, (str(out), jobs, flags),
                       parallel.local_devices(n))
        wall = time.perf_counter() - t0
        ranks = [json.loads((out / f"tp_rank{r}_w{n}.json").read_text())
                 for r in range(n)]
        for d, m in [lay for lay in layouts if lay[0] * lay[1] == n]:
            rec["layouts"][f"d{d}_m{m}"] = _tp_layout_checks(
                tmp, out, ranks, d, m, top, one, served_dp, served_dp1[d],
                link_bps, link, wall, launches)
    return {"rec": rec, "launches": launches}


def _tp_layout_checks(tmp, out, ranks, d, m, top, one, served_dp,
                      served_dp1, link_bps, link, wall, launches) -> dict:
    """The checks and numbers of one layout's NCCL runs (see
    ``phase_tensor_parallel_multi``)."""
    n = d * m
    w = {"ranks": n, "spawn_s": wall, "cards": sorted({r["name"]
                                                        for r in ranks})}
    for prec in ("32", "bf16"):  # the forward against one card
        outs = [torch.load(out / f"fwd_m{m}_{prec}_rank{r}.pt",
                           weights_only=True) for r in range(n)]
        for j in range(d):
            group = outs[j * m:(j + 1) * m]
            if any(not torch.equal(o["g"], group[0]["g"])
                   or not torch.equal(o["d"], group[0]["d"]) for o in group):
                raise AssertionError(f"d{d} m{m} {prec}: the ranks of a "
                                     "model group differ")
        counts = max(int((_u8(o["g"]) - _u8(one[prec][0])).abs().max())
                     for o in outs)
        d_abs = max(float((o["d"] - one[prec][1]).abs().max())
                    for o in outs)
        w[f"forward_{prec}"] = {"g_vs_one_card_counts": counts,
                                "d_vs_one_card_max_abs": d_abs}
        say("tensor_parallel", form="NCCL forward", data=d, model=m,
            precision=prec, g_vs_one_card_counts=counts,
            d_vs_one_card_max_abs=f"{d_abs:.3g}")
        if prec == "32" and counts > 1:
            raise AssertionError(f"d{d} m{m}: the sharded forward {counts} "
                                 "counts from one card")
    for prec in ("32", "bf16"):
        fits = [next(j for j in r["jobs"] if j["kind"] == "fit"
                     and j["model"] == m and j["precision"] == prec
                     and j["repeat"] == 0) for r in ranks]
        comm_job = next(j for j in ranks[0]["jobs"] if j["kind"] == "comm"
                        and j["model"] == m and j["precision"] == prec)
        tensors = [torch.load(out / f"m{m}_{prec}_0_rank{r}.pt",
                              weights_only=True) for r in range(n)]
        differ = [f"rank{r}/{k}" for r in range(1, n) for k in tensors[0]
                  if not torch.equal(tensors[r][k], tensors[0][k])]
        rep = None
        if (d, m) == top:
            again = torch.load(out / f"m{m}_{prec}_1_rank0.pt",
                               weights_only=True)
            rep = [k for k in again if not torch.equal(again[k],
                                                       tensors[0][k])]
        dp = torch.load(tmp / f"mg_train_w{d}" / f"w{d}_{prec}_0_rank0.pt",
                        weights_only=True)
        start = _net_tensors(_train_model(prec).init_state(0, "cpu"))
        num = sum(float(torch.sum((tensors[0][k] - dp[k]) ** 2))
                  for k in dp if k in start)
        den = sum(float(torch.sum((dp[k] - start[k]) ** 2))
                  for k in dp if k in start)
        rel = (num / den) ** 0.5 if den else 0.0
        dp_ms = {r: next(x["ms_per_step"] for x in json.loads(
            (tmp / f"mg_train_w{r}" / f"rank0_w{r}.json").read_text())
            ["runs"] if x["precision"] == prec and x["repeat"] == 0
            and x["batch"] == BT) for r in sorted({1, n})}
        ms = max(f["ms_per_step"] for f in fits)
        by_card = {}
        for f in fits:
            for k, cards in f["b1"].items():
                for c, v in cards.items():
                    by_card.setdefault(k, {})[c] = \
                        by_card.get(k, {}).get(c, 0) + v
        for k, cards in by_card.items():
            launches[k] = launches.get(k, 0) + sum(cards.values())
        cm = next(j["comm"] for j in ranks[0]["jobs"] if j["kind"] ==
                  "comm" and j["model"] == m and j["precision"] == prec)
        gathered, reduced, grads = (cm["gathered_bytes"],
                                    cm["reduced_bytes"],
                                    cm["data_grad_bytes"])
        # ring collectives over the link: an all-gather brings (m-1)/m of
        # the whole tensor into each rank, an all-reduce moves twice that
        bound = ((m - 1) / m * gathered + 2 * (m - 1) / m * reduced
                 + 2 * (d - 1) / d * grads) / link_bps * 1e3
        comm_ms = cm["gather_ms"] + cm["all_reduce_ms"] + cm["small_ms"] \
            + cm["data_grad_ms"]
        limit = 1e-1 if prec == "32" else 5e-1
        # B1's dy copies a step a rank (the strided dy slices the sample
        # variant does not take)
        copies = sum(by_card.get("dy_copies", {}).values()) / (
            n * TRAIN_STEPS)
        w[prec] = {"ms_per_step": ms, "dp_ms_per_step_same_cards": dp_ms[n],
                   "one_card_ms_per_step": dp_ms[1],
                   "dy_copies_per_step_per_rank": copies,
                   "rank_differing_tensors": len(differ),
                   "repeat_differing_tensors": None if rep is None
                   else len(rep), "update_rel_l2_vs_dp": rel,
                   "b1_by_card": by_card, "comm": cm, "comm_ms_per_step": comm_ms,
                   "comm_bound_ms": bound}
        say("tensor_parallel", form="fit", data=d, model=m, precision=prec,
            steps=TRAIN_WARMUP + TRAIN_STEPS, ms_per_step=f"{ms:.2f}",
            dp_ms_per_step_same_cards=f"{dp_ms[n]:.2f}",
            one_card_ms_per_step=f"{dp_ms[1]:.2f}",
            rank_differing_tensors=len(differ),
            repeat_differing_tensors=None if rep is None else len(rep),
            update_rel_l2_vs_dp=f"{rel:.3g}", limit=limit,
            dy_copies_per_step_per_rank=f"{copies:g}",
            b1_by_card=json.dumps(by_card).replace(" ", ""))
        say("tensor_parallel", form="a step's collectives replayed", data=d,
            model=m, precision=prec, gathers=cm["gathers"],
            all_reduces=cm["all_reduces"], small=cm["small_collectives"],
            gathered_mb=f"{gathered / 1e6:.1f}",
            reduced_mb=f"{reduced / 1e6:.1f}",
            data_grad_mb=f"{grads / 1e6:.2f}",
            gather_ms=f"{cm['gather_ms']:.3f}",
            of_which_collective_ms=f"{cm['gather_collective_ms']:.3f}",
            interleave_alone_ms=f"{cm['interleave_ms']:.3f}",
            all_reduce_ms=f"{cm['all_reduce_ms']:.3f}",
            small_ms=f"{cm['small_ms']:.3f}",
            data_grad_ms=f"{cm['data_grad_ms']:.3f}",
            total_ms=f"{comm_ms:.3f}", ring_bound_ms=f"{bound:.3f}",
            link=link)
        if differ or rep or rel > limit:
            raise AssertionError(f"d{d} m{m} {prec}: ranks differ in "
                                 f"{differ[:5]}, repeats in "
                                 f"{(rep or [])[:5]}, update {rel} from "
                                 f"data parallelism (limit {limit})")
    parity = next(j["parity"] for j in ranks[0]["jobs"]
                  if j["kind"] == "parity" and j["model"] == m)
    w["parity"] = parity
    got = _served_32(out / f"run1_m{m}_32" / "checkpoints" / "last.ckpt")
    served1 = int(np.abs(got.astype(int) - served_dp1.astype(int)).max())
    # after 12 steps (printed only): Adam's steps amplify roundoff, as
    # data parallelism's own n-rank checkpoints against its one-rank one
    # show, served the same way
    got12 = _served_32(out / f"run_m{m}_32_0" / "checkpoints" / "last.ckpt")
    served12 = int(np.abs(got12.astype(int)
                          - served_dp[d].astype(int)).max())
    spread = max(int(np.abs(v.astype(int) - served_dp[1].astype(int)).max())
                 for k, v in served_dp.items() if k > 1)
    w.update(served_1_step_vs_dp_counts=served1,
             served_12_steps_vs_dp_counts=served12,
             dp_12_steps_served_spread_counts=spread)
    say("tensor_parallel", form="checkpoint served", data=d, model=m,
        parity_grad_rel_l2=f"{parity['grad_rel_l2']:.3g}",
        one_step_vs_dp_checkpoint_counts=served1,
        one_step_differing_pixels=int((got != served_dp1).any(-1).sum()),
        limit=1, twelve_steps_vs_dp_checkpoint_counts=served12,
        dp_12_steps_n_ranks_vs_one_rank_counts=spread)
    if served1 > 1:
        raise AssertionError(f"d{d} m{m}: the one-step checkpoint served "
                             f"{served1} counts from data parallelism's")
    return w


# ---------------------------------------------------------------- orbax

ORBAX_CKPT = REPO / "docs" / "quality_2000" / "ours_ckpt" / "last"
ORBAX_DIGEST = REPO / "tests" / "data" / "orbax" / "quality_2000_last.json"
ORBAX_BLOCKED = ("jax", "orbax", "tensorstore", "zstandard",
                 "patch_toon_tpu")
ORBAX_FRAMES = 6  # frames of 512x910 served from the directory a mode
ORBAX_STEPS = 3   # fit steps resumed from it


def _leaf_digests(tree) -> list:
    """The digest file's records of a tree of nested dicts and lists:
    the path as ``jax.tree_util.keystr`` writes it, shape, dtype and the
    SHA-256 of the leaf's bytes, sorted by path."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + f"[{k!r}]")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + f"[{i}]")
        elif t is not None:
            a = np.asarray(t)
            out.append({"path": path, "shape": list(a.shape),
                        "dtype": str(a.dtype),
                        "sha256": hashlib.sha256(a.tobytes()).hexdigest()})

    walk(tree, "")
    return sorted(out, key=lambda r: r["path"])


def phase_orbax(dev, card: str, tmp: Path) -> dict:
    """The JAX package's Orbax checkpoint ``docs/quality_2000/ours_ckpt/
    last`` on the card, with jax, orbax, tensorstore, zstandard and the
    JAX package unimportable. (a) ``utils/orbax.py::read_tree`` (the
    port's OCDBT reader and zstd decoder) reads every leaf, each held to
    the committed digest (path, shape, dtype, SHA-256 of JAX's restore);
    the read's seconds and the decoder's MB/s, twice (the files warm in
    the page cache both times). (b) ``process_directory`` serves
    ``ORBAX_FRAMES`` frames of 512x910 from the directory at full width
    (its meta.json's generator args), tiled (2 groups) and full-frame at
    bf16, the counters zeroed just before and read just after each run
    (19 B1 launches a generator call in the variants ``plan`` gives, one
    B2 launch a tiled group); then the directory's export by
    ``tools/export_checkpoint_torch.py`` served tiled, every frame
    bitwise the directory's; precision 32 on a masked frame against the
    CPU engine on the same directory (limit 1 count). (c) ``fit`` at batch
    80, bf16, resumed from the directory (``resume_from``) for
    ``ORBAX_STEPS`` steps: Adam's moments as loaded bitwise the digest-checked tree
    mapped, the step and Adam's count going on from the checkpoint's, 25
    forward and 25 backward B1 cluster launches a step."""
    want = json.loads(ORBAX_DIGEST.read_text())["leaves"]
    counts = dict.fromkeys(LAUNCH_KINDS, 0)
    rec = {"source": str(ORBAX_CKPT.relative_to(REPO))}
    with _without_modules(ORBAX_BLOCKED):
        frameio_library()  # the codec's build at first use, not timed
        reads = []
        for _ in range(2):
            stats = orbax_reader.ReadStats()
            t0 = time.perf_counter()
            tree = orbax_reader.read_tree(ORBAX_CKPT, stats=stats)
            reads.append((time.perf_counter() - t0, stats))
        got = _leaf_digests(tree)
        if got != want:
            bad = [w["path"] for g, w in zip(got, want) if g != w]
            raise AssertionError(f"orbax: {len(got)} leaves read, "
                                 f"{len(want)} in the digest; differing "
                                 f"{bad[:5]}")
        for i, (sec, st) in enumerate(reads):
            rec[f"read_{i}"] = {
                "s": sec, "decode_s": st.decode_s, "chunks": st.chunks,
                "compressed_mb": st.compressed_bytes / 1e6,
                "decoded_mb": st.decoded_bytes / 1e6,
                "decoder_mb_per_s": st.decoded_bytes / 1e6 / st.decode_s,
                "read_mb_per_s": st.decoded_bytes / 1e6 / sec}
            say("orbax", read=i, leaves=len(got), digest="equal",
                seconds=f"{sec:.4f}", decode_s=f"{st.decode_s:.4f}",
                chunks=st.chunks,
                compressed_mb=f"{st.compressed_bytes / 1e6:.3f}",
                decoded_mb=f"{st.decoded_bytes / 1e6:.3f}",
                decoder_mb_per_s=f"{rec[f'read_{i}']['decoder_mb_per_s']:.1f}",
                read_mb_per_s=f"{rec[f'read_{i}']['read_mb_per_s']:.1f}",
                page_cache="first read" if i == 0 else "warm",
                card=f"'{card}'")

        scene, names = tmp / "orbax_scene", [f"{i:04d}.png"
                                              for i in range(ORBAX_FRAMES)]
        write_scene(scene, ORBAX_FRAMES, seed=4)
        for mode in ("tiled", "fullframe"):
            out = tmp / f"orbax_{mode}"
            eng = _dir_engine("bf16", scene, out, mode, ckpt=ORBAX_CKPT)
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            n = eng.process_directory()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got_counts = _read_counts()
            calls = -(-ORBAX_FRAMES // eng._group_size(len(eng.boxes_for(
                _full_mask(), (H, W))))) if mode == "tiled" else ORBAX_FRAMES
            _check_counts(f"orbax {mode}", got_counts, calls,
                          mode == "tiled", "bf16")
            for k in LAUNCH_KINDS:
                counts[k] += got_counts[k]
            frame = decode_png(out / names[-1])
            if n != ORBAX_FRAMES or frame.shape != (H, W, 3) \
                    or frame.std() < 1.0:
                raise AssertionError(f"orbax {mode}: {n} frames, last "
                                     f"{frame.shape} std {frame.std()}")
            rec[f"serve_{mode}_ms_per_frame"] = 1e3 * sec / ORBAX_FRAMES
            say("orbax", serve=mode, precision="bf16", frames=n,
                generator_calls=calls, ms_per_frame=f"{1e3 * sec / ORBAX_FRAMES:.2f}",
                first_run="yes (cuDNN set-up included)",
                launches=json.dumps(got_counts).replace(" ", ""),
                card=f"'{card}'")

        # its jax-free export (tools/export_checkpoint_torch.py), served
        # tiled: the directory's frames, bitwise
        export = _load_tool("export_checkpoint_torch")
        exported = tmp / "orbax_export.ckpt"
        t0 = time.perf_counter()
        export.save(export.export_state(ORBAX_CKPT), exported)
        export_s = time.perf_counter() - t0
        out = tmp / "orbax_exported"
        eng = _dir_engine("bf16", scene, out, "tiled", ckpt=exported)
        torch.cuda.synchronize()
        _zero_counts()
        n = eng.process_directory()
        torch.cuda.synchronize()
        got_counts = _read_counts()
        calls = -(-ORBAX_FRAMES // eng._group_size(len(eng.boxes_for(
            _full_mask(), (H, W)))))
        _check_counts("orbax exported", got_counts, calls, True, "bf16")
        for k in LAUNCH_KINDS:
            counts[k] += got_counts[k]
        same = [name for name in names if np.array_equal(
            decode_png(out / name), decode_png(tmp / "orbax_tiled" / name))]
        rec["export"] = {"seconds": export_s, "frames": n,
                         "bitwise_frames": len(same),
                         "mb": exported.stat().st_size / 1e6}
        say("orbax", export="tools/export_checkpoint_torch.py",
            seconds=f"{export_s:.3f}", mb=f"{rec['export']['mb']:.1f}",
            served_tiled=n, bitwise_the_directory=f"{len(same)}/{n}",
            launches=json.dumps(got_counts).replace(" ", ""))
        if n != ORBAX_FRAMES or len(same) != ORBAX_FRAMES:
            raise AssertionError(f"orbax export: {n} frames served, "
                                 f"{len(same)} bitwise the directory's")

        # precision 32: the card against the CPU engine, one directory
        cfg = dict(paths={"checkpoint": str(ORBAX_CKPT)},
                   inference={"precision": "32"})
        mask = np.zeros((H, W), np.float32)
        mask[200:330, 380:560] = 1
        eroded = erode_full_support_np(mask)
        frame = decode_png(scene / "input" / names[0])
        guide = decode_png(scene / "tracking" / names[0])
        x = np.concatenate([frame, guide], -1)[None]
        torch.cuda.synchronize()
        _zero_counts()
        got = StyleTransferInference(inference_config(**cfg)).stylize_group(
            x, [eroded])
        torch.cuda.synchronize()
        got_counts = _read_counts()
        _check_counts("orbax 32", got_counts, 1, True, "32")
        for k in LAUNCH_KINDS:
            counts[k] += got_counts[k]
        ref = StyleTransferInference(inference_config(**cfg),
                                     device="cpu").stylize_group(x, [eroded])
        d = np.abs(got.astype(int) - ref.astype(int))
        inside = eroded > 0
        changed = float((got[0][inside] != frame[inside]).mean())
        rec["card_vs_cpu_max_abs"] = int(d.max())
        say("orbax", card_vs_cpu="precision 32, a 130x180 masked region",
            max_abs=int(d.max()), differing_pixels=int((d > 0).sum()),
            changed_share_in_mask=f"{changed:.3f}")
        if d.max() > 1 or changed < 0.5:
            raise AssertionError(f"orbax: card vs CPU {d.max()} counts "
                                 f"(limit 1), {changed} of the mask changed")

        # resume fit
        step0 = int(tree["step"])
        adam = tree["g_opt"][2]
        count0 = int(adam["count"])
        model = _train_model("bf16", max_steps=step0 + ORBAX_STEPS)
        loaded = model.init_state(0, dev)
        CheckpointManager.restore(str(ORBAX_CKPT), loaded)
        gen = loaded.generator
        names_g = [k for k, _ in gen.named_parameters()]
        for which in ("mu", "nu"):
            sd = generator_state_from_jax(adam[which],
                                          tree["g_batch_stats"])
            mine = getattr(loaded.g_opt, which)
            bad = [k for k, t in zip(names_g, mine)
                   if not torch.equal(t.cpu(), sd[k])]
            if bad or loaded.g_opt.count != count0 or loaded.step != step0:
                raise AssertionError(f"orbax resume: {which} differs at "
                                     f"{bad[:5]}, count "
                                     f"{loaded.g_opt.count}, step "
                                     f"{loaded.step}")
        del loaded
        frames, pres, posts, masks, guides = _keyframes()
        data = StyleTransferDataset(pres, posts, masks, guides, [3],
                                    patch_size=PS, device=dev)
        torch.cuda.synchronize()
        _set_counts((0, 0, 0, 0))
        t0 = time.perf_counter()
        state = fit(model, data, str(tmp / "orbax_run"), seed=0,
                    resume_from=str(ORBAX_CKPT), progress=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        fwd, st, bwd, bst = _counts()
        finite = all(bool(torch.isfinite(t).all())
                     for t in _net_tensors(state).values())
        say("orbax", resumed_fit=f"from step {step0}", steps=ORBAX_STEPS,
            batch=BT, precision="bf16", step=state.step,
            adam_count=f"{count0}->{state.g_opt.count}",
            seconds_with_setup=f"{sec:.2f}", forward_launches=fwd,
            backward_launches=bwd, streaming=st + bst, finite=finite)
        if state.step != step0 + ORBAX_STEPS \
                or state.g_opt.count != count0 + ORBAX_STEPS \
                or state.d_opt.count != int(tree["d_opt"][2]["count"]) \
                + ORBAX_STEPS or not finite \
                or (fwd, st, bwd, bst) != (25 * ORBAX_STEPS, 0,
                                           25 * ORBAX_STEPS, 0):
            raise AssertionError(
                f"orbax resume: step {state.step}, counts "
                f"{state.g_opt.count} / {state.d_opt.count}, finite "
                f"{finite}, launches {(fwd, st, bwd, bst)}")
        rec["resume"] = {"step0": step0, "steps": ORBAX_STEPS,
                         "seconds_with_setup": sec}
        loaded_mods = sorted(k for k, v in sys.modules.items()
                             if v is not None
                             and k.split(".")[0] in ORBAX_BLOCKED)
    if loaded_mods:
        raise AssertionError(f"orbax: imported {loaded_mods}")
    return {"rec": rec, "launches": counts,
            "train": {"forward": fwd, "backward": bwd}}


# ---------------------------------------------------------------- cli

# the cli phase's processes: train_torch.py or generator_torch.py as
# __main__ with PyYAML unimportable (the card's machine has none); fit's
# steps 2 and 12 marked (synchronized) for the step time, and on the way
# out every B1 and B2 launch count of the process
CLI_SERVICE = r"""
import json, runpy, sys, time
sys.modules["yaml"] = None
script = sys.argv[1]
sys.argv = [script] + sys.argv[2:]
import torch
from patch_toon_tpu_torch.ops import blend, instance_norm as b1
from patch_toon_tpu_torch.train import loop

def counts():
    return {"cluster": b1.instance_norm_act_cluster.launches,
            "resident": b1.instance_norm_act_resident.launches,
            "split": b1.instance_norm_act_split.launches,
            "sample": b1.instance_norm_act_sample.launches,
            "streaming": b1.instance_norm_act_streaming.launches,
            "backward_cluster": b1.instance_norm_act_backward_cluster.launches,
            "backward_sample": b1.instance_norm_act_backward_sample.launches,
            "backward_streaming":
                b1.instance_norm_act_backward_streaming.launches,
            "blend": blend.blend_tiles.launches}

marks, fit = {}, loop.fit

def marked_fit(*args, **kw):
    def on_step(step, metrics):
        if step in (2, 12):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            marks[step] = (time.perf_counter(), counts())
    return fit(*args, on_step=on_step, **kw)

loop.fit = marked_fit
try:
    runpy.run_path(script, run_name="__main__")
finally:
    print("LAUNCHES " + json.dumps({"counts": counts(), "marks": marks}),
          flush=True)
"""
CLI_STEPS = 12             # the CLI's training.max_steps; steps 3-12 timed
CLI_SCENE = "test_dataset/PlatinumChan_x0.5_train"  # config/data/default.yaml
CLI_TRAIN_EXTRA: list = []  # CPU rehearsals: widths and the accelerator
CLI_SERVE_EXTRA: list = []


def _cli_process(script: str, args: list, cwd: Path, log: Path) -> dict:
    """``script`` run as __main__ in a process of its own (CLI_SERVICE)
    from ``cwd``; -> its counts and fit's step marks."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", CLI_SERVICE,
                          str(REPO / script), *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    log.write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"{script} exited {res.returncode}: "
                             f"{(res.stdout + res.stderr)[-3000:]}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("LAUNCHES ")][-1]
    out = json.loads(line[len("LAUNCHES "):])
    out["seconds"] = time.perf_counter() - t0
    out["stdout"] = res.stdout
    return out


def phase_cli(dev, card: str, tmp: Path) -> dict:
    """The CLIs as a user runs them, each a process of its own with PyYAML
    unimportable: ``python train_torch.py`` at the shipped configuration
    (batch 80 of 80x80 patches, GeneratorJ at full width, VGG [0, 3, 5]),
    from a directory without the sample scene, so that the CLI makes the
    7-frame 270x480 scene under ``test_dataset/`` itself;
    ``training.max_steps=12`` at precision 32 and bf16, ms a step over
    steps 3-12 (the process synchronizes at steps 2 and 12), 25 forward
    and 25 backward B1 cluster launches a step counted inside the
    process; ``<run>/config.yaml`` read back by ``config/yamlio.py`` equal
    to the tree ``compose`` resolves for the same overrides, its bytes
    ``yamlio.dump``'s. Then ``python generator_torch.py model=default
    ...`` serves the scene from the precision-32 run's ``last.ckpt`` at the
    inference defaults (tiled, bf16), its B1 and B2 launches counted
    inside the process, every frame bitwise an in-process
    ``StyleTransferInference`` on the same checkpoint and config, whose
    launches, counted here, are the same."""
    from patch_toon_tpu_torch import cli
    from patch_toon_tpu_torch.config import yamlio
    from patch_toon_tpu_torch.config.compose import compose, to_container

    work = tmp / "cli"
    work.mkdir()
    scene = work / CLI_SCENE
    rec, launches = {}, {"train": dict.fromkeys(("forward", "backward"), 0)}
    for prec in ("32", "bf16"):
        run = work / f"run_{prec}"
        args = [f"training.precision={prec}",
                f"training.max_steps={CLI_STEPS}", f"run.dir={run}",
                *CLI_TRAIN_EXTRA]
        fresh = not scene.exists()
        got = _cli_process("train_torch.py", args, work,
                           tmp / f"cli_train_{prec}.log")
        (t2, c2), (t12, c12) = (got["marks"][str(k)] for k in (2, 12))
        steps = CLI_STEPS - 2
        fwd = c12["cluster"] - c2["cluster"]
        bwd = c12["backward_cluster"] - c2["backward_cluster"]
        others = {k: c12[k] - c2[k] for k in c12
                  if k not in ("cluster", "backward_cluster")}
        ms = 1e3 * (t12 - t2) / steps
        made = sorted(p.name for p in (scene / "input").glob("*.png"))
        tree = to_container(compose(REPO / "config", "config",
                                    overrides=args))
        text = (run / "config.yaml").read_text()
        ckpts = sorted(p.name for p in (run / "checkpoints").glob("*.ckpt"))
        say("cli", entry="train_torch.py", precision=prec,
            scene_generated=fresh, scene_frames=len(made),
            scene_size="x".join(map(str, decode_png(
                scene / "input" / made[0]).shape[:2])),
            steps=CLI_STEPS, timed_steps=steps, ms_per_step=f"{ms:.2f}",
            patches_per_s=f"{BT / ms * 1e3:.1f}",
            forward_launches_per_step=fwd / steps,
            backward_launches_per_step=bwd / steps,
            other_b1_launches=sum(others.values()),
            process_seconds=f"{got['seconds']:.1f}",
            config_snapshot_equal=yamlio.load(text) == tree,
            config_bytes_equal=text == yamlio.dump(tree),
            checkpoints=",".join(ckpts), card=f"'{card}'")
        on_card = "on cuda" in got["stdout"] or bool(CLI_TRAIN_EXTRA)
        if fresh != (prec == "32") or len(made) != 7 or not on_card:
            raise AssertionError(f"train_torch.py {prec}: scene generated "
                                 f"{fresh}, {len(made)} frames, on the "
                                 f"card {on_card}")
        if fwd != 25 * steps or bwd != 25 * steps or any(others.values()):
            raise AssertionError(f"train_torch.py {prec}: B1 launches "
                                 f"{fwd} forward, {bwd} backward cluster, "
                                 f"{others} others in {steps} steps")
        if yamlio.load(text) != tree or text != yamlio.dump(tree) \
                or "last.ckpt" not in ckpts:
            raise AssertionError(f"train_torch.py {prec}: the run directory "
                                 "does not hold the resolved config and "
                                 "last.ckpt")
        launches["train"]["forward"] += got["counts"]["cluster"]
        launches["train"]["backward"] += got["counts"]["backward_cluster"]
        rec[f"train_{prec}"] = {"ms_per_step": ms,
                                "patches_per_s": BT / ms * 1e3,
                                "process_seconds": got["seconds"]}

    ckpt = work / "run_32" / "checkpoints" / "last.ckpt"
    args = ["model=default", f"paths.checkpoint={ckpt}",
            f"paths.input_dir={scene / 'input'}",
            f"paths.mask_dir={scene / 'mask'}",
            f"paths.output_dir={work / 'served'}",
            "paths.additional_channels.point_vector.path="
            f"{scene / 'tracking'}", *CLI_SERVE_EXTRA]
    got = _cli_process("generator_torch.py", args, work,
                       tmp / "cli_serve.log")
    cfg = cli.load_config(args[:4] + [f"paths.output_dir={work / 'inline'}"]
                          + args[5:])
    _zero_counts()
    n = StyleTransferInference(cfg).process_directory()
    torch.cuda.synchronize()
    inline = _read_counts()
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    worst, differ = _compare_dirs(work / "served", work / "inline", names)
    served = {k: got["counts"][k] for k in inline}
    say("cli", entry="generator_torch.py", config_group="model=default",
        precision=cfg["inference"]["precision"],
        mode=cfg["inference"]["mode"], frames=n,
        process_seconds=f"{got['seconds']:.1f}",
        b1_launches=json.dumps(served).replace(" ", ""),
        inline_launches=json.dumps(inline).replace(" ", ""),
        vs_inline_max_abs=worst, differing_pixels=differ, card=f"'{card}'")
    if (n != 7 or worst or differ or served != inline
            or not served["cluster"] or served["cluster"] % 19
            or not served["blend"]):
        raise AssertionError(f"generator_torch.py: {n} frames, {worst} "
                             f"counts off the in-process engine, launches "
                             f"{served} against {inline}")
    launches["serve"] = {"cluster": served["cluster"],
                         "blend": served["blend"]}
    rec["serve"] = {"frames": n, "process_seconds": got["seconds"]}
    return {"rec": rec, "launches": launches}


def main_multi_gpu(t0: float, card: str) -> int:
    """``--multi-gpu``: the build, the multi_gpu phase and the NCCL forms
    of tensor_parallel alone."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = phase_multi_gpu(Path(tmp))
        tp = phase_tensor_parallel_multi(Path(tmp))
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"multi_gpu": rec, "tensor_parallel": tp}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    signal.alarm(0)
    return 0


def main() -> int:
    multi_only = "--multi-gpu" in sys.argv[1:]
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
    with _clock("build"):
        phase_build()
    if multi_only:
        return main_multi_gpu(t0, card)
    with _clock("instance_norm"):
        rec_in = phase_instance_norm(dev)
    with _clock("instance_norm_fullframe"):
        rec_ff = phase_instance_norm_fullframe(dev)
    with _clock("blend"):
        rec_bl = phase_blend(dev)
    with _clock("signed_unit"):
        phase_signed_unit(dev)
    with _clock("main_path"):
        launches = phase_main_path(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        with _clock("serve_directory"):
            served = phase_serve_directory(dev, card, Path(tmp))
        with _clock("fullframe"):
            full = phase_fullframe(dev, card, Path(tmp), served["rec"])
        with _clock("precision_32_fast"):
            fast = phase_precision_32_fast(dev, card, Path(tmp))
        with _clock("temporal"):
            chain = phase_temporal(dev, card, Path(tmp))
        with _clock("temporal_device"):
            dflow = phase_temporal_device(dev, card, Path(tmp))
        with _clock("single_image"):
            single = phase_single_image(dev, card, Path(tmp))
        with _clock("watch"):
            watch = phase_watch(dev, card, Path(tmp))
        with _clock("multistream"):
            multi = phase_multistream(dev, card, Path(tmp))
        with _clock("int8"):
            int8 = phase_int8(dev, card, Path(tmp), served["rec"], full["rec"])
        with _clock("transport"):
            transport = phase_transport(dev, card, Path(tmp))
    with _clock("instance_norm_backward"):
        rec_bw = phase_instance_norm_backward(dev)
    with tempfile.TemporaryDirectory() as tmp:
        with _clock("train"):
            train = phase_train(dev, card, Path(tmp))
        with _clock("train_rest"):
            rest = phase_train_rest(dev, card, Path(tmp))
        with _clock("deep_vgg"):
            deep = phase_deep_vgg(dev, card, Path(tmp))
        with _clock("tensor_parallel"):
            tp = phase_tensor_parallel(dev, card, Path(tmp), train["final"])
    with tempfile.TemporaryDirectory() as tmp:
        with _clock("multi_gpu"):
            mgpu = phase_multi_gpu(Path(tmp), train.pop("final"))
        with _clock("tensor_parallel_multi"):
            tp_multi = phase_tensor_parallel_multi(Path(tmp)) \
                if torch.cuda.device_count() > 1 else {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        with _clock("guides"):
            guides = phase_guides(dev, card, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        with _clock("pipeline"):
            pipeline = phase_pipeline(dev, card, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        with _clock("orbax"):
            ob = phase_orbax(dev, card, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        with _clock("cli"):
            clip = phase_cli(dev, card, Path(tmp))
    # no phase but int8 (and multi_gpu's 2-card int8) launches them
    want = {k: n + mgpu["launches"][f"int8_{k}"]
            + transport["int8_total"][k] for k, n in int8["after"].items()}
    if _quant_counts() != want:
        raise AssertionError(f"int8 kernels launched outside the int8 "
                             f"runs: {_quant_counts()} against {want}")
    q_launches = {f"int8_{mode}": n["conv_s8"]
                  for mode, n in int8["launches"].items()}
    q_launches["multi_gpu_int8"] = mgpu["launches"]["int8_conv_s8"]
    q_launches["transport_int8"] = transport["int8"]["conv_s8"]
    i8 = int8["rec"]["sites"]
    # launches of B1's cluster variant and of B2 by path: the serving
    # paths of every phase, one entry each
    cluster = {"serve": launches["instance_norm_act"],
               "serve_directory": served["launches"]["instance_norm_act"],
               "temporal_tiled": chain["launches"]["cluster"],
               "temporal_device_tiled": dflow["launches"]["cluster"],
               "32_fast_serve": fast["launches"]["cluster"],
               "single_image": single["launches"]["cluster"],
               "watch": watch["launches"]["cluster"],
               "multistream": multi["launches"]["cluster"],
               "multi_gpu_serve": mgpu["launches"]["cluster"],
               "int8_serve_directory": int8["launches"]["tiled"]["cluster"],
               "transport": transport["launches"]["cluster"],
               "pipeline": pipeline["cluster"],
               "orbax_serve": ob["launches"]["cluster"],
               "cli_serve": clip["launches"]["serve"]["cluster"]}
    blends = {"serve": launches["blend_tiles"],
              "serve_directory": served["launches"]["blend_tiles"],
              "temporal_tiled": chain["launches"]["blend"],
              "temporal_device_tiled": dflow["launches"]["blend"],
              "32_fast_serve": fast["launches"]["blend"],
              "single_image": single["launches"]["blend"],
              "watch": watch["launches"]["blend"],
              "multistream": multi["launches"]["blend"],
              "multi_gpu_serve": mgpu["launches"]["blend"],
              "int8_serve_directory": int8["launches"]["tiled"]["blend"],
              "transport": transport["launches"]["blend"],
              "pipeline": pipeline["blend"],
              "orbax_serve": ob["launches"]["blend"],
              "cli_serve": clip["launches"]["serve"]["blend"]}
    # launches of B1's resident and split variants by full-frame path
    # B1 on tensor parallelism's channel slices: the one-card forms, fit at
    # devices 1 x model 2, and the NCCL forms where there are 2+ cards
    tp_fwd = {v: tp["launches"].get(v, 0) + tp_multi["launches"].get(v, 0)
              + tp["autograd_launches"].get(v, 0) for v in B1_WRAPPERS}
    tp_fwd["cluster"] += tp["fit_launches"]["forward"]
    tp_bwd = {v: tp_multi["launches"].get(f"backward_{v}", 0)
              + tp["autograd_launches"].get(f"backward_{v}", 0)
              for v in B1_BWD}
    tp_bwd["cluster"] += tp["fit_launches"]["backward"]
    cluster["tensor_parallel"] = tp_fwd["cluster"]
    full_frame = {v: {"fullframe": full["launches"][v],
                      "temporal_fullframe": chain["launches"][v],
                      "temporal_device_fullframe": dflow["launches"][v],
                      "32_fast_serve": fast["launches"][v],
                      "single_image": single["launches"][v],
                      "watch": watch["launches"][v],
                      "multistream": multi["launches"][v],
                      "multi_gpu_serve": mgpu["launches"][v],
                      "int8_fullframe": int8["launches"]["fullframe"][v],
                      "transport": transport["launches"][v],
                      "tensor_parallel": tp_fwd[v],
                      "orbax_serve": ob["launches"][v]}
                  for v in ("resident", "split")}
    ff_frame = {k: v for k, v in rec_ff.items()
                if k not in ("resident", "split")}
    rec_in["variants"]["cluster"]["launches"] = sum(cluster.values())
    rec_in["variants"]["streaming"]["launches"] = launches[
        "instance_norm_act_streaming"] + served["launches"][
        "instance_norm_act_streaming"] + rest["launches"][
        "forward_streaming"] + tp_fwd["streaming"]
    rec_in["variants"]["streaming"]["launches_by_path"] = {
        "tensor_parallel": tp_fwd["streaming"]}
    # B1 on tensor parallelism's channel slices, timed by variant over a
    # rank's 25 sites of one training step (forward; backward below); the
    # streaming kernels at the sample variant's sites, which they took
    # before it
    tp_steps = tp["rec"]["slice_kernels"]["per_step"]
    rec_in["variants"]["streaming"]["tensor_parallel_slices"] = {
        k: {"sites": v["forward_sample"]["sites"],
            "ms": v["forward_sample"]["old_ms"]}
        for k, v in tp_steps.items() if "forward_sample" in v}
    tile_sample = rec_in.pop("sample_tile_call")
    odd_c = rec_in.pop("odd_c_tile_call")
    sample_steps = {d: {k: t[f"{d}_sample"] for k, t in tp_steps.items()
                        if f"{d}_sample" in t}
                    for d in ("forward", "backward")}
    # the sample variant's headline: a rank's 3 D sites of a bf16 step at
    # model 2; launches by path: the sharded forwards in turn (and the
    # NCCL forms' fits), and B1 under autograd at a rank's sites of a step
    sample_paths = {
        d: {"tensor_parallel": tp["launches"].get(v, 0)
            + tp_multi["launches"].get(v, 0),
            "tensor_parallel_autograd_step": tp["autograd_launches"].get(
                v, 0)}
        for d, v in (("forward", "sample"), ("backward", "backward_sample"))}
    train_fwd = {"train": train["launches"]["forward"]
                 - train["launches"]["forward_32_fast"]
                 + rest["launches"]["forward"],
                 "32_fast_train": train["launches"]["forward_32_fast"],
                 "multi_gpu_train": mgpu["launches"]["train_forward"],
                 "orbax_resume": ob["train"]["forward"],
                 "deep_vgg_train": deep["launches"]["forward"],
                 "cli_train": clip["launches"]["train"]["forward"]}
    rest_bwd = {"cluster": rest["launches"]["backward"],
                "streaming": rest["launches"]["backward_streaming"]}
    kernels = [
        dict(name="instance_norm_act", route="cuda",
             source="patch_toon_tpu_torch/csrc/instance_norm.cu",
             replaces="patch_toon_tpu/ops/pallas_norm.py:52",
             launches=sum(cluster.values()) + sum(train_fwd.values()),
             launches_by_path={**cluster, **train_fwd},
             dtype="bf16", variant="cluster",
             per="19 sites of one 512-tile generator call", **rec_in),
        dict(name="instance_norm_act_resident", route="cuda",
             source="patch_toon_tpu_torch/csrc/instance_norm_resident.cu",
             replaces="patch_toon_tpu/ops/pallas_norm.py:52",
             launches=sum(full_frame["resident"].values()),
             launches_by_path=full_frame["resident"],
             dtype="bf16", variant="resident",
             note="one cooperative launch; split_ms is the split variant "
                  "at the same sites, timed in turns with it",
             per=f"the {rec_ff['resident']['sites']} sites of a 512x912 "
                 "full-frame pass that plan gives it at bf16 "
                 f"({rec_ff['resident']['sites_fp32']} at fp32)",
             fullframe_pass=ff_frame, **rec_ff["resident"]),
        dict(name="instance_norm_act_split", route="cuda",
             source="patch_toon_tpu_torch/csrc/instance_norm_split.cu",
             replaces="patch_toon_tpu/ops/pallas_norm.py:52",
             launches=sum(full_frame["split"].values()),
             launches_by_path=full_frame["split"],
             dtype="bf16", variant="split",
             note="two launches (statistics, normalize) counted as one",
             per=f"the {rec_ff['split']['sites']} site(s) of a 512x912 "
                 "full-frame pass that plan gives it at bf16 "
                 f"({rec_ff['split']['sites_fp32']} at fp32)",
             **rec_ff["split"]),
        *[dict(name=f"instance_norm_act_backward_{v}", route="cuda",
               source="patch_toon_tpu_torch/csrc/instance_norm_bwd.cu",
               replaces="patch_toon_tpu/ops/pallas_norm.py:52",
               note="backward pass of B1; the Pallas kernel has none (JAX "
                    "differentiates patch_toon_tpu/models/layers.py:29-40)",
               launches=train["launches"][key] + rest_bwd[v]
               + (mgpu["launches"]["train_backward"]
                  + ob["train"]["backward"]
                  + deep["launches"]["backward"]
                  + clip["launches"]["train"]["backward"] if v == "cluster"
                  else 0) + tp_bwd[v], dtype="bf16",
               variant=v,
               launches_by_path={
                   "train": train["launches"][key] + rest_bwd[v]
                   - (train["launches"]["backward_32_fast"]
                      if v == "cluster" else 0),
                   "32_fast_train": train["launches"]["backward_32_fast"]
                   if v == "cluster" else 0,
                   "multi_gpu_train": mgpu["launches"]["train_backward"]
                   if v == "cluster" else 0,
                   "orbax_resume": ob["train"]["backward"]
                   if v == "cluster" else 0,
                   "deep_vgg_train": deep["launches"]["backward"]
                   if v == "cluster" else 0,
                   "cli_train": clip["launches"]["train"]["backward"]
                   if v == "cluster" else 0,
                   "tensor_parallel": tp_bwd[v]},
               picked_by_plan_backward=v == "cluster",
               tensor_parallel_slices={
                   k: t[f"backward_{v}"] for k, t in tp_steps.items()
                   if f"backward_{v}" in t} if v == "cluster" else {
                   k: {"sites": t["backward_sample"]["sites"],
                       "ms": t["backward_sample"]["old_ms"],
                       "dy_copy_ms": t["backward_sample"]["dy_copy_ms"]}
                   for k, t in tp_steps.items() if "backward_sample" in t},
               per="the 25 sites of one training step at batch 80",
               **rec_bw[v])
          for v, key in (("cluster", "backward"),
                         ("streaming", "backward_streaming"))],
        *[dict(name=name, route="cuda",
               source="patch_toon_tpu_torch/csrc/instance_norm_sample.cu",
               replaces="patch_toon_tpu/ops/pallas_norm.py:52",
               note=note,
               launches=sum(sample_paths[d].values()),
               launches_by_path=sample_paths[d],
               max_abs_err=max([t["max_abs_err"]
                                for t in sample_steps[d].values()]
                               + [forced["max_abs_err"],
                                  forced["max_abs_err_fp32"]]),
               ms=sample_steps[d]["bf16_m2"]["ms"],
               plain_ms=sample_steps[d]["bf16_m2"]["plain_ms"],
               bound_ms=sample_steps[d]["bf16_m2"]["bound_ms"],
               bound_by="bytes",
               library_ms=sample_steps[d]["bf16_m2"]["library_ms"],
               dtype="bf16", variant="sample",
               per="a rank's 3 sample-variant sites (D's 12-channel "
                   "slices) of one bf16 training step at model 2",
               tensor_parallel_slices=sample_steps[d],
               **{forced_key: forced}, **more)
          for d, name, note, forced_key, forced, more in (
              ("forward", "instance_norm_act_sample",
               "a whole sample in shared memory at any C; "
               "tensor_parallel_slices[*].old_ms: the streaming kernel at "
               "the same sites, k2_ms: twice the CTAs a sample",
               "tile_call_forced", tile_sample,
               {"odd_c_tile_call": odd_c}),
              ("backward", "instance_norm_act_backward_sample",
               "backward pass of B1 (JAX differentiates "
               "patch_toon_tpu/models/layers.py:29-40), dy read through its "
               "pixel stride; tensor_parallel_slices[*].old_ms: the "
               "streaming backward at the same sites after dy_copy_ms",
               "train_sites_forced", rec_bw["sample_train_sites"], {}))],
        dict(name="blend_tiles", route="cuda",
             source="patch_toon_tpu_torch/csrc/blend.cu",
             replaces="patch_toon_tpu/ops/pallas_blend.py:116",
             launches=sum(blends.values()), launches_by_path=blends,
             per="one group of 3 512x910 frames", **rec_bl),
        dict(name="splat_points", route="cuda",
             source="patch_toon_tpu_torch/csrc/splat.cu",
             replaces="patch_toon_tpu/ops/splat.py:23 (lax.scan, not a "
                      "Pallas kernel)",
             launches=guides["launches"] + pipeline["splat"],
             launches_by_path={"guides": guides["launches"],
                               "pipeline": pipeline["splat"]},
             per=f"one 512x910 frame, {guides['rec']['splat']['points']} "
                 "points, sigma 15",
             library_note="no single PyTorch call composites ordered "
                          "alpha blobs",
             **{k: v for k, v in guides["rec"]["splat"].items()
                if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}),
        dict(name="conv_s8", route="cuda",
             source="patch_toon_tpu_torch/csrc/quant_conv.cu",
             replaces="patch_toon_tpu/models/layers.py:165 (QuantConv: "
                      "XLA's int8 conv_general_dilated, not a Pallas "
                      "kernel)",
             launches=sum(q_launches.values()),
             launches_by_path=q_launches,
             launches_by_kernel={
                 v: sum(n[f"conv_s8_{v}"] for n in int8["launches"].values())
                 for v in quant.VARIANTS},
             kernels_note="ops/quant.py::conv_plan picks the kernel a site: "
                          "the halo kernel at conv11 and the smoothers, the "
                          "gather kernel at the other 19; launches_by_kernel "
                          "counts the int8 serving runs",
             max_abs_err=0.0,
             ms=i8["conv_ms"], plain_ms=i8["conv_plain_ms"],
             bound_ms=i8["conv_bound_ms"], bound_by="operations"
             if i8["conv_ops_ms"] >= i8["conv_bytes_ms"] else "bytes",
             library_ms=i8["int_mm_ms"],
             library_note="torch._int_mm over each site's explicit im2col "
                          "(no PyTorch call convolves int8 on the card), "
                          "timed on at most 2 GB of im2col and scaled to "
                          "512 tiles, the im2col's own time excluded; "
                          "cuDNN's bf16 F.conv2d at the same sites "
                          f"{i8['library_ms']:.4f} ms",
             dtype="bf16", per="the 22 sites of one 512-tile generator "
                               "call"),
        dict(name="quantize_act", route="cuda",
             source="patch_toon_tpu_torch/csrc/quant_conv.cu",
             replaces="patch_toon_tpu/models/layers.py:165 (QuantConv's "
                      "activation quantization, XLA elementwise)",
             launches=sum(int8["launches"][m]["quantize_act"]
                          for m in int8["launches"])
             + mgpu["launches"]["int8_quantize_act"]
             + transport["int8"]["quantize_act"],
             launches_by_path={
                 **{f"int8_{m}": n["quantize_act"]
                    for m, n in int8["launches"].items()},
                 "multi_gpu_int8": mgpu["launches"]["int8_quantize_act"],
                 "transport_int8": transport["int8"]["quantize_act"]},
             max_abs_err=0.0, ms=i8["quant_ms"],
             plain_ms=i8["quant_plain_ms"], bound_ms=i8["quant_bound_ms"],
             bound_by="bytes", library_ms=None,
             library_note="no single PyTorch call quantizes to int8 "
                          "against a scale on the device with the "
                          "channels padded",
             dtype="bf16", per="the 22 sites of one 512-tile generator "
                               "call"),
    ]
    say("done", seconds=f"{time.perf_counter() - t0:.1f}",
        phase_seconds=json.dumps(PHASE_SECONDS).replace(" ", ""))
    print(json.dumps({"kernels": kernels, "train": train["rec"],
                      "serve_directory": served["rec"],
                      "fullframe": full["rec"], "temporal": chain["rec"],
                      "temporal_device": dflow["rec"],
                      "precision_32_fast": fast["rec"],
                      "single_image": single["rec"], "watch": watch["rec"],
                      "multistream": multi["rec"], "int8": int8["rec"],
                      "transport": transport["rec"],
                      "train_rest": rest["rec"], "guides": guides["rec"],
                      "pipeline": pipeline["rec"], "orbax": ob["rec"],
                      "deep_vgg": deep["rec"],
                      "cli": clip["rec"],
                      "main_path_plans": launches["plans"],
                      "multi_gpu": mgpu, "tensor_parallel": {
                          "one_card": tp["rec"],
                          "nccl": tp_multi.get("rec")}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
