"""Video stylization on one device or several: tiled, full-frame, temporal.

Counterpart of ``patch_toon_tpu/infer/engine.py::StyleTransferInference``
in ``tiled`` mode (the reference's semantics, the default) and
``fullframe`` mode (one generator pass over each whole frame, JAX
``engine.py:447-456``; a group is one frame), each alone or with the
temporal guide chain, its flows read from files or computed on the device
(``infer/temporal.py``).
``process_directory`` streams a directory of frames as
the JAX engine does (``engine.py:669-834``): two prefetch threads decode
each frame with its guide channels (the port's native PNG codec), erode its
mask, place its tiles and stage it for upload six frames ahead
(:meth:`_load_for_dispatch`); the main thread co-batches frames so one
generator batch holds about ``inference.tile_batch`` tiles
(``frames_per_dispatch``: three 512x910 frames of 170 tiles go in one
batch, of 510 rows at bf16, 512 at fp32) and dispatches each group;
``infer/pipeline.py``'s :class:`GroupPipeline` keeps the readbacks in flight and hands each frame
to the native asynchronous writer. A file that fails to load is named and
skipped, a group whose dispatch fails is dropped and each of its frames
named (reference generator.py:700-705), and on an interrupt, an error or
the end every dispatched frame reaches disk or is logged. The output files
are those of :meth:`stylize_group`, the public synchronous call, run group
by group.

Semantics kept from the JAX engine: the channel count sniffed from the
checkpoint must match the configured guide channels (an Orbax directory's
from its ``meta.json`` or its first kernel's ``.zarray``, before any
weight is read; its ``generator_args`` override the configured ones);
masks are binarized (> 128), then eroded with the 7x7 full-support rule;
a missing mask directory whose name ends in ``ignore`` means full-frame
stylization; a fractional mask given to :meth:`stylize_group` is uploaded
as fp32 and composites in part (JAX ``_mask_up``); ``debug_mode`` writes
``debug_<name>`` beside each frame with its tile boxes outlined.

Precision ``32`` runs fp32 with TF32 off in cuDNN and matmuls and the
fp32 matmul precision at "highest" (the JAX contract is HIGHEST precision,
patch_toon_tpu/models/layers.py:91-93 for the upsample's products and
:100-119 for the convs). ``32_fast`` (aliases ``tf32``, ``fp32_fast``) is
fp32 with the same strict flags, the generator's convs at JAX's
``Precision.HIGH``: three TF32 products of a hi/lo split, TF32 allowed for
those products alone (``models/layers.py::conv2d_3xtf32``); the upsample's
products stay at "highest", as in JAX.
``bf16`` (the default) runs the convs in bf16 while InstanceNorm statistics
and the smoother BatchNorm stay fp32, as in JAX.

The public single-frame calls are :meth:`process_large_image` (a frame in
memory, fp32 in [-1, 1] or uint8, an optional mask, fractional masks
compositing in part) and :meth:`process_image` (files in, a PNG out); a
group of frames goes through :meth:`stylize_group`. Watch mode
(``inference.watch.enabled``, :meth:`watch_directory`, ``infer/watch.py``)
polls the input directory; a subdirectory per video with the temporal
guide is served as co-batched chains (``infer/multistream.py``).

Several devices (JAX ``engine.py:583-621, 769-777, 837-946``):
``inference.devices`` N (or -1, every card the process owns,
``parallel.local_devices``; N CPU entries on the CPU) loads one replica of
the generator a device, its weights copied. ``process_directory`` then
groups ``D x fpd`` frames in tiled mode (``fpd`` decided from the first
frame by the one-device rule) and ``D`` in full-frame mode, and card ``k``
runs the one-device program on the group's ``k``-th chunk of ``fpd``
frames (one in full-frame mode) on its own streams: the counterpart of
``make_pod_multiframe_fn`` (``make_pod_tiled_fn`` is its ``fpd = 1``
case) and ``make_batched_fullframe_fn``. JAX pads the last group by
repeating its last frame; here its last chunk is short instead, so no
card runs a repeated frame, and the frames are read back in frame order.
JAX pads every tile batch to its XLA bucket
(``infer/tiling.py::bucket_size``); ``_pack`` does so only where the
generator runs cuDNN's full fp32 convolutions (precision ``32`` without
int8), whose fast route depends on the batch size, and packs the group's
real tiles at bf16, ``32_fast`` and int8. The host side
scales with D: D times the prefetch and writer threads and the frames
staged ahead, and two groups in flight (the pipeline's window at least
``2 x D x fpd`` frames). Each chunk is a one-device group, so the output
is the one-device run's. A frame is staged on the card its chunk will
run on (predicted from its position; a frame that lands elsewhere is
copied).
The temporal chain runs on the first device whatever ``devices`` says (it
is sequential), and multi-stream serving refuses ``devices != 1``, as in
JAX. ``inference.file_shard: "i/N"`` serves ``files[i::N]``; in a process
group (``parallel.dcn.enabled``, the CLI joins it) the shard is the rank's
when none is given, and with the temporal guide only rank 0 serves (an
explicit shard with the temporal guide raises ``ValueError``).

``inference.quantize: int8`` (alias ``w8a8``; JAX ``engine.py:162-176,
372-418``) serves every generator conv but the 1x1 head as w8a8
(``models/layers.py::QuantConv2d``, the kernels of ``ops/quant.py``):
the weights quantize per output channel from the fp32 checkpoint at load,
and the activation scales calibrate once, on the frame the engine's first
dispatch sees (:meth:`_ensure_quant`: one calib-mode forward over it on
the first device; under ``crop_upload`` that is the first frame's upload
window, as in JAX), in every entry point (:meth:`_run`,
:meth:`_stylize_group`, the multi-stream cycle's, before the card loop
of :meth:`_dispatch_sharded`); every replica then serves with the first
device's scales. Each ``file_shard`` process calibrates on its own first
frame, as in JAX. A throughput knob, not bit parity; off by default.

The transport knobs (JAX ``engine.py:180-233``, ``utils/knobs.py``) change
no output, as in JAX; they cut the bytes that cross the bus:

- ``mask_upload: packed`` (the default): a {0, 1} mask goes up bit-packed
  (``infer/common.py::pack_mask``, 8x fewer bytes than the uint8 plane)
  and the programs unpack it on the device (``mask_f32``); so does the
  device flow's raw mask, unpacked inside its CUDA graph. A fractional mask
  goes up as an fp32 plane. ``plane``: every mask as a plane.
- ``crop_upload`` (``auto``, the default, follows ``crop_readback``): a
  masked frame served tiled by :meth:`process_directory` without the
  temporal guide goes up as ``upload_crop_window`` of its tiles and mask
  support (sides in 128-multiples), its tile boxes shifted into the
  window; the program runs on the window, and the window's output is read
  back whole and pasted into the input's RGB bytes. A group holds frames
  of one shape and one croppedness (JAX ``engine.py:801-812``).
- ``crop_readback`` (``auto``, on): otherwise only ``compute_crop_bbox``
  of the group's mask supports (64-aligned) is read back and pasted: in
  tiled and full-frame directories, the temporal chain (its carry stays
  whole on the device) and each multi-stream frame (its own box).
  ``_last_crop`` keeps the last group's window or box.

:meth:`process_large_image` and :meth:`process_image` crop nothing, as in
JAX; their binary masks go up packed. ``xla_options`` is validated and
inert (no XLA compiler here). ``upload`` is validated as JAX does and
decides ``temporal.flow_upload: auto`` (f16 unless it resolves to f32),
which rounds the flows.

A mode other than tiled and fullframe raises ``ValueError``.
``readback_streams`` sets
the pipeline's in-flight window (its value plus 2 frames, the JAX rule).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patch_toon_tpu_torch.data.io import (
    decode_rgb_uint8,
    find_corresponding_image,
    image_bands,
    load_luma,
    load_mask,
)
from patch_toon_tpu_torch.infer.common import (
    Bbox,
    HostSpans,
    _image_files,
    _to_signed_unit,
    mask_support_bbox,
    pack_mask,
    upload_crop_window,
)
from patch_toon_tpu_torch.infer.multistream import MultiStreamMixin
from patch_toon_tpu_torch.infer.pipeline import (
    GroupPipeline,
    PinnedPools,
    Staged,
    stack_masks,
    stage_upload,
)
from patch_toon_tpu_torch.infer.programs import (
    make_fullframe_fn,
    make_multiframe_fn,
    make_tile_plan,
)
from patch_toon_tpu_torch.infer.temporal import TemporalChain
from patch_toon_tpu_torch.infer.watch import WatchMixin
from patch_toon_tpu_torch.infer.tiling import (
    Box,
    bucket_size,
    draw_tile_boxes,
    frames_per_dispatch,
    pack_boxes_multi,
    tile_boxes_from_mask,
)
from patch_toon_tpu_torch.models.generator import (
    GeneratorJ,
    input_channels_of,
)
from patch_toon_tpu_torch.models.layers import (
    FAST_PRECISIONS,
    resolve_conv_precision,
)
from patch_toon_tpu_torch.native.frameio import FrameWriter, encode_png
from patch_toon_tpu_torch.ops.masks import erode_full_support_np
from patch_toon_tpu_torch.parallel import comm
from patch_toon_tpu_torch.utils import orbax
from patch_toon_tpu_torch.utils.knobs import resolve_transport_knobs
from patch_toon_tpu_torch.utils.weights import (
    load_generator_state,
    load_quant_scales,
)

# distinct tile layouts whose device-resident plan and weights are kept:
# boxes recur exactly for static masks and for maskless frames
_PACK_CACHE = 8
# frames decoded and staged ahead of dispatch, on PREFETCH_THREADS threads
# (JAX engine.py:780-782); bounds the staged frames' memory
PREFETCH, PREFETCH_THREADS = 6, 2
# the asynchronous writer's threads and zlib level (JAX engine.py:725 and
# native/frameio.py: speed over size for video)
WRITER_THREADS, WRITER_LEVEL = 2, 1


def _resolve_devices(device: Optional[str], cfg_inf: Dict[str, Any]
                     ) -> List[torch.device]:
    """The devices the engine serves on, each named by its index: the
    ``device`` asked for (the CPU or a card), else the card or the CPU by
    ``use_gpu``; ``inference.devices`` of them (-1: every card the process
    owns, ``parallel.local_devices``). An index-free ``cuda`` is the first
    card the process owns."""
    n = int(cfg_inf.get("devices", 1) or 1)
    if device is None:
        device = "cuda" if bool(cfg_inf.get("use_gpu", True)) else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "inference asked for a CUDA device and none is available "
            "(pass device='cpu' or inference.use_gpu=false for the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cpu":
        return comm.local_devices(n, cpu=True)
    if n == 1:
        return [dev if dev.index is not None else comm.local_devices(1)[0]]
    return comm.local_devices(n)


def _on_card(device: torch.device):
    """The card's context (its current stream and allocations), none for
    the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _resolve_dtype(precision: Any) -> torch.dtype:
    p = str(precision)
    if p in ("bf16", "bfloat16", "16"):
        return torch.bfloat16
    if p in ("32", "fp32", "float32") + FAST_PRECISIONS:
        return torch.float32
    raise ValueError(f"inference.precision={precision!r}: expected 32, "
                     "32_fast or bf16")


MODES = ("tiled", "fullframe")


def parse_quantize(inf: Dict[str, Any]) -> Optional[str]:
    """``inference.quantize`` as JAX ``engine.py:168-176`` reads it: None
    (off) or "int8" (alias w8a8); anything else raises ValueError."""
    q = str(inf.get("quantize", "off")).lower()
    if q in ("off", "false", "0", "no", "none"):
        return None
    if q in ("int8", "w8a8"):
        return "int8"
    raise ValueError(f"inference.quantize={q!r}: expected int8/w8a8 or "
                     "off/false/0/no/none")


def check_inference_knobs(inf: Dict[str, Any]) -> None:
    """Raise ValueError for a mode that does not exist, a quantize value
    JAX refuses, or a transport knob JAX refuses (``utils/knobs.py``)."""
    mode = str(inf.get("mode", "tiled"))
    if mode not in MODES:
        raise ValueError(f"inference.mode={mode!r}: expected tiled or "
                         "fullframe")
    parse_quantize(inf)
    resolve_transport_knobs(inf)


def _parse_temporal(eng, inf: Dict[str, Any]) -> None:
    """The temporal knobs, parsed and checked as the JAX engine does
    (``engine.py:108-160, 205-221, 234-250``); flow_scale and flow_batch
    serve the device flow only (``flow_batch: auto`` is 1, as in JAX)."""
    tcfg = inf.get("temporal") or {}
    eng.temporal_enabled = bool(tcfg.get("enabled", False))
    eng.temporal_flow_dir = tcfg.get("flow_dir")
    eng.temporal_depth = int(tcfg.get("depth", 3))
    eng.temporal_format = str(tcfg.get("file_format", "%03d"))
    eng.temporal_flow_source = str(tcfg.get("flow_source", "files")).lower()
    if eng.temporal_flow_source not in ("files", "device"):
        raise ValueError(f"inference.temporal.flow_source="
                         f"{eng.temporal_flow_source!r}: expected "
                         "files/device")
    eng.temporal_flow_scale = int(tcfg.get("flow_scale", 1))
    if eng.temporal_flow_scale not in (1, 2, 4):
        raise ValueError(f"inference.temporal.flow_scale="
                         f"{eng.temporal_flow_scale!r}: expected 1, 2 or 4")
    fb = str(tcfg.get("flow_batch", "auto")).lower()
    eng.temporal_flow_batch = 1 if fb == "auto" else int(fb)
    if not 1 <= eng.temporal_flow_batch <= 16:
        raise ValueError(f"inference.temporal.flow_batch={fb!r}: expected "
                         "auto or an int in [1, 16]")
    up = str(inf.get("upload", "auto")).lower()
    if up == "auto":
        upload_u8 = eng.precision not in (32, "32")
    elif up in ("u8", "uint8"):
        upload_u8 = True
    elif up in ("f32", "float32", "fp32"):
        upload_u8 = False
    else:
        raise ValueError(f"inference.upload={up!r}: expected auto/u8/f32")
    fu = str(tcfg.get("flow_upload", "auto")).lower()
    if fu == "auto":
        eng.temporal_flow_f16 = upload_u8
    elif fu in ("f16", "float16", "half"):
        eng.temporal_flow_f16 = True
    elif fu in ("f32", "float32", "fp32"):
        eng.temporal_flow_f16 = False
    else:
        raise ValueError(f"inference.temporal.flow_upload={fu!r}: expected "
                         "auto/f16/f32")


class StyleTransferInference(TemporalChain, WatchMixin, MultiStreamMixin):
    def __init__(self, cfg: Any, device: Optional[str] = None):
        self.cfg = cfg
        inf = cfg.get("inference", {}) or {}
        check_inference_knobs(inf)
        self.mode = str(inf.get("mode", "tiled"))
        self.quantize = parse_quantize(inf)
        self._quant_ready = False  # first-frame calibration done
        self.devices_cfg = int(inf.get("devices", 1) or 1)
        self.cards = _resolve_devices(device, inf)
        self.device = self.cards[0]
        self._pod_fpd: Optional[int] = None  # frames a card a dispatch
        self.overlap_percent = float(inf.get("overlap_percent", 30.0))
        self.max_tile_batch = int(inf.get("tile_batch", 512))
        self.frames_per_dispatch = inf.get("frames_per_dispatch", "auto")
        self.readback_streams = max(1, int(inf.get("readback_streams", 6)))
        # crop_readback, crop_upload, mask_packed (JAX engine.py:180-233)
        for k, v in resolve_transport_knobs(inf).items():
            setattr(self, k, v)
        self._last_crop = None  # the last group's upload window or box
        self.debug_mode = bool(inf.get("debug_mode", False))
        self.precision = inf.get("precision", "bf16")
        self.dtype = _resolve_dtype(self.precision)
        self.conv_precision = resolve_conv_precision(self.precision)
        _parse_temporal(self, inf)
        if self.dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self.patch_size = int(cfg["data"]["patch_size"])
        self.logger = logging.getLogger("patch_toon_tpu_torch.infer")
        # JAX engine.py:263-266: DEBUG under debug_mode
        self.logger.setLevel(logging.DEBUG if self.debug_mode
                             else logging.INFO)

        self.additional_channels: Dict[str, Dict[str, Any]] = {}
        paths = cfg.get("paths", {}) or {}
        for name, ccfg in (paths.get("additional_channels") or {}).items():
            if isinstance(ccfg, dict):
                path, depth = str(ccfg["path"]), int(ccfg.get("depth", 1))
            else:
                path, depth = str(ccfg), 1
            self.additional_channels[name] = {"path": path, "depth": depth}
        self.total_channels = 3 + sum(
            c["depth"] for c in self.additional_channels.values())
        if self.temporal_enabled:  # the warped previous output, last
            self.total_channels += self.temporal_depth

        self.model = self._load_model(str(paths["checkpoint"]))
        # one replica a device, its weights copied (not aliased)
        self.models = [self.model] + [copy.deepcopy(self.model).to(card)
                                      for card in self.cards[1:]]
        if len(self.cards) > 1:
            self.logger.info(
                f"Frames sharded over {len(self.cards)} devices: "
                f"{', '.join(map(str, self.cards))}")
        self._packs: Dict[Any, Any] = {}  # tile layout -> (plan, weights)
        self.patch_positions: List[Box] = []  # the last single frame's
        self.spans = HostSpans()
        # staging: pinned host buffers and a copy stream a card
        self.upload_pools = PinnedPools()
        self.copy_streams = {card: torch.cuda.Stream(card)
                             for card in self.cards if card.type == "cuda"}
        self.copy_stream = self.copy_streams.get(self.device)
        self._temporal_init()  # JAX engine.py:350-351, temporal.py:184

    def _load_model(self, ckpt_path: str) -> GeneratorJ:
        args = dict(self.cfg["model"]["generator"].get("args") or {})
        if os.path.isdir(ckpt_path):
            # an Orbax directory describes itself (JAX engine.py:319-343):
            # the channels from meta.json or the kernel's .zarray alone,
            # checked before any weight is read; its generator args win
            ckpt_channels = orbax.sniff_input_channels(ckpt_path)
            self._check_channels(ckpt_channels)
            args.update(orbax.read_meta(ckpt_path).get("generator_args")
                        or {})
            sd = load_generator_state(
                ckpt_path, norm_layer=args.get("norm_layer",
                                               "instance_norm"))
        else:
            sd = load_generator_state(ckpt_path)
            ckpt_channels = input_channels_of(sd)
            self._check_channels(ckpt_channels)
        args.pop("additional_channels", None)
        args["input_channels"] = ckpt_channels
        args["conv_precision"] = self.conv_precision
        model = GeneratorJ(**args)
        model.load_state_dict(sd, strict=True)
        model = model.eval().to(self.device,
                                memory_format=torch.channels_last)
        if self.quantize:
            # JAX quantizes the fp32 kernel: before the cast below
            for layer in model.quant_layers().values():
                layer.quantize_weights()
            model.quant_mode = "int8"
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.to(self.dtype)  # the smoother BatchNorm stays fp32
        self.logger.info(f"Model ready: {ckpt_channels} input channels from "
                         f"{ckpt_path} on {self.device}, {self.dtype}")
        return model

    def _check_channels(self, ckpt_channels: int) -> None:
        if ckpt_channels != self.total_channels:
            raise ValueError(  # reference generator.py:120-129
                f"Channel count mismatch! Checkpoint model expects "
                f"{ckpt_channels} channels, but current configuration has "
                f"{self.total_channels} channels.")

    def _ensure_quant(self, frame: torch.Tensor) -> None:
        """First-frame w8a8 calibration (JAX ``engine.py:390-418``), once:
        one calib-mode forward of the generator on the first device over
        the frame the first dispatch sees (its callers pass their first
        frame: the upload window of a cropped frame, as JAX's do; (H, W,
        C) uint8 or fp32 on a device; uint8 goes
        through ``_to_signed_unit``, the host's IEEE values), trimmed to
        ``h//4*4 x w//4*4``, at the engine's type; each site's fp32
        ``max|x|`` becomes its activation scale, copied to every replica,
        so every device serves with the first device's scales. Afterwards
        the int8 path takes the stored scales: no reduction, no sync."""
        if not self.quantize or self._quant_ready:
            return
        with _on_card(self.device):
            x = _to_signed_unit(frame.to(self.device))
            h, w = x.shape[0], x.shape[1]
            x = x[None, :h // 4 * 4, :w // 4 * 4, :].to(self.dtype)
            self.model.quant_mode = "calib"
            try:
                with torch.no_grad():
                    self.model(x)
            finally:
                self.model.quant_mode = "int8"
            scales = {p: layer.a_scale for p, layer
                      in self.model.quant_layers().items()}
            for model in self.models:
                load_quant_scales(model, scales)
        self._quant_ready = True
        self.logger.info(f"int8 serving: calibrated {len(scales)} "
                         "activation scales on the first frame")

    # ------------------------------------------------------------------

    def _pack(self, group_boxes: Sequence[Sequence[Box]], h: int, w: int,
              device: torch.device):
        key = (tuple(tuple(map(tuple, b)) for b in group_boxes), h, w,
               device)
        hit = self._packs.get(key)
        if hit is None:
            fboxes, weights, _ = pack_boxes_multi(
                list(group_boxes), self.patch_size,
                self.pack_rows(sum(len(b) for b in group_boxes)))
            hit = (make_tile_plan(fboxes, h, w, self.patch_size, device),
                   torch.from_numpy(weights).to(device))
            if len(self._packs) >= _PACK_CACHE:
                self._packs.pop(next(iter(self._packs)))
            self._packs[key] = hit
        return hit

    def pack_rows(self, n: int) -> int:
        """The generator's rows for a group of ``n`` tiles: JAX's bucket
        (``bucket_size``) where cuDNN runs the convs in full fp32
        (precision ``32``, int8 off), since cuDNN's fast fp32 route there
        depends on the batch size (a lone 512x910 frame's 170 rows took
        9-25 % longer on an H100 than its bucket of 256); the real tiles
        at bf16, ``32_fast`` (TF32 convs: 0.67x the bucket's time there)
        and under int8; none for no tile."""
        if n and self.dtype == torch.float32 \
                and self.conv_precision is None and not self.quantize:
            return bucket_size(n)
        return n

    def boxes_for(self, eroded_mask: Optional[np.ndarray],
                  hw: Tuple[int, int]) -> List[Box]:
        m = eroded_mask if eroded_mask is not None \
            else np.ones(hw, np.float32)
        return tile_boxes_from_mask(m, self.patch_size, self.overlap_percent)

    def _mask_tensor(self, mask: Optional[np.ndarray],
                     hw: Tuple[int, int]) -> np.ndarray:
        """(H, W, 1): uint8 for a {0, 1} mask (lossless, 4x fewer bytes to
        upload), fp32 for any other; all ones for None."""
        if mask is None:
            return np.ones(tuple(hw) + (1,), np.uint8)
        m = np.asarray(mask)[..., None]
        binary = m.astype(np.uint8)
        return binary if (binary == m).all() else m.astype(np.float32)

    def _mask_wire(self, mask: Optional[np.ndarray],
                   hw: Tuple[int, int]) -> np.ndarray:
        """The form a mask goes up in (JAX ``_mask_wire``): bit-packed
        (ceil(H*W/8),) uint8 under ``mask_upload: packed`` when it is {0,
        1} (None is all ones), else :meth:`_mask_tensor`'s plane."""
        if self.mask_packed:
            packed = pack_mask(np.ones(hw, np.uint8) if mask is None
                               else mask)
            if packed is not None:
                return packed
        return self._mask_tensor(mask, hw)

    def _run(self, frames: torch.Tensor, masks: torch.Tensor,
             group_boxes: Sequence[Sequence[Box]], replica: int = 0):
        """The program of the engine's mode on frames and masks already on
        device ``replica`` (the first by default): (F, H, W, C) uint8 or
        fp32 and (F, H, W, 1) -> (uint8, fp32 composite), each (F, H, W,
        3) on that device, queued on its current stream (no
        synchronisation). Fullframe mode takes no boxes."""
        self._ensure_quant(frames[0])
        f, h, w, _ = frames.shape
        if self.mode == "fullframe":
            fn = make_fullframe_fn(self.models[replica], h, w, self.dtype)
            with self.spans("host/dispatch"):
                return fn(frames, masks)
        return self._stylize_group(frames, masks, group_boxes, replica)

    def _stylize_group(self, frames: torch.Tensor, masks: torch.Tensor,
                       group_boxes: Sequence[Sequence[Box]],
                       replica: int = 0):
        """:meth:`_run` through the tiled multiframe program whatever the
        mode, as JAX ``engine.py:951-979`` (the multi-stream cycle of two
        or more streams takes it)."""
        self._ensure_quant(frames[0])
        f, h, w, _ = frames.shape
        with self.spans("host/pack"):
            plan, weights = self._pack(group_boxes, h, w,
                                       self.cards[replica])
        fn = make_multiframe_fn(self.models[replica], self.patch_size, f, h,
                                w, self.dtype)
        with self.spans("host/dispatch"):
            return fn(frames, plan, weights, masks)

    def dispatch(self, frames: torch.Tensor, masks: torch.Tensor,
                 group_boxes: Sequence[Sequence[Box]]) -> torch.Tensor:
        """:meth:`_run`'s uint8 frames, (F, H, W, 3) on the device."""
        return self._run(frames, masks, group_boxes)[0]

    def _stylize_device(self, frame: torch.Tensor, mask: torch.Tensor,
                        boxes: Sequence[Box]):
        """One frame, (H, W, C) and its (H, W, 1) mask on the device, and
        its tile boxes -> ((H, W, 3) uint8, (H, W, 3) fp32 composite, the
        boxes: [] in fullframe mode)."""
        boxes = [] if self.mode == "fullframe" else boxes
        u8, out = self._run(frame[None], mask[None], [boxes])
        return u8[0], out[0], boxes

    def _await_staged(self, group: Sequence[Staged]) -> None:
        """The current (compute) stream of each staged frame's card waits
        for its upload and is recorded on its tensors, so the copy
        stream's memory is not reused before the program has read it."""
        for s in group:
            if s.ready is None:
                continue
            stream = torch.cuda.current_stream(s.frame.device)
            stream.wait_event(s.ready)
            for t in (s.frame, s.mask, s.flow, s.fmask):
                if t is not None:
                    t.record_stream(stream)

    def _to_card(self, s: Staged, card: torch.device) -> Staged:
        """``s`` on ``card``: itself when it is staged there, else a copy
        made after its upload (a frame staged on another card than the
        one its chunk runs on)."""
        if s.frame.device == card:
            return s
        self._await_staged([s])
        moved = {k: getattr(s, k).to(card) if getattr(s, k) is not None
                 else None for k in ("frame", "mask", "flow", "fmask")}
        return dataclasses.replace(s, ready=None, **moved)

    def card_of(self, i: int) -> torch.device:
        """The card the ``i``-th frame of a stream is staged on: the card
        whose chunk it falls in when no frame fails and no shape changes
        (the first card before the chunk size is known)."""
        per = 1 if self.mode == "fullframe" else (self._pod_fpd or 1)
        return self.cards[(i // per) % len(self.cards)]

    def _dispatch_sharded(self, group: Sequence[Staged]
                          ) -> List[torch.Tensor]:
        """A group over the cards (JAX ``_stylize_group_pod``): card ``k``
        runs the one-device program on the ``k``-th chunk of ``fpd``
        frames (one in full-frame mode) on its own current stream. JAX pads
        the group to ``D x fpd`` frames by repeating its last one; here the
        last chunk is short and no card runs a repeated frame. -> the
        frames' (H, W, 3) uint8 outputs, each on its card, in frame
        order."""
        per = 1 if self.mode == "fullframe" else (self._pod_fpd or 1)
        total = len(self.cards) * per
        if len(group) > total:
            raise ValueError(f"a group of {len(group)} frames over "
                             f"{len(self.cards)} devices x {per}")
        if self.quantize and not self._quant_ready:
            self._await_staged(group[:1])
            self._ensure_quant(group[0].frame)
        outs: List[torch.Tensor] = []
        for k, card in enumerate(self.cards):
            if k * per >= len(group):
                break
            with _on_card(card):
                chunk = [self._to_card(s, card)
                         for s in group[k * per:(k + 1) * per]]
                with self.spans("host/stack"):
                    self._await_staged(chunk)
                    frames = torch.stack([s.frame for s in chunk])
                    masks = stack_masks(chunk)
                u8 = self._run(frames, masks, [s.boxes for s in chunk], k)[0]
            outs.extend(u8.unbind(0))
        return outs

    def dispatch_staged(self, group: Sequence[Staged]):
        """:meth:`dispatch` of frames staged by :meth:`_load_for_dispatch`:
        the current (compute) stream waits for each frame's upload and is
        recorded on its tensors, so the copy stream's memory is not reused
        before the program has read it. Over several devices
        :meth:`_dispatch_sharded` (a list of per-frame outputs)."""
        if len(self.cards) > 1:
            return self._dispatch_sharded(group)
        with self.spans("host/stack"):
            self._await_staged(group)
            frames = torch.stack([s.frame for s in group])
            masks = stack_masks(group)
        return self.dispatch(frames, masks, [s.boxes for s in group])

    def stylize_group(self, frames_u8: np.ndarray,
                      eroded_masks: Sequence[Optional[np.ndarray]],
                      group_boxes: Optional[Sequence[Sequence[Box]]] = None
                      ) -> np.ndarray:
        """Stylize F frames of one shape in one generator batch, in line:
        upload, dispatch, and a blocking readback.

        frames_u8 (F, H, W, C) uint8 (RGB then guide channels); eroded
        masks (H, W) in [0, 1] or None for full-frame stylization; {0, 1}
        masks upload bit-packed (``mask_upload: packed``) or as uint8, any
        other as fp32, which composites in part. -> (F, H, W, 3) uint8."""
        frames_u8 = np.asarray(frames_u8)
        f, h, w, c = frames_u8.shape
        if c != self.total_channels:
            raise ValueError(f"frames have {c} channels, the model takes "
                             f"{self.total_channels}")
        spans = self.spans
        if self.mode == "fullframe":
            group_boxes = [[] for _ in range(f)]
        elif group_boxes is None:
            with spans("host/tile_placement"):
                group_boxes = [self.boxes_for(m, (h, w))
                               for m in eroded_masks]
        with spans("host/mask_stack"):
            masks = [self._mask_tensor(m, (h, w)) for m in eroded_masks]
            if len({m.dtype for m in masks}) > 1:
                masks = [m.astype(np.float32) for m in masks]
            masks = np.stack(masks)
            if self.mask_packed and masks.dtype == np.uint8:
                masks = pack_mask(masks[..., 0])
        with spans("host/upload"):
            frames_d = torch.from_numpy(frames_u8).to(self.device)
            masks_d = torch.from_numpy(masks).to(self.device)
        u8 = self.dispatch(frames_d, masks_d, group_boxes)
        with spans("host/readback"):
            return u8.cpu().numpy()

    def process_large_image(self, frame: np.ndarray,
                            mask: Optional[np.ndarray] = None,
                            overlap_percent: Optional[float] = None
                            ) -> np.ndarray:
        """Stylize one frame in line (JAX ``engine.py:472-481``): (H, W, C)
        fp32 in [-1, 1] or uint8 (RGB then guide channels), an eroded mask
        (H, W) in [0, 1] or None for the whole frame ({0, 1} uploads
        bit-packed or as uint8, any other as fp32 and composites in part;
        nothing is cropped, as in JAX), the tile overlap
        (the engine's when None) -> (H, W, 3) uint8. Full-frame mode takes
        the full-frame program; tiled mode the multiframe program at F = 1,
        as :meth:`stylize_group` does. The tile boxes are kept in
        ``patch_positions`` ([] in fullframe mode)."""
        frame = np.ascontiguousarray(frame)
        h, w, c = frame.shape
        if c != self.total_channels:
            raise ValueError(f"frame has {c} channels, the model takes "
                             f"{self.total_channels}")
        boxes: List[Box] = []
        if self.mode != "fullframe":
            m = mask if mask is not None else np.ones((h, w), np.float32)
            boxes = tile_boxes_from_mask(
                m, self.patch_size, self.overlap_percent
                if overlap_percent is None else float(overlap_percent))
        frame_d = torch.from_numpy(frame).to(self.device)
        mask_d = torch.from_numpy(self._mask_wire(mask, (h, w))).to(
            self.device)
        u8, _, boxes = self._stylize_device(frame_d, mask_d, boxes)
        self.patch_positions = boxes
        return u8.cpu().numpy()

    def process_image(self, input_path, mask_path, save_path) -> None:
        """Stylize one image file into ``save_path`` (JAX
        ``engine.py:559-567``): the frame with its guide channels, its
        eroded mask (a mask of another size raises; one missing from a
        directory ending in ``ignore`` means the whole frame), then
        :meth:`process_large_image`; with ``debug_mode`` also
        ``debug_<name>`` with the tile boxes outlined."""
        frame = self.load_frame(Path(input_path))
        mask = self.load_eroded_mask(Path(mask_path), frame.shape[:2])
        out = self.process_large_image(frame, mask)
        encode_png(save_path, out)
        if self.debug_mode:
            self._save_debug_overlay(out, save_path)
        self.logger.info(f"Saved {save_path}")

    def _save_debug_overlay(self, out: np.ndarray, save_path) -> None:
        """``debug_<name>`` beside ``save_path``: the frame with the last
        call's tile boxes outlined (JAX ``engine.py:569-582``)."""
        path = Path(save_path)
        encode_png(path.with_name(f"debug_{path.name}"),
                   draw_tile_boxes(out, self.patch_positions))

    # ------------------------------------------------------------------

    def _check_channel_dirs(self) -> None:
        """Guide-channel directories exist, hold images with enough bands
        (reference generator.py:196-271)."""
        for name, ccfg in self.additional_channels.items():
            cdir = Path(ccfg["path"])
            if not cdir.exists():
                raise FileNotFoundError(f"Channel directory not found: {cdir}")
            samples = _image_files(cdir)
            if not samples:
                raise FileNotFoundError(f"No images found in {cdir}")
            if image_bands(samples[0]) < ccfg["depth"]:
                raise ValueError(
                    f"Channel {name} has insufficient channels: expected "
                    f"{ccfg['depth']}, but found {image_bands(samples[0])}")

    def load_frame_parts(self, input_path: Path,
                         channels: Optional[Dict[str, Dict[str, Any]]] = None
                         ) -> List[np.ndarray]:
        """[(H, W, 3) uint8 RGB, then each guide channel's first bands];
        ``channels`` in place of the engine's guide channels (a stream's
        own directories)."""
        parts = [decode_rgb_uint8(input_path)]
        chans = self.additional_channels if channels is None else channels
        for name, ccfg in chans.items():
            cpath = find_corresponding_image(ccfg["path"], str(input_path))
            if not os.path.exists(cpath):
                raise FileNotFoundError(
                    f"Required channel {name} not found: {cpath}")
            parts.append(decode_rgb_uint8(cpath)[..., :ccfg["depth"]])
        return parts

    def load_frame(self, input_path: Path) -> np.ndarray:
        """(H, W, C) uint8: RGB, then each guide channel's first bands."""
        return np.concatenate(self.load_frame_parts(input_path), axis=-1)

    def load_eroded_mask(self, mask_path: Path,
                         shape_hw) -> Optional[np.ndarray]:
        """Eroded mask, or None (full frame) when it is missing from a
        directory whose name ends in ``ignore``."""
        mask_dir = os.path.dirname(str(mask_path))
        resolved = find_corresponding_image(mask_dir,
                                            os.path.basename(str(mask_path)))
        if not os.path.exists(resolved):
            if mask_dir.endswith("ignore"):
                return None
            raise FileNotFoundError(f"Mask file not found: {resolved}")
        mask = load_mask(resolved)
        if tuple(mask.shape) != tuple(shape_hw):
            raise ValueError(
                f"Mask {resolved} is {mask.shape}, frame is "
                f"{tuple(shape_hw)} — mask/frame resolutions must match")
        return erode_full_support_np(mask)

    def load_flow(self, position: int,
                  flow_dir: Optional[Path] = None) -> Optional[np.ndarray]:
        """Frame ``position``'s backward flow, (H, W, 2), from
        ``flow_dir / (file_format % position).npy`` (the engine's flow_dir
        when None), rounded to float16 where ``temporal_flow_f16`` says;
        None without a flow_dir or for a missing file (JAX
        ``temporal.py:316-325``)."""
        flow_dir = flow_dir or self.temporal_flow_dir
        if flow_dir is None:
            return None
        path = Path(flow_dir) / f"{self.temporal_format % position}.npy"
        if not path.exists():
            return None
        flow = np.load(str(path))
        if self.temporal_flow_f16 and flow.dtype != np.float16:
            flow = flow.astype(np.float16)
        return flow

    def load_flow_mask(self, input_path: Path,
                       mask_dir: Path) -> Optional[np.ndarray]:
        """The device flow's mask of a frame: the flow tool's rule (luma >
        127; JAX ``temporal.py:327-344``), apart from the composite mask's
        > 128; bit-packed, (ceil(H*W/8),) uint8, under ``mask_upload:
        packed``, else an (H, W) uint8 {0, 1} plane; None when the frame
        has no mask file (unmasked flow)."""
        resolved = find_corresponding_image(mask_dir, input_path.name)
        if not os.path.exists(resolved):
            return None
        plane = (load_luma(resolved) > 127).astype(np.uint8)
        return np.packbits(plane.reshape(-1)) if self.mask_packed else plane

    def _crop_up(self) -> bool:
        """Whether :meth:`process_directory` crops uploads: under
        ``crop_upload``, tiled and without the temporal guide (full-frame
        mode needs the whole frame's statistics, the chain warps whole
        frames; JAX ``engine.py:716-720``)."""
        return self.crop_upload and self.mode != "fullframe" \
            and not self.temporal_enabled

    def _load_for_dispatch(self, input_path: Path, mask_dir: Path,
                           position: Optional[int] = None,
                           card: Optional[torch.device] = None) -> Staged:
        """Decode, erode, place tiles (none in fullframe mode) and stage
        one frame for dispatch, on a prefetch thread (JAX
        ``engine.py:623-667``): its mask's support box and, for a masked
        frame under :meth:`_crop_up`, its upload window; with a stream
        ``position`` (the temporal chain) its flow file too, or with the
        device flow its raw flow mask. On a CUDA device the frame (or its
        window), its mask and its flow or flow mask go up to ``card`` (the
        first device by default) through pinned buffers on its copy
        stream; on the CPU they stay host tensors."""
        spans = self.spans
        device_flow = self.temporal_flow_source == "device"
        flow = fmask = None
        with spans("host/decode"):
            parts = self.load_frame_parts(input_path)
            if position is not None and not device_flow:
                flow = self.load_flow(position)
        hw = parts[0].shape[:2]
        with spans("host/mask"):
            mask = self.load_eroded_mask(mask_dir / input_path.name, hw)
            if position is not None and device_flow:
                fmask = self.load_flow_mask(input_path, mask_dir)
        with spans("host/tile_placement"):
            boxes = [] if self.mode == "fullframe" \
                else self.boxes_for(mask, hw)
            # the support box comes from the mask itself: stride-sampled
            # tiles can miss a speckle pixel, and full-frame mode has none
            mbox = mask_support_bbox(mask) if mask is not None else None
            cropwin = upload_crop_window(boxes, *hw, self.patch_size,
                                         support_bbox=mbox) \
                if mask is not None and self._crop_up() else None
        return self._stage(parts, mask, boxes, input_path, position, flow,
                           fmask, card, mbox, cropwin)

    def _stage(self, parts: List[np.ndarray], mask: Optional[np.ndarray],
               boxes: List[Box], path: Path, position: Optional[int],
               flow: Optional[np.ndarray], fmask: Optional[np.ndarray],
               card: Optional[torch.device] = None,
               mbox: Optional[Bbox] = None,
               cropwin: Optional[Bbox] = None) -> Staged:
        """Upload a decoded frame (its parts joined), its mask (None: the
        whole frame) in its wire form (:meth:`_mask_wire`) and its flow or
        flow mask to ``card`` (the first device by default), through
        pinned buffers on that card's copy stream (host tensors on the
        CPU) -> :class:`Staged`, which keeps the host RGB and ``mbox`` for
        the cropped readback. With an upload window ``cropwin`` (y0, y1,
        x0, x1) only the window of the frame and its mask goes up, and the
        tile boxes are shifted into it (JAX ``engine.py:650-660``)."""
        rgb = parts[0]
        if cropwin is not None:
            y0, y1, x0, x1 = cropwin
            parts = [p[y0:y1, x0:x1] for p in parts]
            mask = mask[y0:y1, x0:x1]
            boxes = [(b[0] - y0, b[1] - y0, b[2] - x0, b[3] - x0)
                     for b in boxes]
        hw = parts[0].shape[:2]
        card = self.device if card is None else card
        stream = self.copy_streams.get(card)
        with self.spans("host/upload"):
            frame_d, _ = stage_upload(parts, card, self.upload_pools, stream)
            # the later copies follow the frame's on the one copy stream,
            # so the last event covers them all
            mask_d, ready = stage_upload([self._mask_wire(mask, hw)],
                                         card, self.upload_pools, stream)
            flow_d = fmask_d = None
            if flow is not None:
                flow_d, ready = stage_upload([flow], card, self.upload_pools,
                                             stream)
            if fmask is not None:
                fmask_d, ready = stage_upload([fmask], card,
                                              self.upload_pools, stream)
        return Staged(frame_d, mask_d, ready, boxes, path, position, flow_d,
                      fmask_d, rgb, mbox, cropwin)

    def _detect_streams(self, input_dir: Path) -> List[str]:
        """The multi-stream temporal layout (JAX ``multistream.py:42-52``):
        no images in input_dir itself, and subdirectories that hold
        some."""
        if _image_files(input_dir):
            return []
        try:
            subdirs = list(input_dir.iterdir())
        except (FileNotFoundError, NotADirectoryError):
            return []
        return sorted(d.name for d in subdirs
                      if d.is_dir() and _image_files(d))

    def process_directory(self, files: Optional[List[Path]] = None) -> int:
        """Stylize every frame of paths.input_dir (or the given ``files``)
        into paths.output_dir, as a stream (see the module's docstring);
        with the temporal guide, as one chain that later calls continue,
        or, for a subdirectory per video, as co-batched chains
        (``infer/multistream.py``).

        -> the number of frames written (handed to the writer, less the
        writes it reports failed)."""
        paths = self.cfg["paths"]
        input_dir = Path(paths["input_dir"])
        mask_dir = Path(paths["mask_dir"])
        output_dir = Path(paths["output_dir"])
        if not input_dir.exists():
            raise FileNotFoundError(f"Input directory not found: {input_dir}")
        if not mask_dir.name.endswith("ignore") and not mask_dir.exists():
            raise FileNotFoundError(f"Mask directory not found: {mask_dir}")
        output_dir.mkdir(parents=True, exist_ok=True)
        if files is None and self.temporal_enabled:
            # a subdirectory per video: co-batched chains (JAX
            # engine.py:694-705)
            streams = self._detect_streams(input_dir)
            if streams:
                return self._process_multistream(streams, input_dir,
                                                 mask_dir, output_dir)
        self._check_channel_dirs()
        explicit = files is not None
        if files is None:
            files = _image_files(input_dir)
        files = self._resolve_shard_files(files, explicit)
        if files is None:
            return 0  # the temporal guide over processes: rank 0 serves
        self.logger.info(f"Found {len(files)} images to process")

        # over D devices the host decodes, stages and writes D times the
        # frames: D times the threads, and two groups of D x fpd frames in
        # flight and ahead (one device: the JAX engine's numbers)
        d = 1 if self.temporal_enabled else len(self.cards)
        writer = FrameWriter(num_threads=WRITER_THREADS * d,
                             compress_level=WRITER_LEVEL)
        pipe = GroupPipeline(self, writer, output_dir)
        if self.temporal_enabled:
            if len(self.cards) > 1:
                self.logger.info(
                    f"The temporal chain is sequential: it runs on "
                    f"{self.device} alone, not over {len(self.cards)} "
                    "devices")
            return self._process_directory_temporal(files, mask_dir, pipe,
                                                    writer)
        group: List[Staged] = []
        # a fullframe group is one frame (JAX engine.py:767-768), one a
        # device over several
        group_size = len(self.cards) if self.mode == "fullframe" else None
        sharded = d > 1
        if sharded and group_size:
            pipe.window = max(pipe.window, 2 * group_size)
        ahead = PREFETCH * d

        def flush_group() -> None:
            # hand off and clear before dispatching: a failed dispatch drops
            # its own group, not every later one
            nonlocal group
            if not group:
                return
            g, group = group, []
            try:
                pipe.dispatch(g)
            except Exception as e:
                names = ", ".join(x.path.name for x in g)
                self.logger.error(
                    f"Dispatch failed; dropping group [{names}]: {e}")

        def load(i: int):
            if sharded:
                return pool.submit(self._load_for_dispatch, files[i],
                                   mask_dir, card=self.card_of(i))
            return pool.submit(self._load_for_dispatch, files[i], mask_dir)

        pool = ThreadPoolExecutor(max_workers=PREFETCH_THREADS * d)
        try:
            futures = {files[i]: load(i)
                       for i in range(min(ahead, len(files)))}
            for i, path in enumerate(files):
                if i + ahead < len(files):
                    futures[files[i + ahead]] = load(i + ahead)
                try:
                    with self.spans("host/load_wait"):
                        staged = futures.pop(path).result()
                except Exception as e:
                    self.logger.error(f"Failed to process {path.name}: {e}")
                    continue
                # a group holds frames of one shape and one croppedness: a
                # window and a whole frame of equal sides must not share
                # one (their pastes differ; JAX engine.py:801-812)
                if group and (group[0].frame.shape != staged.frame.shape
                              or (group[0].cropwin is None)
                              != (staged.cropwin is None)):
                    flush_group()
                if group_size is None:
                    group_size = self._group_size(len(staged.boxes))
                    if sharded:
                        pipe.window = max(pipe.window, 2 * group_size)
                group.append(staged)
                if len(group) >= group_size:
                    flush_group()
            flush_group()
        finally:
            # on an interrupt, an error or the end: every dispatched frame
            # reaches disk or is logged (JAX engine.py:815-834)
            pool.shutdown(wait=True, cancel_futures=True)
            if group:
                self.logger.error("Stopped before dispatching [" + ", ".join(
                    x.path.name for x in group) + "]")
            failed = self._finish(pipe, writer)
        return pipe.submitted - failed

    def _finish(self, pipe: GroupPipeline, writer: FrameWriter) -> int:
        """Drain every frame in flight, flush the writer -> the writes it
        reports failed."""
        pipe.drain_all()
        pipe.close()
        with self.spans("host/writer_drain"):
            failed = writer.flush()
        writer.close()
        if failed:
            self.logger.error(f"{failed} frame writes failed")
        return failed

    def _process_directory_temporal(self, files: List[Path], mask_dir: Path,
                                    pipe: GroupPipeline,
                                    writer: FrameWriter) -> int:
        """The temporal chain over ``files`` (JAX
        ``_process_directory_temporal``): each frame's stream position is
        taken on this thread in file order, its decode, flow or flow mask
        and upload run ahead on the prefetch threads, then
        :meth:`_chain_step` and the pipeline's readback, which drains while
        later frames run. With the device flow and ``flow_batch`` K > 1,
        the flows of the next K frames (up to a failed decode or a change
        of shape) are computed ahead against the chain's luma, one graph
        replay each: flows depend on the input frames only. A frame that
        fails is named and restarts the chain; the carry is kept on the
        engine for the next call, also on an interrupt."""
        prev, prev_gray = self._temporal_prev, self._temporal_prev_gray
        device_flow = self.temporal_flow_source == "device"
        lookahead = self.temporal_flow_batch if device_flow else 1
        depth = max(PREFETCH, lookahead)
        pool = ThreadPoolExecutor(max_workers=PREFETCH_THREADS)
        futures: Dict[Path, Any] = {}
        fcache: Dict[int, Any] = {}  # loop index -> (flow, luma) ahead

        def submit(path: Path) -> None:
            futures[path] = pool.submit(
                self._load_for_dispatch, path, mask_dir,
                self._temporal_position(path.name))

        def window_flows(i: int, first: Staged, pg) -> None:
            ents = [first]
            for path in files[i + 1:i + lookahead]:
                try:
                    st = futures[path].result()
                except Exception:
                    break  # that frame's own turn names the error
                if st.frame.shape != first.frame.shape:
                    break
                ents.append(st)
            if len(ents) < 2:
                return
            self._await_staged(ents)
            with self.spans("host/flow"):
                for t, st in enumerate(ents):
                    fcache[i + t] = self.flow_graphs(
                        st.frame, pg, st.fmask, self.temporal_flow_scale)
                    pg = fcache[i + t][1]

        try:
            for path in files[:depth]:
                submit(path)
            for i, path in enumerate(files):
                if i + depth < len(files):
                    submit(files[i + depth])
                try:
                    with self.spans("host/load_wait"):
                        staged = futures.pop(path).result()
                    self._await_staged([staged])
                    flow_hit = fcache.pop(i, None)
                    if flow_hit is None and lookahead > 1 \
                            and prev_gray is not None:
                        window_flows(i, staged, prev_gray)
                        flow_hit = fcache.pop(i, None)
                    u8, _, (prev, prev_gray) = self._chain_step(
                        staged.frame, staged.mask, staged.boxes,
                        (prev, prev_gray),
                        aux=staged.fmask if device_flow else staged.flow,
                        flow_hit=flow_hit,
                        label=self._flow_label(staged.position))
                except Exception as e:
                    self.logger.error(f"Failed to process {path.name}: {e}")
                    prev = prev_gray = None  # restart the chain
                    continue
                try:
                    pipe.submit([staged], u8[None])
                except Exception as e:
                    # a deferred error of an earlier frame: this frame and
                    # the chain are intact
                    self.logger.error(f"Readback failed: {e}")
        finally:
            self._temporal_prev = prev
            self._temporal_prev_gray = prev_gray
            pool.shutdown(wait=True, cancel_futures=True)
            failed = self._finish(pipe, writer)
        return pipe.submitted - failed

    def _group_size(self, n_boxes: int) -> int:
        """Frames a group, decided from the first frame's tile count (JAX
        ``_decide_group_size``): co-batched to about ``tile_batch`` tiles,
        times the devices over several (``fpd`` frames a card)."""
        if self.frames_per_dispatch != "auto":
            fpd = max(1, int(self.frames_per_dispatch))
        else:
            fpd = frames_per_dispatch(max(1, n_boxes),
                                      target=self.max_tile_batch)
        if len(self.cards) > 1:
            self._pod_fpd = fpd
            self.logger.info(f"Co-batching {fpd} frames a device x "
                             f"{len(self.cards)} devices a dispatch "
                             f"(~{n_boxes} tiles/frame)")
            return fpd * len(self.cards)
        self.logger.info(f"Co-batching {fpd} frames/dispatch "
                         f"(~{n_boxes} tiles/frame)")
        return fpd

    def _resolve_shard_files(self, files: List[Path],
                             explicit: bool) -> Optional[List[Path]]:
        """This process's share of ``files`` (JAX
        ``_resolve_shard_files``): ``inference.file_shard: "i/N"`` takes
        ``files[i::N]``; in a process group of several ranks with no
        shard given, the rank's (``rank/world``), and with the temporal
        guide only rank 0 serves (-> None elsewhere), frames chaining in
        order. An explicit shard with the temporal guide raises. ``files``
        given by the caller (watch mode, which splits by name) are not
        sharded again."""
        shard = None if explicit else (self.cfg.get("inference", {}) or {}
                                       ).get("file_shard")
        if not explicit and shard in (None, "") and comm.world() > 1:
            if self.temporal_enabled:
                self.logger.warning(
                    "Several processes with the temporal guide: frames "
                    "chain in order, so only rank 0 stylizes (shard whole "
                    "videos across processes instead)")
                if comm.rank() != 0:
                    return None
            else:
                shard = f"{comm.rank()}/{comm.world()}"
        if shard in (None, ""):
            return files
        if self.temporal_enabled:
            raise ValueError(
                "inference.file_shard is incompatible with the temporal "
                "guide (frame i depends on frame i-1); shard videos, not "
                "frames")
        try:
            idx, n = (int(x) for x in str(shard).split("/"))
        except ValueError:
            raise ValueError(f"inference.file_shard={shard!r}: expected "
                             "'i/N'") from None
        if not 0 <= idx < n:
            raise ValueError(f"file_shard {shard}: index out of range")
        self.logger.info(f"File shard {idx}/{n}")
        return files[idx::n]
