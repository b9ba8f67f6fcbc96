"""Tiled video stylization on one device.

Counterpart of ``patch_toon_tpu/infer/engine.py::StyleTransferInference``
in ``tiled`` mode. ``process_directory`` streams a directory of frames as
the JAX engine does (``engine.py:669-834``): two prefetch threads decode
each frame with its guide channels (the port's native PNG codec), erode its
mask, place its tiles and stage it for upload six frames ahead
(:meth:`_load_for_dispatch`); the main thread co-batches frames so one
generator batch holds about ``inference.tile_batch`` tiles
(``frames_per_dispatch``: three 512x910 frames of 170 tiles go in one
bucket of 512) and dispatches each group; ``infer/pipeline.py``'s
:class:`GroupPipeline` keeps the readbacks in flight and hands each frame
to the native asynchronous writer. A file that fails to load is named and
skipped, a group whose dispatch fails is dropped and each of its frames
named (reference generator.py:700-705), and on an interrupt, an error or
the end every dispatched frame reaches disk or is logged. The output files
are those of :meth:`stylize_group`, the public synchronous call, run group
by group.

Semantics kept from the JAX engine: the channel count sniffed from the
checkpoint must match the configured guide channels; masks are binarized
(> 128), then eroded with the 7x7 full-support rule; a missing mask
directory whose name ends in ``ignore`` means full-frame stylization; a
fractional mask given to :meth:`stylize_group` is uploaded as fp32 and
composites in part (JAX ``_mask_up``); ``debug_mode`` writes
``debug_<name>`` beside each frame with its tile boxes outlined.

Precision ``32`` runs fp32 with TF32 off in cuDNN and matmuls and the
fp32 matmul precision at "highest" (the JAX contract is HIGHEST precision,
patch_toon_tpu/models/layers.py:91-93 for the upsample's products and
:100-119 for the convs).
``bf16`` (the default) runs the convs in bf16 while InstanceNorm statistics
and the smoother BatchNorm stay fp32, as in JAX.

Not ported yet, and refused by name (``NotImplementedError``): modes other
than tiled, precision ``32_fast``, ``quantize=int8``, ``file_shard``,
``devices`` other than 1, ``temporal.enabled`` and ``watch.enabled``.
``readback_streams`` sets the pipeline's in-flight window (its value plus 2
frames, the JAX rule). The other transport knobs (``crop_readback``,
``crop_upload``, ``upload``, ``mask_upload``, ``xla_options``) change no
output in the JAX package and are no-ops here.
"""

from __future__ import annotations

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
    load_mask,
)
from patch_toon_tpu_torch.infer.common import HostSpans, _image_files
from patch_toon_tpu_torch.infer.pipeline import (
    GroupPipeline,
    PinnedPools,
    Staged,
    stage_upload,
)
from patch_toon_tpu_torch.infer.programs import (
    make_multiframe_fn,
    make_tile_plan,
)
from patch_toon_tpu_torch.infer.tiling import (
    Box,
    bucket_size,
    frames_per_dispatch,
    pack_boxes_multi,
    tile_boxes_from_mask,
)
from patch_toon_tpu_torch.models.generator import (
    GeneratorJ,
    input_channels_of,
)
from patch_toon_tpu_torch.native.frameio import FrameWriter
from patch_toon_tpu_torch.ops.masks import erode_full_support_np
from patch_toon_tpu_torch.utils.weights import load_generator_state

# distinct tile layouts whose device-resident plan and weights are kept:
# boxes recur exactly for static masks and for maskless frames
_PACK_CACHE = 8
# frames decoded and staged ahead of dispatch, on PREFETCH_THREADS threads
# (JAX engine.py:780-782); bounds the staged frames' memory
PREFETCH, PREFETCH_THREADS = 6, 2
# the asynchronous writer's threads and zlib level (JAX engine.py:725 and
# native/frameio.py: speed over size for video)
WRITER_THREADS, WRITER_LEVEL = 2, 1


def _resolve_device(device: Optional[str], cfg_inf: Dict[str, Any]):
    if device is None:
        device = "cuda" if bool(cfg_inf.get("use_gpu", True)) else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "inference asked for a CUDA device and none is available "
            "(pass device='cpu' or inference.use_gpu=false for the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _resolve_dtype(precision: Any) -> torch.dtype:
    p = str(precision)
    if p in ("32_fast", "tf32", "fp32_fast"):
        raise NotImplementedError(
            f"inference.precision={precision!r} is not ported yet")
    if p in ("bf16", "bfloat16", "16"):
        return torch.bfloat16
    if p in ("32", "fp32", "float32"):
        return torch.float32
    raise ValueError(f"inference.precision={precision!r}: expected 32 or bf16")


def check_unported_inference_knobs(inf: Dict[str, Any]) -> None:
    """Raise NotImplementedError naming each inference knob that asks for
    what this port does not do yet (the JAX engine acts on all of them)."""
    mode = str(inf.get("mode", "tiled"))
    if mode != "tiled":
        raise NotImplementedError(
            f"inference.mode={mode!r} is not ported yet (tiled only)")
    q = str(inf.get("quantize", "off")).lower()
    if q in ("int8", "w8a8"):
        raise NotImplementedError(f"inference.quantize={q!r} is not ported "
                                  "yet")
    if q not in ("off", "false", "0", "no", "none"):
        raise ValueError(f"inference.quantize={q!r}: expected int8/w8a8 or "
                         "off/false/0/no/none")
    if inf.get("file_shard") not in (None, ""):
        raise NotImplementedError(
            f"inference.file_shard={inf.get('file_shard')!r} is not ported "
            "yet (one process writes every frame)")
    if int(inf.get("devices", 1) or 1) != 1:
        raise NotImplementedError(
            f"inference.devices={inf.get('devices')!r} is not ported yet "
            "(one device)")
    for knob in ("temporal", "watch"):
        if bool((inf.get(knob) or {}).get("enabled", False)):
            raise NotImplementedError(
                f"inference.{knob}.enabled=true is not ported yet")


class StyleTransferInference:
    def __init__(self, cfg: Any, device: Optional[str] = None):
        self.cfg = cfg
        inf = cfg.get("inference", {}) or {}
        check_unported_inference_knobs(inf)
        self.device = _resolve_device(device, inf)
        self.overlap_percent = float(inf.get("overlap_percent", 30.0))
        self.max_tile_batch = int(inf.get("tile_batch", 512))
        self.frames_per_dispatch = inf.get("frames_per_dispatch", "auto")
        self.readback_streams = max(1, int(inf.get("readback_streams", 6)))
        self.debug_mode = bool(inf.get("debug_mode", False))
        self.precision = inf.get("precision", "bf16")
        self.dtype = _resolve_dtype(self.precision)
        if self.dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self.patch_size = int(cfg["data"]["patch_size"])
        self.logger = logging.getLogger("patch_toon_tpu_torch.infer")

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

        self.model = self._load_model(str(paths["checkpoint"]))
        self._packs: Dict[Any, Any] = {}  # tile layout -> (plan, weights)
        self.spans = HostSpans()
        # staging: pinned host buffers and a copy stream of their own
        self.upload_pools = PinnedPools()
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def _load_model(self, ckpt_path: str) -> GeneratorJ:
        sd = load_generator_state(ckpt_path)
        ckpt_channels = input_channels_of(sd)
        if ckpt_channels != self.total_channels:
            raise ValueError(  # reference generator.py:120-129
                f"Channel count mismatch! Checkpoint model expects "
                f"{ckpt_channels} channels, but current configuration has "
                f"{self.total_channels} channels.")
        args = dict(self.cfg["model"]["generator"].get("args") or {})
        args["input_channels"] = ckpt_channels
        model = GeneratorJ(**args)
        model.load_state_dict(sd, strict=True)
        model = model.eval().to(self.device,
                                memory_format=torch.channels_last)
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.to(self.dtype)  # the smoother BatchNorm stays fp32
        self.logger.info(f"Model ready: {ckpt_channels} input channels from "
                         f"{ckpt_path} on {self.device}, {self.dtype}")
        return model

    # ------------------------------------------------------------------

    def _pack(self, group_boxes: Sequence[Sequence[Box]], h: int, w: int):
        key = (tuple(tuple(map(tuple, b)) for b in group_boxes), h, w)
        hit = self._packs.get(key)
        if hit is None:
            bucket = bucket_size(max(1, sum(len(b) for b in group_boxes)))
            fboxes, weights, _ = pack_boxes_multi(
                list(group_boxes), self.patch_size, bucket)
            hit = (make_tile_plan(fboxes, h, w, self.patch_size,
                                  self.device),
                   torch.from_numpy(weights).to(self.device))
            if len(self._packs) >= _PACK_CACHE:
                self._packs.pop(next(iter(self._packs)))
            self._packs[key] = hit
        return hit

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

    def dispatch(self, frames: torch.Tensor, masks: torch.Tensor,
                 group_boxes: Sequence[Sequence[Box]]) -> torch.Tensor:
        """Run the multiframe program on frames and masks already on the
        device: (F, H, W, C) uint8 and (F, H, W, 1) -> (F, H, W, 3) uint8 on
        the device, queued on the current stream (no synchronisation)."""
        f, h, w, _ = frames.shape
        with self.spans("host/pack"):
            plan, weights = self._pack(group_boxes, h, w)
        fn = make_multiframe_fn(self.model, self.patch_size, f, h, w,
                                self.dtype)
        with self.spans("host/dispatch"):
            u8, _ = fn(frames, plan, weights, masks)
        return u8

    def dispatch_staged(self, group: Sequence[Staged]) -> torch.Tensor:
        """:meth:`dispatch` of frames staged by :meth:`_load_for_dispatch`:
        the current (compute) stream waits for each frame's upload and is
        recorded on its tensors, so the copy stream's memory is not reused
        before the program has read it."""
        with self.spans("host/stack"):
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                for s in group:
                    stream.wait_event(s.ready)
                    s.frame.record_stream(stream)
                    s.mask.record_stream(stream)
            frames = torch.stack([s.frame for s in group])
            masks = [s.mask for s in group]
            if len({m.dtype for m in masks}) > 1:
                masks = [m.float() for m in masks]
            masks = torch.stack(masks)
        return self.dispatch(frames, masks, [s.boxes for s in group])

    def stylize_group(self, frames_u8: np.ndarray,
                      eroded_masks: Sequence[Optional[np.ndarray]],
                      group_boxes: Optional[Sequence[Sequence[Box]]] = None
                      ) -> np.ndarray:
        """Stylize F frames of one shape in one generator batch, in line:
        upload, dispatch, and a blocking readback.

        frames_u8 (F, H, W, C) uint8 (RGB then guide channels); eroded
        masks (H, W) in [0, 1] or None for full-frame stylization; {0, 1}
        masks upload as uint8, any other as fp32, which composites in part.
        -> (F, H, W, 3) uint8."""
        frames_u8 = np.asarray(frames_u8)
        f, h, w, c = frames_u8.shape
        if c != self.total_channels:
            raise ValueError(f"frames have {c} channels, the model takes "
                             f"{self.total_channels}")
        spans = self.spans
        if group_boxes is None:
            with spans("host/tile_placement"):
                group_boxes = [self.boxes_for(m, (h, w))
                               for m in eroded_masks]
        with spans("host/mask_stack"):
            masks = [self._mask_tensor(m, (h, w)) for m in eroded_masks]
            if len({m.dtype for m in masks}) > 1:
                masks = [m.astype(np.float32) for m in masks]
            masks = np.stack(masks)
        with spans("host/upload"):
            frames_d = torch.from_numpy(frames_u8).to(self.device)
            masks_d = torch.from_numpy(masks).to(self.device)
        u8 = self.dispatch(frames_d, masks_d, group_boxes)
        with spans("host/readback"):
            return u8.cpu().numpy()

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

    def load_frame_parts(self, input_path: Path) -> List[np.ndarray]:
        """[(H, W, 3) uint8 RGB, then each guide channel's first bands]."""
        parts = [decode_rgb_uint8(input_path)]
        for name, ccfg in self.additional_channels.items():
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

    def _load_for_dispatch(self, input_path: Path,
                           mask_dir: Path) -> Staged:
        """Decode, erode, place tiles and stage one frame for dispatch, on
        a prefetch thread (JAX ``engine.py:623-667`` without the crop
        window). On a CUDA device the frame and its mask go up through
        pinned buffers on the engine's copy stream; on the CPU they stay
        host tensors."""
        spans = self.spans
        with spans("host/decode"):
            parts = self.load_frame_parts(input_path)
        hw = parts[0].shape[:2]
        with spans("host/mask"):
            mask = self.load_eroded_mask(mask_dir / input_path.name, hw)
        with spans("host/tile_placement"):
            boxes = self.boxes_for(mask, hw)
        with spans("host/upload"):
            frame_d, _ = stage_upload(parts, self.device, self.upload_pools,
                                      self.copy_stream)
            # the mask's copy follows the frame's on the one copy stream,
            # so its event covers both
            mask_d, ready = stage_upload([self._mask_tensor(mask, hw)],
                                         self.device, self.upload_pools,
                                         self.copy_stream)
        return Staged(frame_d, mask_d, ready, boxes, input_path)

    def process_directory(self) -> int:
        """Stylize every frame of paths.input_dir into paths.output_dir, as
        a stream (see the module's docstring).

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
        self._check_channel_dirs()
        output_dir.mkdir(parents=True, exist_ok=True)
        files = _image_files(input_dir)
        self.logger.info(f"Found {len(files)} images to process")

        writer = FrameWriter(num_threads=WRITER_THREADS,
                             compress_level=WRITER_LEVEL)
        pipe = GroupPipeline(self, writer, output_dir)
        group: List[Staged] = []
        group_size = None

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

        pool = ThreadPoolExecutor(max_workers=PREFETCH_THREADS)
        try:
            futures = {p: pool.submit(self._load_for_dispatch, p, mask_dir)
                       for p in files[:PREFETCH]}
            for i, path in enumerate(files):
                if i + PREFETCH < len(files):
                    nxt = files[i + PREFETCH]
                    futures[nxt] = pool.submit(self._load_for_dispatch, nxt,
                                               mask_dir)
                try:
                    with self.spans("host/load_wait"):
                        staged = futures.pop(path).result()
                except Exception as e:
                    self.logger.error(f"Failed to process {path.name}: {e}")
                    continue
                if group and group[0].frame.shape != staged.frame.shape:
                    flush_group()  # a group holds frames of one shape
                if group_size is None:
                    group_size = self._group_size(len(staged.boxes))
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
            pipe.drain_all()
            pipe.close()
            with self.spans("host/writer_drain"):
                failed = writer.flush()
            writer.close()
            if failed:
                self.logger.error(f"{failed} frame writes failed")
        return pipe.submitted - failed

    def _group_size(self, n_boxes: int) -> int:
        if self.frames_per_dispatch != "auto":
            return max(1, int(self.frames_per_dispatch))
        fpd = frames_per_dispatch(max(1, n_boxes), target=self.max_tile_batch)
        self.logger.info(f"Co-batching {fpd} frames/dispatch "
                         f"(~{n_boxes} tiles/frame)")
        return fpd
