"""Tiled video stylization on one device, synchronously.

Counterpart of ``patch_toon_tpu/infer/engine.py::StyleTransferInference``
in ``tiled`` mode. ``process_directory`` lists the input frames, loads each
frame with its guide channels and eroded mask, co-batches frames so one
generator batch holds about ``inference.tile_batch`` tiles
(``frames_per_dispatch``: three 540x960 frames of 170 tiles go in one
bucket of 512), runs :meth:`stylize_group` on each group and writes PNGs.
A file that fails is named and skipped (reference generator.py:700-705).

Semantics kept from the JAX engine: the channel count sniffed from the
checkpoint must match the configured guide channels; masks are binarized
(> 128), then eroded with the 7x7 full-support rule; a missing mask
directory whose name ends in ``ignore`` means full-frame stylization; a
fractional mask given to :meth:`stylize_group` is uploaded as fp32 and
composites in part (JAX ``_mask_up``).

Precision ``32`` runs fp32 with TF32 off in cuDNN and matmuls and the
fp32 matmul precision at "highest" (the JAX contract is HIGHEST precision,
patch_toon_tpu/models/layers.py:91-93 for the upsample's products and
:100-119 for the convs).
``bf16`` (the default) runs the convs in bf16 while InstanceNorm statistics
and the smoother BatchNorm stay fp32, as in JAX.

Not ported yet, and refused by name (``NotImplementedError``): modes other
than tiled, precision ``32_fast``, ``quantize=int8``, ``file_shard``,
``devices`` other than 1, ``debug_mode``, ``temporal.enabled`` and
``watch.enabled``. The transport knobs (``crop_readback``, ``crop_upload``,
``upload``, ``mask_upload``, ``readback_streams``, ``xla_options``) change
no output in the JAX package and are no-ops here. Also not ported: the
host/device pipeline and the async writer.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patch_toon_tpu_torch.data.io import (
    decode_rgb_uint8,
    find_corresponding_image,
    image_bands,
    load_mask,
    save_image_uint8,
)
from patch_toon_tpu_torch.infer.common import _image_files
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
from patch_toon_tpu_torch.ops.masks import erode_full_support_np
from patch_toon_tpu_torch.utils.weights import load_generator_state

# distinct tile layouts whose device-resident plan and weights are kept:
# boxes recur exactly for static masks and for maskless frames
_PACK_CACHE = 8


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
    if bool(inf.get("debug_mode", False)):
        raise NotImplementedError(
            "inference.debug_mode=true is not ported yet")
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

    def stylize_group(self, frames_u8: np.ndarray,
                      eroded_masks: Sequence[Optional[np.ndarray]],
                      group_boxes: Optional[Sequence[Sequence[Box]]] = None
                      ) -> np.ndarray:
        """Stylize F frames of one shape in one generator batch.

        frames_u8 (F, H, W, C) uint8 (RGB then guide channels); eroded
        masks (H, W) in [0, 1] or None for full-frame stylization; {0, 1}
        masks upload as uint8, any other as fp32, which composites in part.
        -> (F, H, W, 3) uint8."""
        frames_u8 = np.asarray(frames_u8)
        f, h, w, c = frames_u8.shape
        if c != self.total_channels:
            raise ValueError(f"frames have {c} channels, the model takes "
                             f"{self.total_channels}")
        if group_boxes is None:
            group_boxes = [self.boxes_for(m, (h, w)) for m in eroded_masks]
        plan, weights = self._pack(group_boxes, h, w)
        masks = np.stack([m if m is not None else np.ones((h, w), np.float32)
                          for m in eroded_masks])[..., None]
        binary = masks.astype(np.uint8)
        if (binary == masks).all():
            masks = binary  # lossless, 4x fewer bytes to upload
        else:
            masks = masks.astype(np.float32)
        fn = make_multiframe_fn(self.model, self.patch_size, f, h, w,
                                self.dtype)
        u8, _ = fn(torch.from_numpy(frames_u8).to(self.device), plan,
                   weights, torch.from_numpy(masks).to(self.device))
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

    def load_frame(self, input_path: Path) -> np.ndarray:
        """(H, W, C) uint8: RGB, then each guide channel's first bands."""
        parts = [decode_rgb_uint8(input_path)]
        for name, ccfg in self.additional_channels.items():
            cpath = find_corresponding_image(ccfg["path"], str(input_path))
            if not os.path.exists(cpath):
                raise FileNotFoundError(
                    f"Required channel {name} not found: {cpath}")
            parts.append(decode_rgb_uint8(cpath)[..., :ccfg["depth"]])
        return np.concatenate(parts, axis=-1)

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

    def process_directory(self) -> int:
        """Stylize every frame of paths.input_dir into paths.output_dir.

        -> the number of frames written."""
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

        written = 0
        group: List[Tuple[np.ndarray, Optional[np.ndarray], List[Box],
                          Path]] = []
        group_size = None

        def flush() -> None:
            nonlocal group, written
            if not group:
                return
            g, group = group, []
            try:
                out = self.stylize_group(np.stack([x[0] for x in g]),
                                         [x[1] for x in g],
                                         [x[2] for x in g])
            except Exception as e:
                names = ", ".join(x[3].name for x in g)
                self.logger.error(f"Group failed; dropping [{names}]: {e}")
                return
            for k, (_, _, _, path) in enumerate(g):
                try:
                    save_image_uint8(out[k], output_dir / path.name)
                    written += 1
                except Exception as e:
                    self.logger.error(f"Failed to write {path.name}: {e}")

        for path in files:
            try:
                frame = self.load_frame(path)
                mask = self.load_eroded_mask(mask_dir / path.name,
                                             frame.shape[:2])
                boxes = self.boxes_for(mask, frame.shape[:2])
            except Exception as e:
                self.logger.error(f"Failed to process {path.name}: {e}")
                continue
            if group and group[0][0].shape != frame.shape:
                flush()
            if group_size is None:
                group_size = self._group_size(len(boxes))
            group.append((frame, mask, boxes, path))
            if len(group) >= group_size:
                flush()
        flush()
        return written

    def _group_size(self, n_boxes: int) -> int:
        if self.frames_per_dispatch != "auto":
            return max(1, int(self.frames_per_dispatch))
        fpd = frames_per_dispatch(max(1, n_boxes), target=self.max_tile_batch)
        self.logger.info(f"Co-batching {fpd} frames/dispatch "
                         f"(~{n_boxes} tiles/frame)")
        return fpd
