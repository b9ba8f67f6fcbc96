"""Video stylization on one device: tiled, full-frame and temporal.

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

Not ported yet, and refused by name (``NotImplementedError``): precision
``32_fast``, ``quantize=int8``, ``file_shard``, ``devices`` other than 1,
the multi-stream temporal layout (a subdirectory per video) and
``watch.enabled``; a mode other than tiled and
fullframe raises ``ValueError``. ``readback_streams`` sets the pipeline's
in-flight window (its value plus 2 frames, the JAX rule). ``upload`` is
validated as JAX does and decides ``temporal.flow_upload: auto`` (f16
unless it resolves to f32), which rounds the flows; otherwise it and the
other transport knobs (``crop_readback``, ``crop_upload``, ``mask_upload``,
``xla_options``) change no output in the JAX package and are no-ops here:
the device flow's mask goes up as a dense uint8 plane.
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
    load_luma,
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
    make_fullframe_fn,
    make_multiframe_fn,
    make_tile_plan,
)
from patch_toon_tpu_torch.infer.temporal import TemporalChain
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


MODES = ("tiled", "fullframe")


def check_unported_inference_knobs(inf: Dict[str, Any]) -> None:
    """Raise NotImplementedError naming each inference knob that asks for
    what this port does not do yet (the JAX engine acts on all of them),
    ValueError for a mode that does not exist."""
    mode = str(inf.get("mode", "tiled"))
    if mode not in MODES:
        raise ValueError(f"inference.mode={mode!r}: expected tiled or "
                         "fullframe")
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
    if bool((inf.get("watch") or {}).get("enabled", False)):
        raise NotImplementedError(
            "inference.watch.enabled=true is not ported yet")


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


class StyleTransferInference(TemporalChain):
    def __init__(self, cfg: Any, device: Optional[str] = None):
        self.cfg = cfg
        inf = cfg.get("inference", {}) or {}
        check_unported_inference_knobs(inf)
        self.mode = str(inf.get("mode", "tiled"))
        self.device = _resolve_device(device, inf)
        self.overlap_percent = float(inf.get("overlap_percent", 30.0))
        self.max_tile_batch = int(inf.get("tile_batch", 512))
        self.frames_per_dispatch = inf.get("frames_per_dispatch", "auto")
        self.readback_streams = max(1, int(inf.get("readback_streams", 6)))
        self.debug_mode = bool(inf.get("debug_mode", False))
        self.precision = inf.get("precision", "bf16")
        self.dtype = _resolve_dtype(self.precision)
        _parse_temporal(self, inf)
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
        if self.temporal_enabled:  # the warped previous output, last
            self.total_channels += self.temporal_depth

        self.model = self._load_model(str(paths["checkpoint"]))
        self._packs: Dict[Any, Any] = {}  # tile layout -> (plan, weights)
        self.spans = HostSpans()
        # staging: pinned host buffers and a copy stream of their own
        self.upload_pools = PinnedPools()
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._temporal_init()  # JAX engine.py:350-351, temporal.py:184

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

    def _run(self, frames: torch.Tensor, masks: torch.Tensor,
             group_boxes: Sequence[Sequence[Box]]):
        """The program of the engine's mode on frames and masks already on
        the device: (F, H, W, C) uint8 or fp32 and (F, H, W, 1) -> (uint8,
        fp32 composite), each (F, H, W, 3) on the device, queued on the
        current stream (no synchronisation). Fullframe mode takes no
        boxes."""
        f, h, w, _ = frames.shape
        if self.mode == "fullframe":
            fn = make_fullframe_fn(self.model, h, w, self.dtype)
            with self.spans("host/dispatch"):
                return fn(frames, masks)
        with self.spans("host/pack"):
            plan, weights = self._pack(group_boxes, h, w)
        fn = make_multiframe_fn(self.model, self.patch_size, f, h, w,
                                self.dtype)
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
        """The current (compute) stream waits for each staged frame's
        upload and is recorded on its tensors, so the copy stream's memory
        is not reused before the program has read it."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        for s in group:
            stream.wait_event(s.ready)
            for t in (s.frame, s.mask, s.flow, s.fmask):
                if t is not None:
                    t.record_stream(stream)

    def dispatch_staged(self, group: Sequence[Staged]) -> torch.Tensor:
        """:meth:`dispatch` of frames staged by :meth:`_load_for_dispatch`:
        the current (compute) stream waits for each frame's upload and is
        recorded on its tensors, so the copy stream's memory is not reused
        before the program has read it."""
        with self.spans("host/stack"):
            self._await_staged(group)
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

    def load_flow(self, position: int) -> Optional[np.ndarray]:
        """Frame ``position``'s backward flow, (H, W, 2), from
        ``flow_dir / (file_format % position).npy``, rounded to float16
        where ``temporal_flow_f16`` says; None without a flow_dir or for a
        missing file (JAX ``temporal.py:316-325``)."""
        if self.temporal_flow_dir is None:
            return None
        path = Path(self.temporal_flow_dir) / \
            f"{self.temporal_format % position}.npy"
        if not path.exists():
            return None
        flow = np.load(str(path))
        if self.temporal_flow_f16 and flow.dtype != np.float16:
            flow = flow.astype(np.float16)
        return flow

    def load_flow_mask(self, input_path: Path,
                       mask_dir: Path) -> Optional[np.ndarray]:
        """The device flow's mask of a frame, (H, W) uint8 {0, 1}: the
        flow tool's rule (luma > 127; JAX ``temporal.py:327-344``), apart
        from the composite mask's > 128; None when the frame has no mask
        file (unmasked flow)."""
        resolved = find_corresponding_image(mask_dir, input_path.name)
        if not os.path.exists(resolved):
            return None
        return (load_luma(resolved) > 127).astype(np.uint8)

    def _load_for_dispatch(self, input_path: Path, mask_dir: Path,
                           position: Optional[int] = None) -> Staged:
        """Decode, erode, place tiles (none in fullframe mode) and stage
        one frame for dispatch, on a prefetch thread (JAX
        ``engine.py:623-667`` without the crop window); with a stream
        ``position`` (the temporal chain) its flow file too, or with the
        device flow its raw flow mask. On a CUDA device the frame, its
        mask and its flow or flow mask go up through pinned buffers on the
        engine's copy stream; on the CPU they stay host tensors."""
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
        with spans("host/upload"):
            frame_d, _ = stage_upload(parts, self.device, self.upload_pools,
                                      self.copy_stream)
            # the later copies follow the frame's on the one copy stream,
            # so the last event covers them all
            mask_d, ready = stage_upload([self._mask_tensor(mask, hw)],
                                         self.device, self.upload_pools,
                                         self.copy_stream)
            flow_d = fmask_d = None
            if flow is not None:
                flow_d, ready = stage_upload([flow], self.device,
                                             self.upload_pools,
                                             self.copy_stream)
            if fmask is not None:
                fmask_d, ready = stage_upload([fmask], self.device,
                                              self.upload_pools,
                                              self.copy_stream)
        return Staged(frame_d, mask_d, ready, boxes, input_path, position,
                      flow_d, fmask_d)

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
        with the temporal guide, as one chain that later calls continue.

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
        if files is None and self.temporal_enabled \
                and self._detect_streams(input_dir):
            raise NotImplementedError(
                f"{input_dir} holds a subdirectory per video: multi-stream "
                "temporal serving is not ported yet (one video a run)")
        self._check_channel_dirs()
        output_dir.mkdir(parents=True, exist_ok=True)
        if files is None:
            files = _image_files(input_dir)
        self.logger.info(f"Found {len(files)} images to process")

        writer = FrameWriter(num_threads=WRITER_THREADS,
                             compress_level=WRITER_LEVEL)
        pipe = GroupPipeline(self, writer, output_dir)
        if self.temporal_enabled:
            return self._process_directory_temporal(files, mask_dir, pipe,
                                                    writer)
        group: List[Staged] = []
        # a fullframe group is one frame (JAX engine.py:767-768)
        group_size = 1 if self.mode == "fullframe" else None

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
        if self.frames_per_dispatch != "auto":
            return max(1, int(self.frames_per_dispatch))
        fpd = frames_per_dispatch(max(1, n_boxes), target=self.max_tile_batch)
        self.logger.info(f"Co-batching {fpd} frames/dispatch "
                         f"(~{n_boxes} tiles/frame)")
        return fpd
