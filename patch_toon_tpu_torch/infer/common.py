"""Shared inference helpers: normalization, mask wire forms, crop windows,
composite, image listing, and the host clock of each serving step.

Counterparts of ``patch_toon_tpu/infer/common.py`` (``_to_signed_unit``
:21-34, ``_mask_f32`` :36-50, ``_composite_u8`` :66-75, ``_image_files``
:52-64, ``mask_support_bbox`` / ``compute_crop_bbox`` /
``upload_crop_window`` :108-196), with the same arithmetic in the same
order so uint8 outputs agree with the JAX package, and the same crop rules
so the windows are JAX's.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patch_toon_tpu_torch.data.io import SIGNED_UNIT, list_images

_TABLES: Dict[torch.device, torch.Tensor] = {}


def _signed_unit_table(device: torch.device) -> torch.Tensor:
    table = _TABLES.get(device)
    if table is None:
        table = _TABLES[device] = torch.from_numpy(SIGNED_UNIT).to(device)
    return table


def _to_signed_unit(frame: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> fp32 [-1, 1] as /255*2-1 (reference dataset.py:191),
    gathered from :data:`SIGNED_UNIT` so every device gives the host's
    IEEE values: serving follows the JAX package's host arithmetic (its
    dataset's), not its jitted inference program, which is 1 ulp off at
    205 bytes (a uint8 output moves by at most 1 count); float input passes
    through."""
    if frame.dtype == torch.uint8:
        return _signed_unit_table(frame.device)[frame.to(torch.int32)]
    return frame


def pack_mask(mask: np.ndarray) -> Optional[np.ndarray]:
    """The bit-packed wire form of a mask (..., H, W) whose values are all
    0 or 1: ``np.packbits`` of each flattened plane -> (..., ceil(H*W/8))
    uint8 (JAX ``engine.py:533-536``, 8x fewer bytes than the uint8
    plane); None for a fractional mask, which goes up as an fp32 plane."""
    u8 = np.asarray(mask).astype(np.uint8)
    if not (u8 == mask).all():
        return None
    return np.packbits(u8.reshape(*u8.shape[:-2], -1), axis=-1)


_BIT_SHIFTS: Dict[torch.device, torch.Tensor] = {}


def _bit_shifts(device: torch.device) -> torch.Tensor:
    """(8,) int32 shifts 7..0 on ``device``, made once: a captured CUDA
    graph finds it made by its warm-up (no host upload inside a
    capture)."""
    t = _BIT_SHIFTS.get(device)
    if t is None:
        t = _BIT_SHIFTS[device] = torch.arange(
            7, -1, -1, dtype=torch.int32).to(device)
    return t


def unpack_mask(packed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``np.unpackbits(packed, axis=-1, count=h*w)`` on the device:
    (..., ceil(h*w/8)) uint8 -> (..., h, w) uint8 {0, 1}, most significant
    bit first; the pad bits of the last byte are dropped (JAX's
    ``jnp.unpackbits(..., count=H*W)``)."""
    bits = (packed.to(torch.int32)[..., None] >> _bit_shifts(packed.device)
            ) & 1
    bits = bits.reshape(*packed.shape[:-1], -1)[..., :h * w]
    return bits.to(torch.uint8).reshape(*packed.shape[:-1], h, w)


def mask_f32(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A mask in any wire form as the fp32 plane the composite takes (JAX
    ``_mask_f32``): a packed mask is recognized by rank, ``like`` (the
    frames it belongs to, (..., H, W, C)) having two more axes than it
    ((..., ceil(H*W/8))), and is unpacked to (..., H, W, 1); a uint8 or
    fp32 plane (..., H, W, 1) is cast."""
    if mask.dim() == like.dim() - 2:
        h, w = like.shape[-3], like.shape[-2]
        return unpack_mask(mask, h, w)[..., None].float()
    return mask.float()


Bbox = Tuple[int, int, int, int]


def mask_support_bbox(mask: np.ndarray) -> Bbox:
    """(y0, y1, x0, x1) of a mask's nonzero support; (0, 0, 0, 0) for an
    empty mask. Every pixel the composite can change lies inside it."""
    rows = np.flatnonzero(mask.any(axis=1))
    if not len(rows):
        return (0, 0, 0, 0)
    cols = np.flatnonzero(mask.any(axis=0))
    return (int(rows[0]), int(rows[-1]) + 1,
            int(cols[0]), int(cols[-1]) + 1)


def compute_crop_bbox(mask_boxes: Sequence[Optional[Bbox]], h: int, w: int,
                      align: int = 64, full_frac: float = 0.85
                      ) -> Optional[Bbox]:
    """The readback box of a group of frames: the union of their mask
    supports, padded out to ``align``-multiples (so mask drift gives few
    distinct shapes) and clipped to the frame. None when a frame has no
    mask (stylized everywhere) or the box covers ``full_frac`` of the
    frame or more; all masks empty read one row of one aligned block."""
    if any(mb is None for mb in mask_boxes):
        return None
    live = [mb for mb in mask_boxes if mb[1] > mb[0]]
    if not live:
        live = [(0, 1, 0, 1)]
    y0 = min(mb[0] for mb in live)
    y1 = max(mb[1] for mb in live)
    x0 = min(mb[2] for mb in live)
    x1 = max(mb[3] for mb in live)
    y0, x0 = (y0 // align) * align, (x0 // align) * align
    y1 = min(h, -(-y1 // align) * align)
    x1 = min(w, -(-x1 // align) * align)
    if (y1 - y0) * (x1 - x0) >= full_frac * h * w:
        return None
    return y0, y1, x0, x1


def upload_crop_window(boxes: Sequence[Sequence[int]], h: int, w: int,
                       ps: int, bucket: int = 128, full_frac: float = 0.9,
                       support_bbox: Optional[Bbox] = None
                       ) -> Optional[Bbox]:
    """The window a masked tiled frame is cropped to before upload: the
    union of every tile's gather footprint (the ``ps x ps`` square centred
    on its box) and the mask's support (tile placement stride-samples the
    mask, so a speckle pixel can fall outside every tile; inside the
    window it composites as in the whole frame), its sides rounded up to
    ``bucket``-multiples and clipped to the frame, its origin slid to keep
    it inside. Running the tiled program on the window with the boxes
    shifted by its origin, and pasting the output into the input bytes,
    gives the whole frame's output bit for bit. None without tiles or when
    the window covers ``full_frac`` of the frame or more."""
    if not boxes:
        return None
    rd = []
    for y0b, y1b, x0b, x1b in boxes:
        hoff = (ps - (y1b - y0b)) // 2
        woff = (ps - (x1b - x0b)) // 2
        rd.append((y0b - hoff, y0b - hoff + ps, x0b - woff, x0b - woff + ps))
    if support_bbox is not None and support_bbox[1] > support_bbox[0]:
        rd.append(tuple(support_bbox))
    uy0 = max(0, min(r[0] for r in rd))
    uy1 = min(h, max(r[1] for r in rd))
    ux0 = max(0, min(r[2] for r in rd))
    ux1 = min(w, max(r[3] for r in rd))
    bh = min(h, -(-(uy1 - uy0) // bucket) * bucket)
    bw = min(w, -(-(ux1 - ux0) // bucket) * bucket)
    if bh * bw >= full_frac * h * w:
        return None
    y0 = max(0, min(uy0, h - bh))
    x0 = max(0, min(ux0, w - bw))
    return y0, y0 + bh, x0, x0 + bw


def _composite_u8(rgb: torch.Tensor, out: torch.Tensor, mask: torch.Tensor):
    """Masked composite, clip and uint8 rounding (reference
    generator.py:562-563 and 643-652). -> (uint8, composited float)."""
    out = rgb * (1.0 - mask) + out * mask
    out = torch.clamp(out, -1.0, 1.0)
    u8 = torch.round(torch.clamp((out + 1.0) * 127.5, 0.0, 255.0)).to(
        torch.uint8)
    return u8, out


def _image_files(directory) -> List[Path]:
    """Sorted image paths (.png/.jpg/.jpeg, any case); [] for a missing
    directory."""
    try:
        return [Path(directory) / f for f in list_images(directory)]
    except (FileNotFoundError, NotADirectoryError):
        return []


class HostSpans:
    """Host seconds and calls of each named serving step, from any thread.

    ``with spans("host/decode"): ...`` adds the block's host-clock time to
    its name and opens a ``torch.profiler`` range of that name, so a trace
    shows the steps of the thread that started the profiler, and these
    sums cover every thread (the profiler records ranges only on its own).
    Costs two clock reads and a lock a block."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.calls[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{name: {"ms": total host ms, "calls": n}}."""
        with self._lock:
            return {k: {"ms": 1e3 * v, "calls": self.calls[k]}
                    for k, v in sorted(self.seconds.items())}
