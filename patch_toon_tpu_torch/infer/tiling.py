"""Tile grid and Gaussian blending windows (host side, numpy).

Copy of ``patch_toon_tpu/infer/tiling.py``, with tile placement in numpy
instead of a Python loop. Tile placement follows the reference exactly (generator.py:353-398): walk the row-major nonzero list of
the eroded mask with step = stride over the list index, dedupe by the
(y // stride, x // stride) cell, and emit boxes
(max(0, y - ps/2), min(H, y + ps/2), max(0, x - ps/2), min(W, x + ps/2)).
The blending window is a separable exp(-((i - n/2)^2 / (n/4)^2)) on the box
size, resized (half-pixel bilinear) to the patch size for boxes clipped at
the frame border (generator.py:527-539).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from patch_toon_tpu_torch.ops.resize import resize_bilinear_np

Box = Tuple[int, int, int, int]  # y_start, y_end, x_start, x_end


def tile_boxes_from_mask(eroded_mask: np.ndarray, patch_size: int,
                         overlap_percent: float = 30.0) -> List[Box]:
    """The reference's walk, in numpy: every ``stride``-th entry of the
    row-major nonzero list (``flatnonzero`` of a bool plane, several times
    faster than ``nonzero`` of the float mask), the first entry of each (y // stride,
    x // stride) cell (``np.unique(..., return_index=True)``), in the
    order of the list. No Python loop, so the prefetch threads that place
    tiles hold the interpreter lock only briefly."""
    overlap = min(max(overlap_percent, 0.0), 100.0) / 100.0
    stride = max(1, int(patch_size * (1.0 - overlap)))
    half = patch_size // 2
    h, w = eroded_mask.shape[-2:]

    flat = np.flatnonzero(np.asarray(eroded_mask).reshape(-1) != 0)
    ys, xs = np.divmod(flat[::stride], w)
    cells = (ys // stride) * (w // stride + 1) + xs // stride
    first = np.sort(np.unique(cells, return_index=True)[1])
    y, x = ys[first], xs[first]
    boxes = np.stack([np.maximum(0, y - half), np.minimum(h, y + half),
                      np.maximum(0, x - half), np.minimum(w, x + half)],
                     axis=1)
    return [tuple(b) for b in boxes.tolist()]


@functools.lru_cache(maxsize=1024)
def gaussian_tile_weight(box_h: int, box_w: int,
                         patch_size: int) -> np.ndarray:
    """(patch_size, patch_size) float32 blending window for a clipped box."""
    wy = np.exp(-((np.arange(box_h, dtype=np.float32) - box_h / 2) ** 2
                  / (box_h / 4) ** 2))
    wx = np.exp(-((np.arange(box_w, dtype=np.float32) - box_w / 2) ** 2
                  / (box_w / 4) ** 2))
    weight = np.outer(wy, wx).astype(np.float32)
    if weight.shape != (patch_size, patch_size):
        weight = resize_bilinear_np(
            weight, (patch_size, patch_size), align_corners=False
        ).astype(np.float32)
    return weight


def bucket_size(n: int, minimum: int = 32) -> int:
    """Round a tile count up to a batch bucket: powers of two up to 32,
    then the next multiple of 128. Outputs do not depend on the bucket
    (padding rows carry zero weight; instance norm is per sample)."""
    b = minimum
    while b < n and b < 32:
        b *= 2
    if n <= b:
        return b
    return (n + 127) // 128 * 128


def pack_boxes_multi(per_frame_boxes: List[List[Box]], patch_size: int,
                     bucket: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack several frames' tiles into one batch.

    -> (fboxes (bucket, 5) int32 [frame, y0, y1, x0, x1],
        weights (bucket, ps, ps) f32, n_valid). Padding rows are all zero:
    zero weight, frame 0 and an empty box.
    """
    total = sum(len(b) for b in per_frame_boxes)
    out_boxes = np.zeros((bucket, 5), dtype=np.int32)
    out_weights = np.zeros((bucket, patch_size, patch_size), dtype=np.float32)
    i = 0
    for f, boxes in enumerate(per_frame_boxes):
        for (y0, y1, x0, x1) in boxes:
            out_boxes[i] = (f, y0, y1, x0, x1)
            out_weights[i] = gaussian_tile_weight(y1 - y0, x1 - x0, patch_size)
            i += 1
    return out_boxes, out_weights, total


def frames_per_dispatch(tiles_per_frame: int, max_frames: int = 4,
                        target: int = 512) -> int:
    """How many frames to co-batch so one generator batch holds about
    ``target`` tiles (3 x 170-tile 540x960 frames -> 510 tiles)."""
    if tiles_per_frame <= 0:
        return 1
    return int(max(1, min(max_frames, target // max(1, tiles_per_frame))))


def pack_boxes(boxes: List[Box], patch_size: int,
               bucket: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (boxes (bucket, 4) int32, weights (bucket, ps, ps) f32, n_valid)."""
    n = len(boxes)
    out_boxes = np.zeros((bucket, 4), dtype=np.int32)
    out_weights = np.zeros((bucket, patch_size, patch_size), dtype=np.float32)
    for i, (y0, y1, x0, x1) in enumerate(boxes):
        out_boxes[i] = (y0, y1, x0, x1)
        out_weights[i] = gaussian_tile_weight(y1 - y0, x1 - x0, patch_size)
    return out_boxes, out_weights, n


def draw_tile_boxes(frame: np.ndarray, boxes: List[Box],
                    width: int = 2) -> np.ndarray:
    """A copy of ``frame`` (H, W, 3) uint8 with each box outlined, as the
    JAX engine's debug overlay draws it (``engine.py:569-582``, reference
    generator.py:301-325): PIL's ``ImageDraw.rectangle([x0, y0, x1, y1],
    width=2)``, both ends included and clipped to the frame, one colour a
    box from ``np.random.default_rng(0).integers(100, 256, 3)`` in box
    order, a later box over an earlier one."""
    out = np.array(frame, dtype=np.uint8, copy=True)
    rng = np.random.default_rng(0)
    for y0, y1, x0, x1 in boxes:
        color = rng.integers(100, 256, 3).astype(np.uint8)
        out[y0:y0 + width, x0:x1 + 1] = color
        out[max(0, y1 - width + 1):y1 + 1, x0:x1 + 1] = color
        out[y0:y1 + 1, x0:x0 + width] = color
        out[y0:y1 + 1, max(0, x1 - width + 1):x1 + 1] = color
    return out
