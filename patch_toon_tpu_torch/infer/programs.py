"""The serving programs: tiled (a group of co-batched frames) and full-frame.

``make_multiframe_fn`` is the counterpart of
``patch_toon_tpu/infer/programs.py::make_multiframe_fn``
(``_multiframe_body``, :172-234). In order:

1. uint8 frames -> [-1, 1] (``_to_signed_unit``);
2. gather one centre-padded ``ps x ps`` tile per box, zero outside the box
   (row and column validity masks), as a plain index gather;
3. the generator over the whole tile batch, output cast to fp32;
4. blend the tiles into an ``F*(H+ps) x (W+ps)`` canvas with kernel B2, each
   tile placed at its box START ``(f*(H+ps) + y0, x0)`` although the gather
   centred it: the reference does exactly this (generator.py:541-547);
5. divide by the summed weights where they exceed 1e-8;
6. composite through the mask and round to uint8 (``_composite_u8``); a
   bit-packed mask is unpacked on the device first (``mask_f32``).

The host builds a :class:`TilePlan` once per tile layout (the engine caches
it): the boxes, the blend positions and their CSR binning, on the device.
An upload-cropped frame (``inference.crop_upload``) is a frame like any
other here: the window, its mask and its boxes in window coordinates, so
B1 and B2 run on window-sized tiles and canvases.

``make_fullframe_fn`` is the counterpart of ``make_fullframe_fn``
(:26-50), ``inference.mode: fullframe``: one generator pass over each whole
frame, so InstanceNorm takes per-frame statistics (not per-tile ones as the
reference does) and no tile is gathered or blended.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from patch_toon_tpu_torch.infer.common import (
    _composite_u8,
    _to_signed_unit,
    mask_f32,
)
from patch_toon_tpu_torch.ops.blend import bin_tiles, blend_tiles


@dataclass
class TilePlan:
    fboxes: torch.Tensor     # (B, 5) int64 [frame, y0, y1, x0, x1]
    positions: torch.Tensor  # (B, 2) int32 (flat_y0, x0); -10000 = padding
    offsets: torch.Tensor    # (nblocks + 1,) int32 CSR offsets
    ids: torch.Tensor        # int32 CSR tile ids


def make_tile_plan(fboxes: np.ndarray, h: int, w: int, ps: int,
                   device) -> TilePlan:
    """Blend positions and binning for packed boxes (``pack_boxes_multi``).

    A padding row has an empty box (y1 == y0); it is placed nowhere."""
    fb = np.asarray(fboxes, np.int64).reshape(-1, 5)
    pos = np.stack([fb[:, 0] * (h + ps) + fb[:, 1], fb[:, 3]], axis=1)
    pos[fb[:, 2] <= fb[:, 1]] = -10000
    pos = pos.astype(np.int32)
    n_frames = int(fb[:, 0].max()) + 1 if len(fb) else 1
    offsets, ids = bin_tiles(pos, n_frames * (h + ps), w + ps, ps)
    dev = torch.device(device)
    return TilePlan(torch.from_numpy(fb).to(dev), torch.from_numpy(pos).to(dev),
                    torch.from_numpy(offsets).to(dev),
                    torch.from_numpy(ids).to(dev))


def gather_tiles(frames: torch.Tensor, fboxes: torch.Tensor,
                 ps: int) -> torch.Tensor:
    """(F, H, W, C) frames -> (B, ps, ps, C) centre-padded tiles in [-1, 1],
    zero outside each box."""
    f, y0, y1, x0, x1 = fboxes.unbind(1)
    ph, pw = y1 - y0, x1 - x0
    hoff = torch.div(ps - ph, 2, rounding_mode="floor")
    woff = torch.div(ps - pw, 2, rounding_mode="floor")
    r = torch.arange(ps, device=frames.device)
    rows = (ps + y0 - hoff)[:, None] + r
    cols = (ps + x0 - woff)[:, None] + r
    fpad = F.pad(frames, (0, 0, ps, ps, ps, ps))
    tiles = _to_signed_unit(fpad[f[:, None, None], rows[:, :, None],
                                 cols[:, None, :]])
    rv = (r >= hoff[:, None]) & (r < (hoff + ph)[:, None])
    cv = (r >= woff[:, None]) & (r < (woff + pw)[:, None])
    return tiles * rv[:, :, None, None].to(tiles.dtype) \
        * cv[:, None, :, None].to(tiles.dtype)


def make_multiframe_fn(generator: Callable, patch_size: int, n_frames: int,
                       h: int, w: int, dtype: torch.dtype) -> Callable:
    """-> fn(frames (F,H,W,C) u8 or f32, plan, weights (B,ps,ps) f32,
    masks (F,H,W,1) or packed (F,ceil(H*W/8))) -> (uint8 (F,H,W,3),
    composite fp32 (F,H,W,3))."""
    ps = patch_size

    def fn(frames: torch.Tensor, plan: TilePlan, weights: torch.Tensor,
           masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        rgb = _to_signed_unit(frames[..., :3])
        if plan.fboxes.shape[0] == 0:  # no tile: the blend of none is 0
            return _composite_u8(rgb, torch.zeros_like(rgb),
                                 mask_f32(masks, frames))
        tiles = gather_tiles(frames, plan.fboxes, ps).to(dtype)
        with torch.no_grad():
            gen = generator(tiles).float().contiguous()
        canvas, wcanvas = blend_tiles(gen, weights, plan.positions,
                                      plan.offsets, plan.ids,
                                      n_frames * (h + ps), w + ps)
        out = canvas.view(n_frames, h + ps, w + ps, 3)[:, :h, :w]
        wsum = wcanvas.view(n_frames, h + ps, w + ps, 1)[:, :h, :w]
        out = out / torch.where(wsum > 1e-8, wsum, torch.ones_like(wsum))
        return _composite_u8(rgb, out, mask_f32(masks, frames))

    return fn


def make_fullframe_fn(generator: Callable, h: int, w: int,
                      dtype: torch.dtype) -> Callable:
    """-> fn(frames (F,H,W,C) u8 or f32, masks (F,H,W,1) or packed
    (F,ceil(H*W/8))) -> (uint8
    (F,H,W,3), composite fp32 (F,H,W,3)): [-1, 1], zero padding of H and W
    up to multiples of 4 (the generator's two stride-2 stages and two
    upsamples) after the normalization, so that the padded pixels enter
    every InstanceNorm's statistics as zeros, as in the JAX program; the
    generator in ``dtype``, the crop to ``[:h, :w]`` after the head, fp32,
    and the composite through the mask. Each frame is its own sample, so
    frames do not mix."""
    hp, wp = (h + 3) // 4 * 4, (w + 3) // 4 * 4

    def fn(frames: torch.Tensor, masks: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _to_signed_unit(frames)
        xp = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        with torch.no_grad():
            out = generator(xp.to(dtype))[:, :h, :w].float()
        return _composite_u8(x[..., :3], out, mask_f32(masks, frames))

    return fn
