"""Gaussian-weighted tile compositor (kernel B2) and its host-side binning.

Replaces ``patch_toon_tpu/ops/pallas_blend.py::blend_tiles`` and
``bin_tiles``. For every canvas pixel, ``canvas += gen_t * w_t`` and
``wcanvas += w_t`` over the tiles that cover it, in ascending tile id; each
tile is anchored at its top-left ``(flat_y0, x0)``, and a padding tile
(``flat_y0 < 0``) adds nothing. On a CUDA tensor :func:`blend_tiles`
launches ``csrc/blend.cu``; on a CPU tensor it runs
:func:`blend_tiles_plain`, the ordered per-tile loop. Both round each
product and each sum in the same order, so they agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from patch_toon_tpu_torch import _build

# canvas block of one CUDA block: kBlock in csrc/blend.cu. The TPU kernel
# used 256 x 256 blocks; 32 x 32 gives the H100's 132 SMs ~2,000 blocks at
# three co-batched 540x960 frames instead of 40.
BLOCK = 32


def _span(ps: int, b: int) -> int:
    """Most blocks of edge ``b`` that ``ps`` consecutive pixels can touch."""
    return -(-(ps - 1) // b) + 1


def bin_tiles(positions, canvas_h: int, canvas_w: int, ps: int,
              by: int = BLOCK, bx: int = BLOCK) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """CSR binning of tiles to ``by x bx`` canvas blocks -> (offsets, ids).

    ``offsets`` has nblocks + 1 entries; block b holds the tile ids
    ``ids[offsets[b]:offsets[b + 1]]`` in ascending order. ``ids`` is
    zero-padded to (most blocks a tile can touch, at least 4) x n_tiles.
    The same CSR as the JAX package's loop, built with numpy.
    """
    pos = np.asarray(positions, np.int64).reshape(-1, 2)
    nby = -(-canvas_h // by)
    nbx = -(-canvas_w // bx)
    nblocks = nby * nbx
    t = np.flatnonzero(pos[:, 0] >= 0)
    y0, x0 = pos[t, 0], pos[t, 1]
    bi0 = np.maximum(0, y0 // by)
    bi1 = np.minimum(nby - 1, (y0 + ps - 1) // by)
    bj0 = np.maximum(0, x0 // bx)
    bj1 = np.minimum(nbx - 1, (x0 + ps - 1) // bx)
    ny = np.maximum(0, bi1 - bi0 + 1)
    nx = np.maximum(0, bj1 - bj0 + 1)
    cnt = ny * nx
    k = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    nx_r = np.repeat(nx, cnt)
    blk = (np.repeat(bi0, cnt) + k // np.maximum(nx_r, 1)) * nbx \
        + np.repeat(bj0, cnt) + k % np.maximum(nx_r, 1)
    order = np.argsort(blk, kind="stable")  # keeps tile order in a block
    offsets = np.zeros(nblocks + 1, np.int32)
    offsets[1:] = np.cumsum(np.bincount(blk, minlength=nblocks))
    per_tile = max(4, _span(ps, by) * _span(ps, bx))
    ids = np.zeros(max(1, per_tile * len(pos)), np.int32)
    ids[:len(order)] = np.repeat(t, cnt)[order]
    return offsets, ids


def blend_tiles_plain(gen: torch.Tensor, weights: torch.Tensor, positions,
                      canvas_h: int,
                      canvas_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``canvas[y:y+ps, x:x+ps] += tile * w`` tile by
    tile in ascending id. -> (canvas (H, W, 3), wcanvas (H, W, 1))."""
    ps = gen.shape[1]
    canvas = torch.zeros((canvas_h, canvas_w, 3), dtype=torch.float32,
                         device=gen.device)
    wcanvas = torch.zeros((canvas_h, canvas_w, 1), dtype=torch.float32,
                          device=gen.device)
    pos = positions.cpu().numpy() if isinstance(positions, torch.Tensor) \
        else np.asarray(positions)
    for t, (y, x) in enumerate(pos.reshape(-1, 2).tolist()):
        if y < 0:
            continue
        w = weights[t][..., None]
        canvas[y:y + ps, x:x + ps] += gen[t] * w
        wcanvas[y:y + ps, x:x + ps] += w
    return canvas, wcanvas


def _on(a, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(a)
    if t.dtype != torch.int32:
        raise TypeError(f"blend_tiles: index arrays must be int32, got "
                        f"{t.dtype}")
    return t.to(device).contiguous()


def blend_tiles(gen: torch.Tensor, weights: torch.Tensor, positions,
                offsets, ids, canvas_h: int,
                canvas_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend ``gen`` (B, ps, ps, 3) f32 with ``weights`` (B, ps, ps) f32 at
    ``positions`` (B, 2) int32 into an ``canvas_h x canvas_w`` canvas.

    ``offsets`` and ``ids`` come from :func:`bin_tiles` at the default
    block. CUDA: one launch (counted in ``blend_tiles.launches``). CPU: the
    plain version. -> (canvas (H, W, 3), wcanvas (H, W, 1)).
    """
    if gen.device.type == "cpu":
        return blend_tiles_plain(gen, weights, positions, canvas_h, canvas_w)
    if gen.device.type != "cuda":
        raise ValueError(f"blend_tiles: unsupported device {gen.device}")
    n, ps = gen.shape[0], gen.shape[1]
    if gen.shape != (n, ps, ps, 3) or weights.shape != (n, ps, ps):
        raise ValueError(f"blend_tiles: gen {tuple(gen.shape)} and weights "
                         f"{tuple(weights.shape)} disagree")
    for name, t in (("gen", gen), ("weights", weights)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != gen.device:
            raise ValueError(f"blend_tiles: {name} must be contiguous "
                             f"float32 on {gen.device}")
    pos, offs, tid = (_on(a, gen.device) for a in (positions, offsets, ids))
    nblocks = -(-canvas_h // BLOCK) * -(-canvas_w // BLOCK)
    if pos.shape != (n, 2) or offs.shape != (nblocks + 1,) \
            or tid.numel() < max(4, _span(ps, BLOCK) ** 2) * n:
        raise ValueError("blend_tiles: positions, offsets or ids do not "
                         f"match {n} tiles on {nblocks} blocks of {BLOCK} "
                         "as bin_tiles builds them")
    canvas = torch.empty((canvas_h, canvas_w, 3), dtype=torch.float32,
                         device=gen.device)
    wcanvas = torch.empty((canvas_h, canvas_w, 1), dtype=torch.float32,
                          device=gen.device)
    lib = _build.library()
    rc = lib.ptt_blend_tiles(
        gen.data_ptr(), weights.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        tid.data_ptr(), canvas.data_ptr(), wcanvas.data_ptr(), n, ps,
        canvas_h, canvas_w, BLOCK, gen.device.index, _build.stream_of(gen))
    _build.check(rc, "blend_tiles")
    _build.count_launch(blend_tiles, gen)
    return canvas, wcanvas


blend_tiles.launches = 0
blend_tiles.by_device = {}
