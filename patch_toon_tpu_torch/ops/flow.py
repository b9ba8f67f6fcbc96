"""The on-device optical flow and the backward warp of the temporal guide.

Counterpart of ``patch_toon_tpu/ops/flow.py``: the warp (``_quad_pack`` :92,
``_quad_sample`` :109, ``_bilinear_take`` :63, ``warp_image`` :228), the
pyramidal Lucas-Kanade flow (``_box_filter`` :26, ``_downsample2`` :47,
``_gradients`` :55, ``_lk_refine`` :136, ``dense_flow`` :175,
``masked_flow`` :243) and PIL's luma (``pil_gray`` :251). Everything is
plain tensor arithmetic in fp32 in the JAX package's order of operations
(XLA, with no TPU kernel behind it): elementwise ops, index gathers, the
window sums as shifted adds in ascending order (PARITY_NOTES #22). The
bilinear flow resize between pyramid levels is the two-tap lerp of
``jax.image.resize(..., "bilinear")``'s renormalised triangle weights,
computed on the host in fp32 as JAX computes them, so no matrix product
(and no TF32 setting) reaches it. ``pil_gray`` is integer arithmetic and
bitwise equal to JAX and to PIL.

Flow convention as cv2's: ``flow[y, x] = (dx, dy)`` such that
``img2[y + dy, x + dx] ~ img1[y, x]``. On the card the flow step of the
temporal chain runs these ops as one captured CUDA graph
(``infer/temporal.py::FlowGraphs``); on the CPU they run eagerly.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def _quad_pack(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> the 4-tap table: ``quad[y*(W+1)+x] = [(y,x), (y+1,x),
    (y,x+1), (y+1,x+1)]`` of the edge-padded (H+1, W+1, C) image, so that
    y0+1 and x0+1 at the border read the clamped tap."""
    h, w, c = img.shape
    w1 = w + 1
    pad = torch.cat([img, img[-1:]], dim=0)
    pad = torch.cat([pad, pad[:, -1:]], dim=1)
    flat = pad.reshape((h + 1) * w1, c)
    rowpair = torch.cat([flat[:-w1], flat[w1:]], dim=1)
    return torch.cat([rowpair[:-1], rowpair[1:]], dim=1)


def _quad_sample(quad: torch.Tensor, h: int, w: int, c: int,
                 ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample a :func:`_quad_pack` table at (ys, xs), bilinear, clamped."""
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    fy = (ys - y0f)[..., None]
    fx = (xs - x0f)[..., None]
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    g = quad[(y0 * (w + 1) + x0).reshape(-1)]
    g = g.reshape(ys.shape + (4, c))
    a, c0 = g[..., 0, :], g[..., 1, :]   # (y0,x0), (y1,x0)
    b, d = g[..., 2, :], g[..., 3, :]    # (y0,x1), (y1,x1)
    return (a * (1 - fx) + b * fx) * (1 - fy) \
        + (c0 * (1 - fx) + d * fx) * fy


def _bilinear_take(img: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sampling of (H, W, C) at (ys, xs)."""
    h, w, c = img.shape
    return _quad_sample(_quad_pack(img), h, w, c, ys, xs)


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp an (H, W, C) image by an (H, W, 2) flow (dx, dy):
    ``out[y, x] = img[y + dy, x + dx]``, bilinear, clamped at the edges;
    computed in fp32, returned in img's type."""
    h, w, _ = img.shape
    ys = torch.arange(h, dtype=torch.float32,
                      device=img.device)[:, None] + flow[..., 1]
    xs = torch.arange(w, dtype=torch.float32,
                      device=img.device)[None, :] + flow[..., 0]
    warped = _bilinear_take(img.to(torch.float32), ys, xs)
    return warped.to(img.dtype)


def _box_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable ones-filter of width ``k`` over H and W of (H, W, C), zero
    padding ("same"): ``k`` shifted slices summed in ascending offset, rows
    then columns, as the JAX package sums them."""
    pad = k // 2
    h, w = x.shape[0], x.shape[1]
    y = torch.nn.functional.pad(x, (0, 0, 0, 0, pad, pad))
    acc = y[0:h]
    for d in range(1, k):
        acc = acc + y[d:d + h]
    y = torch.nn.functional.pad(acc, (0, 0, pad, pad))
    out = y[:, 0:w]
    for d in range(1, k):
        out = out + y[:, d:d + w]
    return out


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool of an (H, W) image, odd edges dropped."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    img = img[:2 * h2, :2 * w2]
    return (img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2]
            + img[1::2, 1::2]) / 4.0


def _gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences of an (H, W) image, the edge replicated."""
    px = torch.cat([img[:, :1], img, img[:, -1:]], dim=1)
    py = torch.cat([img[:1], img, img[-1:]], dim=0)
    return (px[:, 2:] - px[:, :-2]) * 0.5, (py[2:] - py[:-2]) * 0.5


def _resize_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, ...]:
    """The two taps of each output sample of ``jax.image.resize(...,
    "bilinear")`` along one axis, upsampling: (lo, hi, w_lo, w_hi), the
    triangle kernel at half-pixel centres renormalised by its sum, in fp32
    as JAX computes it (``compute_weight_mat``). At an edge the one tap in
    range gets weight 1: the edge clamp."""
    f32 = np.float32
    inv = f32(1.0 / (out_size / in_size))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    lo = np.floor(sample).astype(np.int64)
    hi = lo + 1
    w_lo = np.maximum(f32(0), f32(1) - np.abs(sample - lo.astype(f32)))
    w_hi = np.maximum(f32(0), f32(1) - np.abs(sample - hi.astype(f32)))
    w_lo = np.where(lo >= 0, w_lo, f32(0)).astype(f32)
    w_hi = np.where(hi < in_size, w_hi, f32(0)).astype(f32)
    total = w_lo + w_hi
    w_lo, w_hi = w_lo / total, w_hi / total
    lo, hi = np.clip(lo, 0, in_size - 1), np.clip(hi, 0, in_size - 1)
    return lo, hi, w_lo, w_hi


@functools.lru_cache(maxsize=64)
def _taps_on(in_size: int, out_size: int, device: torch.device):
    """:func:`_resize_taps` on ``device``, made once (a CUDA graph's capture
    finds them there: its warm-up run makes them)."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _resize_taps(in_size, out_size))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (*out_hw, C), "bilinear")`` of an (H, W, C)
    fp32 tensor, for upsampling (out >= in on both axes): rows, then
    columns, each output ``x[lo] * w_lo + x[hi] * w_hi``."""
    h, w = x.shape[0], x.shape[1]
    if out_hw[0] < h or out_hw[1] < w:
        raise ValueError(f"resize_bilinear upsamples only: {(h, w)} -> "
                         f"{tuple(out_hw)}")
    lo, hi, wl, wh = _taps_on(h, out_hw[0], x.device)
    x = x[lo] * wl[:, None, None] + x[hi] * wh[:, None, None]
    lo, hi, wl, wh = _taps_on(w, out_hw[1], x.device)
    return x[:, lo] * wl[None, :, None] + x[:, hi] * wh[None, :, None]


def _lk_refine(i1: torch.Tensor, i2: torch.Tensor, flow: torch.Tensor,
               window: int, iters: int, eps: float) -> torch.Tensor:
    """``iters`` Lucas-Kanade steps at one pyramid level: warp i2 by the
    flow, solve each pixel's windowed 2x2 system, clamp the update to
    +-window. The gather table over i2 is built once for the level."""
    h, w = i2.shape
    quad = _quad_pack(i2[..., None])
    gy = torch.arange(h, dtype=torch.float32, device=i2.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=i2.device)[None, :]
    for _ in range(iters):
        warped = _quad_sample(quad, h, w, 1, gy + flow[..., 1],
                              gx + flow[..., 0])[..., 0]
        ix, iy = _gradients(warped)
        it = warped - i1
        s = _box_filter(torch.stack([ix * ix, ix * iy, iy * iy, ix * it,
                                     iy * it], dim=-1), window)
        axx = s[..., 0] + eps
        axy = s[..., 1]
        ayy = s[..., 2] + eps
        bx = -s[..., 3]
        by = -s[..., 4]
        det = axx * ayy - axy * axy
        du = torch.clamp((ayy * bx - axy * by) / det, -window, window)
        dv = torch.clamp((axx * by - axy * bx) / det, -window, window)
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def dense_flow(img1: torch.Tensor, img2: torch.Tensor, levels: int = 4,
               iters: int = 4, window: int = 15, eps: float = 1e-4,
               scale: int = 1) -> torch.Tensor:
    """Dense flow img1 -> img2 of two (H, W) grayscale images in [0, 1]:
    (H, W, 2) fp32 (dx, dy). ``scale`` 2 or 4 runs the pyramid on the pair
    downsampled that many times over and upsamples the flow back (times
    ``scale``); 1 is exact."""
    if scale not in (1, 2, 4):
        raise ValueError(f"scale={scale!r}: expected 1, 2 or 4")
    full_hw = tuple(img1.shape)
    i1, i2 = img1.to(torch.float32), img2.to(torch.float32)
    s = scale
    while s > 1:
        i1, i2 = _downsample2(i1), _downsample2(i2)
        s //= 2
    pyr: List[Tuple[torch.Tensor, torch.Tensor]] = [(i1, i2)]
    for _ in range(levels - 1):
        a, b = pyr[-1]
        if min(a.shape) // 2 < max(8, window):
            break
        pyr.append((_downsample2(a), _downsample2(b)))
    flow = torch.zeros((*pyr[-1][0].shape, 2), dtype=torch.float32,
                       device=i1.device)
    for a, b in reversed(pyr):
        if tuple(flow.shape[:2]) != tuple(a.shape):
            flow = 2.0 * resize_bilinear(flow, tuple(a.shape))
        flow = _lk_refine(a, b, flow, window, iters, eps)
    if scale > 1:
        flow = scale * resize_bilinear(flow, full_hw)
    return flow


def masked_flow(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor,
                **kwargs) -> torch.Tensor:
    """:func:`dense_flow` zeroed where ``mask`` is not above 0.5 (the flow
    tool's ``flow[~mask] = 0``)."""
    flow = dense_flow(img1, img2, **kwargs)
    return flow * (mask.to(torch.float32) > 0.5)[..., None]


def pil_gray(rgb: torch.Tensor) -> torch.Tensor:
    """PIL's ``convert("L")`` of (..., 3) RGB, bit for bit: ITU-R 601 luma
    in 16.16 fixed point, ``(19595 R + 38470 G + 7471 B + 2^15) >> 16``, as
    uint8. A float input in [-1, 1] is first rounded back to its byte
    (half to even, as ``jnp.round``)."""
    if rgb.dtype != torch.uint8:
        rgb = torch.round(torch.clamp((rgb.to(torch.float32) + 1.0) * 127.5,
                                      0.0, 255.0)).to(torch.uint8)
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).to(
        torch.uint8)
