"""The backward warp of the temporal guide.

Counterpart of the warp half of ``patch_toon_tpu/ops/flow.py``:
``_quad_pack`` (:92), ``_quad_sample`` (:109), ``_bilinear_take`` (:63) and
``warp_image`` (:228). A clamped bilinear backward warp in fp32,
``map_coordinates(order=1, mode="nearest")``, as one index gather of the
four taps of each pixel from a table that pairs every pixel with its +x,
+y and +xy neighbours (edge-padded, so the pairing is the clamp at the
last row and column), then the JAX package's interpolation in the same
order of operations. On the card the gather is PyTorch's index kernel; no
TPU kernel stands behind the JAX warp (it is plain XLA).

The on-device flow itself (``dense_flow``, its Lucas-Kanade helpers,
``pil_gray``) is not ported yet.
"""

from __future__ import annotations

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
