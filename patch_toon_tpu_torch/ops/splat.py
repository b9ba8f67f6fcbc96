"""Anti-aliased Gaussian point splatting (counterpart of
``patch_toon_tpu/ops/splat.py::splat_points``).

Each valid point alpha-composites a Gaussian blob of its colour over the
canvas, ``out = out * (1 - wt) + color * wt`` with
``wt = exp(-((xi - x)^2 + (yi - y)^2) / sigma^2)``, in ascending point
order (the reference's numba ``_draw_points_numba``,
tools/gaussian_filter.py:122-141; JAX runs it as a sequential
``lax.scan``). A point's window is the intersection of JAX's two ranges
(splat.py:41-59), per axis, with ``r = int(3 * sigma)``:

- ``[floor(y) - r, floor(y) - r + 2r + 2)``, the scan's padded slice;
- ``[trunc(y - r), trunc(y + r)]``, the reference's bounds, C truncation
  toward zero of fp32 sums.

The scan's result over the canvas is, per pixel, the blobs that cover the
pixel applied in point order. So on a CUDA tensor :func:`splat_points`
launches ``csrc/splat.cu``, where each block of pixels walks, in order, the
list of the points whose window meets it; on a CPU
tensor it runs :func:`splat_points_plain`, the per-point loop. Both round
each operation in the same order, so on the card they agree bit for bit.
JAX's ``dynamic_slice`` clamps a window that leaves the padded canvas; that
happens only for a point with ``floor(x)`` outside [-1, W - 1] (or y), which
the guide tool never draws (advection invalidates a point that leaves the
frame), and here such a point simply covers the pixels its window holds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from patch_toon_tpu_torch import _build


def splat_radius(sigma: float) -> int:
    return int(3 * sigma)


def _window(c: np.float32, r: int, n: int) -> Tuple[int, int]:
    """Inclusive [lo, hi] of the pixels a point at coordinate ``c`` covers
    along an axis of ``n`` pixels (empty when lo > hi)."""
    f = int(np.floor(c))
    lo = max(f - r, int(c - np.float32(r)), 0)  # int() truncates toward 0
    hi = min(f + r + 1, int(c + np.float32(r)), n - 1)
    return lo, hi


def splat_points_plain(image: torch.Tensor, points: torch.Tensor,
                       colors: torch.Tensor, valid: torch.Tensor,
                       sigma: float) -> torch.Tensor:
    """Plain PyTorch version: the blobs point by point in ascending order,
    each over its window. -> a new (H, W, 3) fp32 canvas."""
    h, w, _ = image.shape
    r = splat_radius(sigma)
    dev = image.device
    # a 0-d tensor on the device: CUDA divides by a host scalar through
    # its reciprocal, the kernel (and JAX) by the value itself
    s2 = torch.tensor(np.float32(sigma * sigma), device=dev)
    out = image.to(torch.float32).clone()
    pts = points.detach().to("cpu", torch.float32).numpy()
    on_dev = points.to(dev, torch.float32)
    cols = colors.to(dev, torch.float32)
    for i in np.flatnonzero(valid.cpu().numpy()):
        y0, y1 = _window(pts[i, 1], r, h)
        x0, x1 = _window(pts[i, 0], r, w)
        if y0 > y1 or x0 > x1:
            continue
        dx = torch.arange(x0, x1 + 1, dtype=torch.float32, device=dev) \
            - on_dev[i, 0]
        dy = torch.arange(y0, y1 + 1, dtype=torch.float32, device=dev) \
            - on_dev[i, 1]
        wt = torch.exp(-((dx * dx)[None, :] + (dy * dy)[:, None]) / s2)
        wt = wt[..., None]
        win = out[y0:y1 + 1, x0:x1 + 1]
        out[y0:y1 + 1, x0:x1 + 1] = win * (1 - wt) + cols[i] * wt
    return out


def splat_points(image: torch.Tensor, points: torch.Tensor,
                 colors: torch.Tensor, valid: torch.Tensor,
                 sigma: float) -> torch.Tensor:
    """Splat ``points`` (N, 2) (x, y) fp32 with ``colors`` (N, 3) fp32 where
    ``valid`` (N,) bool onto ``image`` (H, W, 3) fp32, with Gaussian
    ``sigma``. CUDA: one launch (counted in ``splat_points.launches``).
    CPU: the plain version. -> a new (H, W, 3) fp32 canvas."""
    if image.device.type == "cpu":
        return splat_points_plain(image, points, colors, valid, sigma)
    if image.device.type != "cuda":
        raise ValueError(f"splat_points: unsupported device {image.device}")
    if image.dim() != 3 or image.shape[-1] != 3:
        raise ValueError(f"splat_points: image must be (H, W, 3), got "
                         f"{tuple(image.shape)}")
    n = points.shape[0]
    if points.shape != (n, 2) or colors.shape != (n, 3) \
            or valid.shape != (n,):
        raise ValueError(f"splat_points: points {tuple(points.shape)}, "
                         f"colors {tuple(colors.shape)} and valid "
                         f"{tuple(valid.shape)} disagree")
    for name, t in (("image", image), ("points", points),
                    ("colors", colors)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != image.device:
            raise ValueError(f"splat_points: {name} must be contiguous "
                             f"float32 on {image.device}")
    if valid.dtype != torch.bool or valid.device != image.device:
        raise ValueError(f"splat_points: valid must be bool on "
                         f"{image.device}")
    h, w, _ = image.shape
    out = torch.empty_like(image)
    flags = valid.to(torch.uint8).contiguous()
    rc = _build.library().ptt_splat_points(
        image.data_ptr(), out.data_ptr(), points.data_ptr(),
        colors.data_ptr(), flags.data_ptr(), n, h, w, splat_radius(sigma),
        float(np.float32(sigma * sigma)), image.device.index,
        _build.stream_of(image))
    _build.check(rc, "splat_points")
    _build.count_launch(splat_points, image)
    return out


splat_points.launches = 0
splat_points.by_device = {}
