"""Mask morphology on the host (numpy), for inference and training.

The reference uses a 7x7 ones-conv twice, and the asymmetry is kept:

- ``erode_full_support_np`` (copy of JAX ``ops/masks.py``; inference,
  reference generator.py:327-351): values below ``threshold`` are zeroed,
  then a pixel survives only when its whole ``k x k`` zero-padded
  neighbourhood is nonzero;
- ``dilate_valid_centers`` (JAX ``ops/masks.py:40``; training, reference
  dataset.py:161-174): a pixel is a valid patch centre when its ``k x k``
  neighbourhood holds any nonzero value.

Both count nonzero pixels in each window with integer sums, exact in any
order, so they match the JAX package's fp32 device conv bit for bit on a
{0, 1} mask (and, for the dilation, on any mask of non-negative values).
"""

from __future__ import annotations

import numpy as np


def erode_full_support_np(mask, kernel_size: int = 7,
                          threshold: float = 0.4) -> np.ndarray:
    """Eroded {0,1} float32 mask of a BINARY mask; raises on other values."""
    m = np.asarray(mask, np.float32)
    m = np.where(m < threshold, 0.0, m)
    u = np.unique(m)
    if not np.isin(u, (0.0, 1.0)).all():
        raise ValueError(
            "erode_full_support_np requires a binary {0,1} mask after "
            f"thresholding (got values {u[:8]})")
    counts = _window_counts(m.astype(np.uint16), kernel_size)
    return (counts == kernel_size * kernel_size).astype(np.float32)


def _window_counts(m: np.ndarray, k: int) -> np.ndarray:
    """Sum of a {0, 1} uint16 plane over each zero-padded k x k window."""
    pad = k // 2

    def wsum(a, axis):
        ap = np.pad(a, [(pad, pad) if i == axis else (0, 0)
                        for i in range(a.ndim)])
        out = np.zeros(a.shape, np.uint16)
        n = a.shape[axis]
        sl = [slice(None)] * a.ndim
        for off in range(k):
            sl[axis] = slice(off, off + n)
            out += ap[tuple(sl)]
        return out

    return wsum(wsum(m, 0), 1)


def dilate_valid_centers(mask, kernel_size: int = 7) -> np.ndarray:
    """Training-side valid-centre map, float32 {0, 1}: 1 where the k x k
    window holds a nonzero value. Its ``np.nonzero`` coordinates, in
    row-major order (torch ``nonzero``), are the patch centres."""
    m = np.asarray(mask, np.float32)
    if (m < 0).any():
        raise ValueError("dilate_valid_centers takes a mask of non-negative "
                         "values")
    counts = _window_counts((m > 0).astype(np.uint16), kernel_size)
    return (counts > 0).astype(np.float32)
