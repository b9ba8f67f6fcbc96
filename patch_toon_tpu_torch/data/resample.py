"""Pillow's LANCZOS resize of 8-bit images, in plain numpy.

The plain version of ``native/resample.cpp`` (``native.frameio.
resize_lanczos``), which is what the port's tools run: the tests hold both
against Pillow's ``resize(size, Image.Resampling.LANCZOS)``, and the card's
smoke holds the C++ version against this one. It follows Pillow's
``libImaging/Resample.c`` step for step: the filter sinc(x) sinc(x/3) on
[-3, 3), support 3 max(in/out, 1), the taps of each output index normalized
by their double sum and rounded to 22 fractional bits, the sums started at
2^21 and clamped after ``>> 22``; the horizontal pass first, over the rows
the vertical pass reads only, each pass rounding to uint8. The weights use
``math.sin`` (the C library's sine, as Pillow's C code does).
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
SUPPORT = 3.0


def _lanczos(x: float) -> float:
    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def taps(in_size: int, out_size: int):
    """(first, count, weights): each output index's first source index and
    tap count, and the int64 (out_size, ksize) fixed-point weights, zero
    past its taps."""
    scale = float(np.float32(in_size) - np.float32(0.0)) / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        weights[xx, :xmax] = [
            int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0
            else int(0.5 + w * (1 << PRECISION_BITS)) for w in k]
        first[xx], count[xx] = xmin, xmax
    return first, count, weights


def _pass(a: np.ndarray, first: np.ndarray, weights: np.ndarray,
          axis: int) -> np.ndarray:
    """One pass along ``axis`` of the int64 array ``a``, rounded to uint8
    as Pillow's clip8."""
    a = np.moveaxis(a, axis, 0)
    n = a.shape[0]
    acc = np.full((len(first),) + a.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, n - 1)  # a zero weight past the taps
        w = weights[:, j].reshape((-1,) + (1,) * (a.ndim - 1))
        acc += a[idx] * w
    out = np.clip(acc >> PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) resized to (height, width) as Pillow's
    ``resize((width, height), Image.Resampling.LANCZOS)`` of an L or RGB
    image."""
    a = np.asarray(arr)
    if a.dtype != np.uint8 or a.ndim not in (2, 3):
        raise ValueError(f"resize_lanczos: {a.dtype} {a.shape} is not uint8 "
                         f"(H, W[, C])")
    h, w = a.shape[:2]
    out = a.astype(np.int64)
    if width != w:
        lo, hi = 0, h
        if height != h:  # only the rows the vertical pass reads
            vfirst, vcount, _ = taps(h, height)
            lo, hi = int(vfirst[0]), int(vfirst[-1] + vcount[-1])
        first, _, weights = taps(w, width)
        out = _pass(out[lo:hi], first, weights, axis=1)
    if height != h:
        vfirst, _, vweights = taps(h, height)
        if width != w:
            vfirst = vfirst - vfirst[0]
        out = _pass(out, vfirst, vweights, axis=0)
    return out.astype(np.uint8)
