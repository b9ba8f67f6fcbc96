"""JAX's default random draws, reproduced in numpy on the host.

The JAX package initializes the perceptual VGG19 with flax from
``jax.random.PRNGKey(42)`` when no weights file is given
(``patch_toon_tpu/models/perception.py::init_vgg_params``). This module
makes the same draws without jax, so the port can build that network at any
depth (``models/perception.py::init_vgg_state``):

- threefry-2x32 (20 rounds, JAX's rotations, the key-schedule constant
  ``0x1BD11BDA``) over uint32 arrays;
- :func:`prng_key`, :func:`fold_in` and :func:`split` as ``jax.random``
  makes them with the default ``threefry2x32`` implementation;
- :func:`fold_in_static`, flax's ``_fold_in_static`` (SHA-1 of the items,
  no separator, the first four digest bytes big-endian folded in);
- :func:`random_bits` as jax draws 32-bit words with
  ``jax_threefry_partitionable`` on (the default since jax 0.5): the word at
  row-major index ``i`` is ``x0 ^ x1`` of threefry over the counter
  ``(i >> 32, i & 0xFFFFFFFF)``;
- :func:`uniform`, the 23-bit mantissa trick;
- :func:`normal`, ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, in the float32 arithmetic XLA's CPU backend
  compiles for it: Giles' single-precision ``erf_inv`` polynomial with its
  split at ``w = 5`` over ``w = -log1p(-u*u)``, XLA's own ``log1p`` (a
  Cephes rational function below ``|x| = sqrt(2) - 1``, a Cephes ``logf``
  above it), and the fused multiply-adds its x86-64 code makes of them.

Every float step rounds to float32 as that code does; a fused multiply-add
is computed exactly in float64 and rounded once (:func:`_fma`). Keys, bits
and uniforms are bitwise JAX's by construction;
``tests/test_torch_jax_random.py`` holds the normal draws to JAX's.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence, Tuple, Union

import numpy as np

Key = np.ndarray  # shape (2,), uint32

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` under ``key``
    (``jax._src.prng._threefry2x32_lowering``); uint32 arithmetic wraps."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(_KS_PARITY)))
    v0 = np.asarray(x0, _U32) + ks[0]
    v1 = np.asarray(x1, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for step in range(5):
            for r in _ROTATIONS[step % 2]:
                v0 = v0 + v1
                v1 = _rotl(v1, r) ^ v0
            v0 = v0 + ks[(step + 1) % 3]
            v1 = v1 + ks[(step + 2) % 3] + _U32(step + 1)
    return v0, v1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words
    (a seed in int32 range has a zero high word, as JAX without x64 gives)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside int32, where JAX "
                         "without x64 takes it")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: threefry of the counter
    ``(0, data)``."""
    a, b = threefry2x32(key, np.array([0], _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], _U32)


def _counters(start: int, stop: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit counters [start, stop) as (high, low) uint32 words."""
    idx = np.arange(start, stop, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(key: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` with partitionable threefry: key ``i``
    is threefry of the counter ``i``; shape (num, 2)."""
    a, b = threefry2x32(key, *_counters(0, num))
    return np.stack([a, b], axis=1)


def fold_in_static(key: Key, data: Iterable[Union[str, int]]) -> Key:
    """flax's ``_fold_in_static`` (``flax.core.scope``): SHA-1 of the
    items (UTF-8 strings, non-negative ints big-endian in their least whole
    bytes, nothing between items), the digest's first 4 bytes as a
    big-endian word, folded in."""
    data = list(data)
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def _bits_at(key: Key, start: int, stop: int) -> np.ndarray:
    """The words at row-major indices [start, stop) of any draw under
    ``key``."""
    a, b = threefry2x32(key, *_counters(start, stop))
    return a ^ b


def _size(shape: Sequence[int]) -> int:
    return int(np.prod(shape, dtype=np.int64))


def random_bits(key: Key, shape: Sequence[int]) -> np.ndarray:
    """32-bit words of ``jax.random.bits(key, shape, uint32)``."""
    return _bits_at(key, 0, _size(shape)).reshape(tuple(shape))


def _uniform_at(key: Key, start: int, stop: int, minval: float,
                maxval: float) -> np.ndarray:
    """The uniforms at row-major indices [start, stop): the top 23 bits as
    the mantissa of 1.m, minus 1 (exact), times ``maxval - minval`` plus
    ``minval`` (one fused multiply-add in XLA's CPU code), at least
    ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    unit = ((_bits_at(key, start, stop) >> _U32(9)) | _U32(0x3F800000)
            ).view(np.float32) - np.float32(1.0)
    with np.errstate(over="ignore", invalid="ignore"):
        return np.maximum(lo, _fma(unit, np.float32(hi - lo), lo))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _uniform_at(key, 0, _size(shape), minval, maxval).reshape(
        tuple(shape))


def _f32(bits64: int) -> np.float32:
    """A float32 constant given as the float64 bit pattern XLA's LLVM IR
    prints for it."""
    return np.float32(np.array([bits64], np.uint64).view(np.float64)[0])


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once. The product is exact in float64,
    so the float64 sum rounds once more only where it falls exactly halfway
    between two float32 values; there the sum's rounding error (TwoSum)
    says which way the exact value lies."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c64 = np.asarray(c, np.float64)
    s = p + c64
    tie = (s.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    if tie.any():
        p, c64 = np.broadcast_to(p, s.shape), np.broadcast_to(c64, s.shape)
        ts, tp, tc = s[tie], p[tie], c64[tie]
        bb = ts - tp
        err = (tp - (ts - bb)) + (tc - bb)
        s[tie] = np.where(err != 0, np.nextafter(ts, ts + err), ts)
    return s.astype(np.float32)


# XLA's log1p (xla/service/elemental_ir_emitter.cc EmitLog1p, as lowered
# for the CPU): for |x| < sqrt(2) - 1, x - x^2/2 + x^3 * N(x) / D(x) with
# Cephes' log1p coefficients in float32; above it, log(1 + x) through
# Cephes' logf with a split of ln 2.
_LOG1P_SMALL = _f32(0x3FDA8279A0000000)
_LOG1P_NUM = tuple(_f32(b) for b in (
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000))
_LOG1P_DEN = tuple(_f32(b) for b in (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000))
_SQRT_HALF = _f32(0x3FE6A09E60000000)
# logf's polynomial in three interleaved chains (a, b, c) of three terms
_LOGF_A = tuple(_f32(b) for b in (0x3FB2043760000000, 0xBFBD7A3700000000,
                                  0x3FBDE4A340000000))
_LOGF_B = tuple(_f32(b) for b in (0xBFBFCBA9E0000000, 0x3FC23D37E0000000,
                                  0xBFC555CA00000000))
_LOGF_C = tuple(_f32(b) for b in (0x3FC999D580000000, 0xBFCFFFFF80000000,
                                  0x3FD5555540000000))
_LN2_HI = _f32(0x3FE6300000000000)
_LN2_LO = _f32(0xBF2BD01060000000)

# Giles' float32 erf_inv (xla/hlo/builder/lib/math.cc ErfInv32)
_ERFINV_LT5 = tuple(np.float32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(np.float32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682))
_SQRT2 = np.float32(np.sqrt(2.0))


def _log1p_small(x: np.ndarray) -> np.ndarray:
    """log1p for |x| < sqrt(2) - 1: the rational function."""
    num = np.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(x, num, c)
    den = np.ones_like(x)
    for c in _LOG1P_DEN:
        den = _fma(x, den, c)
    x2 = x * x
    return x + _fma(np.float32(-0.5), x2, (x * x2) * (num / den))


def _log1p_large(x: np.ndarray) -> np.ndarray:
    """log1p for the rest: logf(1 + x), 1 + x = m * 2^(e+1) with m in
    [0.5, 1)."""
    f32 = np.float32
    y = np.maximum(x + f32(1.0), np.finfo(np.float32).tiny)
    yb = y.view(_U32)
    e1 = ((yb >> _U32(23)).astype(np.int32) - 127).astype(np.float32) \
        + f32(1.0)
    m = ((yb & _U32(0x7FFFFF)) | _U32(0x3F000000)).view(np.float32)
    low = m < _SQRT_HALF
    r = (m - f32(1.0)) + np.where(low, m, f32(0.0))
    e1 = np.where(low, e1 - f32(1.0), e1)
    z2 = r * r
    z3 = z2 * r
    qa = _fma(_fma(r, _LOGF_A[0], _LOGF_A[1]), r, _LOGF_A[2])
    qb = _fma(_fma(r, _LOGF_B[0], _LOGF_B[1]), r, _LOGF_B[2])
    qc = _fma(_fma(r, _LOGF_C[0], _LOGF_C[1]), r, _LOGF_C[2])
    t = _fma(z3, _fma(z3, _fma(z3, qa, qb), qc), e1 * _LN2_LO)
    return _fma(e1, _LN2_HI, t + _fma(f32(-0.5), z2, r))


def _by_mask(mask: np.ndarray, x: np.ndarray, if_true, if_false,
             ) -> np.ndarray:
    """``where(mask, if_true(x), if_false(x))``, each branch computed on its
    own elements only."""
    out = np.empty_like(x)
    out[mask] = if_true(x[mask])
    out[~mask] = if_false(x[~mask])
    return out


def _erf_inv_poly(w: np.ndarray, coef: Sequence[np.float32]) -> np.ndarray:
    p = _fma(w, coef[0], coef[1])
    for c in coef[2:]:
        p = _fma(w, p, c)
    return p


def erf_inv(u: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on [-1, 1], as its CPU code computes it."""
    u = np.asarray(u, np.float32)
    x = u * -u
    lp = _by_mask(np.abs(x) < _LOG1P_SMALL, x, _log1p_small,
                  _log1p_large)  # log1p(-u^2) = -w
    with np.errstate(invalid="ignore", divide="ignore"):
        p = _by_mask(
            lp > np.float32(-5.0), lp,
            lambda v: _erf_inv_poly(np.float32(-2.5) - v, _ERFINV_LT5),
            lambda v: _erf_inv_poly(np.sqrt(-v) - np.float32(3.0),
                                    _ERFINV_GE5))
    p = np.where(np.abs(u) == np.float32(1.0), np.float32(np.inf), p)
    return u * p


_CHUNK = 1 << 16  # draws a pass; keeps the temporaries in cache


def normal(key: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(u)``, u uniform on [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    n = _size(shape)
    out = np.empty(n, np.float32)
    for start in range(0, n, _CHUNK):
        stop = min(n, start + _CHUNK)
        out[start:stop] = erf_inv(_uniform_at(key, start, stop, lo, 1.0)) \
            * _SQRT2
    return out.reshape(tuple(shape))
