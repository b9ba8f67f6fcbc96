"""ctypes bindings of ``zstd.cpp``: zstd frames (RFC 8878) and CRC-32C.

The decoder is the port's own, built with the rest of the native library
(``native/frameio.py``); nothing here imports ``zstandard``, so the same
code decodes on every machine. :func:`decompress` takes every frame of its
input (skippable frames skipped) and raises :class:`ZstdError` naming what
is wrong: a dictionary, a reserved bit, a truncated or corrupt frame, a
content checksum that does not match.
"""

from __future__ import annotations

import ctypes
import numpy as np

from patch_toon_tpu_torch.native import frameio

ERRORS = {-20: "is truncated: the input ends inside a frame",
          -21: "is not a zstd frame (bad magic number)",
          -22: "sets a reserved bit or block type",
          -23: "names a dictionary, which the decoder does not take",
          -24: "is corrupt: a table, stream or sequence cannot be decoded",
          -25: "fails its XXH64 content checksum",
          -26: "decodes to more bytes than expected",
          -27: "has a window or block larger than the format allows",
          -28: "could not be decoded (out of memory)"}


class ZstdError(ValueError):
    """A zstd input the decoder refuses; ``code`` is zstd.cpp's."""

    def __init__(self, what: str, code: int):
        self.code = code
        super().__init__(
            f"{what} {ERRORS.get(code, f'failed with code {code}')}")


def _buf(data) -> bytes:
    return data if isinstance(data, bytes) else bytes(data)


def decompress_into(data, out: np.ndarray, what: str = "zstd input") -> int:
    """Decode every frame of ``data`` into the C-contiguous array ``out``
    (its bytes); returns the bytes written."""
    data = _buf(data)
    if not out.flags.c_contiguous:
        raise ValueError("decompress_into needs a C-contiguous array")
    written = ctypes.c_uint64()
    rc = frameio.library().zstd_decompress(
        data, len(data), out.ctypes.data, out.nbytes, ctypes.byref(written))
    if rc < 0:
        raise ZstdError(what, rc)
    return written.value


def decompress(data, what: str = "zstd input") -> bytes:
    """Every frame of ``data`` decoded, as bytes."""
    data = _buf(data)
    lib = frameio.library()
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    written = ctypes.c_uint64()
    rc = lib.zstd_decompress_alloc(data, len(data), ctypes.byref(ptr),
                                   ctypes.byref(written))
    if rc < 0:
        raise ZstdError(what, rc)
    try:
        return ctypes.string_at(ptr, written.value)
    finally:
        lib.frameio_free(ptr)


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    data = _buf(data)
    return frameio.library().crc32c(data, len(data), crc)
