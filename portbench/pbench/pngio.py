"""8-bit PNG reading and writing with the standard library's zlib and NumPy.

The benchmark writes its shots and reads the program's outputs through
this module alone, so it needs no imaging library. Writing filters every
row but the first Up; reading takes the five filter types of the PNG
specification, gray, gray with alpha, RGB and RGBA, not interlaced.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOUR = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1..4 -> PNG bytes, every row but the
    first filtered Up (the difference from the row above)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 2
    raw[0, 0] = 0
    raw[0, 1:] = rows[0]
    raw[1:, 1:] = rows[1:] - rows[:-1]  # uint8 arithmetic wraps mod 256
    head = struct.pack(">IIBBBBB", w, h, 8, _COLOUR[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", head)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: Union[str, Path], img: np.ndarray, level: int = 1) -> int:
    """Write ``img`` as a PNG file -> the bytes written."""
    data = encode_png(img, level)
    Path(path).write_bytes(data)
    return len(data)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a.astype(np.int16) + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 2:
        return row + prev
    out = row.copy()
    n = len(row)
    if kind == 1:  # Sub: a running sum of each byte lane, mod 256
        lanes = out[:n - n % bpp].reshape(-1, bpp)
        out[:n - n % bpp] = np.cumsum(lanes, axis=0, dtype=np.uint8
                                      ).reshape(-1)
        return out
    for i in range(n):  # Average and Paeth: left to right
        left = out[i - bpp] if i >= bpp else np.uint8(0)
        if kind == 3:
            out[i] = row[i] + np.uint8((int(left) + int(prev[i])) >> 1)
        elif kind == 4:
            upleft = prev[i - bpp] if i >= bpp else np.uint8(0)
            out[i] = row[i] + _paeth(np.uint8(left), prev[i:i + 1],
                                     np.uint8(upleft))[0]
        else:
            raise ValueError(f"PNG filter type {kind}")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C the file's channels."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if head is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = head
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"PNG depth {depth}, colour {colour}, interlace "
                         f"{interlace}: not read here")
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    kinds = raw[:, 0]
    rows = raw[:, 1:]
    if not kinds.any():
        return rows.reshape(h, w, c).copy()
    out = np.empty_like(rows)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(kinds[y]), rows[y], prev, c)
    return out.reshape(h, w, c)


def read_png(path: Union[str, Path]) -> np.ndarray:
    return decode_png(Path(path).read_bytes())
