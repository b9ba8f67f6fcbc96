"""ctypes bindings of the port's native frame IO (``frameio.cpp``).

Counterpart of ``patch_toon_tpu/native/frameio.py``. The C++ source is
compiled at first use by one ``g++ -O2 -shared -fPIC -std=c++17 ... -lz
-lpthread`` call into ``patch_toon_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and flags as the CUDA
kernels are (``_build.py``). A build that fails raises with the compiler's
message: PNG IO never moves to PIL in silence.

PIL is imported only for one file at a time, when the codec refuses that
file by its format: not a PNG (a JPEG), or a PNG that is palette, 16-bit or
interlaced. This is the JAX package's per-file rule. A damaged PNG raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "frameio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lz", "-lpthread")
BUILD_TIMEOUT_S = 300

# codes of frameio.cpp
NOT_PNG, UNSUPPORTED = -6, -3
ERRORS = {-1: "cannot be read", -2: "is a malformed PNG",
          -3: "is a PNG format the codec does not take",
          -4: "has damaged or short compressed data",
          -5: "has a row filter outside 0-4", -6: "is not a PNG",
          -7: "could not be written", -8: "has a channel count outside 1-4",
          -9: "failed inside the codec (out of memory?)"}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32 = ctypes.c_uint32


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"frameio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile frameio.cpp into the hashed library unless it exists. g++
    writes a temporary name that ``os.replace`` moves into place, so a
    build that is killed leaves no half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed with code {proc.returncode}: {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def library() -> ctypes.CDLL:
    """The codec's library, built at first use and loaded once."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            out = [ctypes.POINTER(_U8P), ctypes.POINTER(_U32),
                   ctypes.POINTER(_U32), ctypes.POINTER(_U32)]
            for name, argtypes, restype in (
                    ("frameio_decode", [ctypes.c_char_p, *out], ctypes.c_int),
                    ("frameio_encode", [ctypes.c_char_p, _U8P, _U32, _U32,
                                        _U32, ctypes.c_int], ctypes.c_int),
                    ("frameio_free", [_U8P], None),
                    ("frameio_loader_create", [
                        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                        ctypes.c_int, ctypes.c_int], ctypes.c_void_p),
                    ("frameio_loader_get", [ctypes.c_void_p, ctypes.c_int,
                                            *out], ctypes.c_int),
                    ("frameio_loader_destroy", [ctypes.c_void_p], None),
                    ("frameio_writer_create", [ctypes.c_int, ctypes.c_int],
                     ctypes.c_void_p),
                    ("frameio_writer_submit", [
                        ctypes.c_void_p, ctypes.c_char_p, _U8P, _U32, _U32,
                        _U32], ctypes.c_int),
                    ("frameio_writer_flush", [ctypes.c_void_p], ctypes.c_int),
                    ("frameio_writer_destroy", [ctypes.c_void_p], None)):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _pil_decode(path: str) -> np.ndarray:
    """(H, W, C) uint8 through PIL: L, LA, RGB and RGBA as they are, any
    other mode converted to RGB (as the JAX package does)."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode not in ("L", "LA", "RGB", "RGBA"):
            img = img.convert("RGB")
        arr = np.asarray(img)
    return arr if arr.ndim == 3 else arr[..., None]


def _take(lib, rc: int, pixels, w, h, c, path: str) -> Optional[np.ndarray]:
    """The decoded frame of a call that returned ``rc``: the codec's
    buffer, None for a file the codec refuses by its format, or an error
    naming the file."""
    if rc == 0:
        n = h.value * w.value * c.value
        try:
            return np.ctypeslib.as_array(pixels, shape=(n,)).reshape(
                h.value, w.value, c.value).copy()
        finally:
            lib.frameio_free(pixels)
    if rc in (NOT_PNG, UNSUPPORTED):
        return None
    raise ValueError(f"{path} {ERRORS.get(rc, f'failed with code {rc}')}")


def _out_args():
    return _U8P(), _U32(), _U32(), _U32()


def _native_png(path: str) -> bool:
    return path.lower().endswith(".png")


def decode_png_native(path) -> Optional[np.ndarray]:
    """uint8 (H, W, C) of a PNG the codec reads, C = 1 (L), 2 (LA), 3 (RGB)
    or 4 (RGBA); None for a file it refuses by its format. Raises for a
    damaged PNG or a file that cannot be read."""
    p = str(path)
    lib = library()
    pixels, w, h, c = _out_args()
    rc = lib.frameio_decode(p.encode(), ctypes.byref(pixels), ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(c))
    return _take(lib, rc, pixels, w, h, c, p)


def decode_png(path) -> np.ndarray:
    """Decode an image file to uint8 (H, W, C), C in 1-4. A ``.png`` goes
    through the codec; a file the codec refuses by its format, or any other
    extension, through PIL."""
    p = str(path)
    arr = decode_png_native(p) if _native_png(p) else None
    return _pil_decode(p) if arr is None else arr


def _as_hwc(array: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(array, dtype=np.uint8)
    return arr[..., None] if arr.ndim == 2 else arr


def _pil_encode(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr).save(path)


def encode_png(path, array: np.ndarray, compress_level: int = 6) -> None:
    """Write uint8 (H, W[, C]) with C in 1-4 to a ``.png`` through the
    codec (filter None, zlib at ``compress_level``); any other extension
    through PIL. Raises OSError when the codec fails."""
    p, arr = str(path), _as_hwc(array)
    if not _native_png(p):
        _pil_encode(p, arr)
        return
    if arr.ndim != 3 or not 1 <= arr.shape[-1] <= 4:
        raise ValueError(f"encode_png: {arr.shape} is not (H, W[, 1-4])")
    rc = library().frameio_encode(p.encode(), arr.ctypes.data_as(_U8P),
                                  arr.shape[1], arr.shape[0], arr.shape[-1],
                                  compress_level)
    if rc != 0:
        raise OSError(f"{p} {ERRORS.get(rc, f'failed with code {rc}')}")


class FrameLoader:
    """In-order threaded decoder over a list of paths: ``get(i)`` blocks
    until frame ``i`` is decoded; at most ``window`` frames past the last
    one taken are decoded ahead. Paths that are not all ``.png`` are read
    one at a time by :func:`decode_png` instead."""

    def __init__(self, paths: Sequence, num_threads: int = 4,
                 window: int = 8):
        self.paths: List[str] = [str(p) for p in paths]
        self._handle = None
        self._lib = library()
        if self.paths and all(_native_png(p) for p in self.paths):
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.frameio_loader_create(
                arr, len(self.paths), num_threads, window)
            if not self._handle:
                raise MemoryError("frameio_loader_create failed")

    def get(self, index: int) -> np.ndarray:
        if self._handle is None:
            return decode_png(self.paths[index])
        pixels, w, h, c = _out_args()
        rc = self._lib.frameio_loader_get(
            self._handle, index, ctypes.byref(pixels), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(c))
        arr = _take(self._lib, rc, pixels, w, h, c, self.paths[index])
        return _pil_decode(self.paths[index]) if arr is None else arr

    def close(self) -> None:
        if self._handle is not None:
            self._lib.frameio_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class FrameWriter:
    """Asynchronous PNG writer: ``submit`` copies the frame and returns;
    ``num_threads`` C++ threads encode (zlib at ``compress_level``, speed
    over size for video) and write. ``flush`` waits for every queued write
    and returns the number that failed so far. A path that is not ``.png``
    is written at once through :func:`encode_png`."""

    def __init__(self, num_threads: int = 2, compress_level: int = 1):
        self._handle = None
        self._lib = library()
        self._handle = self._lib.frameio_writer_create(num_threads,
                                                       compress_level)
        if not self._handle:
            raise MemoryError("frameio_writer_create failed")

    def submit(self, path, array: np.ndarray) -> None:
        p, arr = str(path), _as_hwc(array)
        if self._handle is None:
            raise RuntimeError("FrameWriter is closed")
        if not _native_png(p):
            encode_png(p, arr)
            return
        if arr.ndim != 3 or not 1 <= arr.shape[-1] <= 4:
            raise ValueError(f"FrameWriter: {arr.shape} is not (H, W[, 1-4])")
        rc = self._lib.frameio_writer_submit(
            self._handle, p.encode(), arr.ctypes.data_as(_U8P), arr.shape[1],
            arr.shape[0], arr.shape[-1])
        if rc != 0:
            raise OSError(f"{p} {ERRORS.get(rc, f'failed with code {rc}')}")

    def flush(self) -> int:
        if self._handle is None:
            return 0
        return self._lib.frameio_writer_flush(self._handle)

    def close(self) -> None:
        """Write what is queued, then stop the threads."""
        if self._handle is not None:
            self._lib.frameio_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
