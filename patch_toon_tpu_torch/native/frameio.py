"""ctypes bindings of the port's native image library.

Counterpart of ``patch_toon_tpu/native/frameio.py``, grown into the image
IO that the JAX package takes from Pillow: ``frameio.cpp`` (PNG, the
threaded loader and writer, the C interface), ``jpeg.cpp`` (baseline JPEG,
decoded and encoded as Pillow does on libjpeg-turbo), ``resample.cpp``
(Pillow's LANCZOS resize) and ``zstd.cpp`` (zstd frames and CRC-32C, the
codecs of Orbax checkpoints; bound in ``native/zstd.py``). The sources are
compiled at first use by one
``g++ -O2 -shared -fPIC -std=c++17 -ffp-contract=off ... -lz -lpthread``
call into ``patch_toon_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of every source and the flags, as the CUDA kernels are
(``_build.py``). ``-ffp-contract=off`` keeps the resize's double weights
the IEEE operations Pillow's C code does (a fused multiply-add would round
some weights otherwise). A build that fails raises with the compiler's
message: image IO never moves to PIL in silence.

A file is decoded by its signature, not its name: a JPEG named ``.png`` is
read as a JPEG. PIL is imported only for one file at a time, when the codec
refuses that file by its format (:class:`Refused`: palette, 16-bit or
interlaced PNG; progressive, arithmetic, lossless, 12-bit, CMYK or Adobe
JPEG; neither signature). Without PIL that file raises an ImportError that
names its format. A damaged PNG or JPEG raises. :func:`decode_counts`
counts the native decodes by format and the PIL decodes, as the kernels
count their launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
SOURCES = tuple(NATIVE_DIR / n for n in ("frameio.cpp", "jpeg.cpp",
                                         "resample.cpp", "zstd.cpp"))
HEADERS = (NATIVE_DIR / "codec.h",)
BUILD_DIR = NATIVE_DIR.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
LINK_FLAGS = ("-lz", "-lpthread")
BUILD_TIMEOUT_S = 300

# codes of codec.h for a file the codec refuses by its format
REFUSED = {-3: "a PNG that is palette, 16-bit or interlaced",
           -6: "neither a PNG nor a JPEG",
           -10: "a progressive JPEG",
           -11: "an arithmetic-coded JPEG",
           -12: "a JPEG whose samples are not 8-bit",
           -13: "a lossless or hierarchical JPEG",
           -14: "a JPEG that is not gray or YCbCr (CMYK, YCCK, RGB or "
                "Adobe)",
           -15: "a JPEG whose chroma sampling is not 4:4:4, 4:2:2, 4:4:0 "
                "or 4:2:0"}
ERRORS = {-1: "cannot be read", -2: "is a malformed or damaged PNG or JPEG",
          -4: "has damaged or short compressed data",
          -5: "has a row filter outside 0-4",
          -7: "could not be written",
          -8: "is not a size or channel count the entry takes",
          -9: "failed inside the codec (out of memory?)"}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32 = ctypes.c_uint32
_U32P = ctypes.POINTER(_U32)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_pil_decodes = 0
_pil_lock = threading.Lock()


class Refused(Exception):
    """A file the codec does not take by its format; PIL reads it."""

    def __init__(self, path: str, code: int):
        self.path, self.code, self.kind = path, code, REFUSED[code]
        super().__init__(f"{path} is {self.kind}")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"frameio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the hashed library unless it exists. g++
    writes a temporary name that ``os.replace`` moves into place, so a
    build that is killed leaves no half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp),
           *LINK_FLAGS]
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
            out = [ctypes.POINTER(_U8P), _U32P, _U32P, _U32P]
            for name, argtypes, restype in (
                    ("frameio_decode", [ctypes.c_char_p, *out], ctypes.c_int),
                    ("frameio_probe", [ctypes.c_char_p, _U32P, _U32P, _U32P],
                     ctypes.c_int),
                    ("frameio_encode", [ctypes.c_char_p, _U8P, _U32, _U32,
                                        _U32, ctypes.c_int], ctypes.c_int),
                    ("frameio_encode_jpeg", [ctypes.c_char_p, _U8P, _U32,
                                             _U32, ctypes.c_int,
                                             ctypes.c_char_p, _U32],
                     ctypes.c_int),
                    ("frameio_resize", [_U8P, _U32, _U32, _U32, _U8P, _U32,
                                        _U32], ctypes.c_int),
                    ("frameio_decode_counts", [_U64P, _U64P], None),
                    ("frameio_zero_decode_counts", [], None),
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
                    ("frameio_writer_destroy", [ctypes.c_void_p], None),
                    ("zstd_decompress", [ctypes.c_char_p, ctypes.c_uint64,
                                         ctypes.c_void_p, ctypes.c_uint64,
                                         _U64P], ctypes.c_int),
                    ("zstd_decompress_alloc", [
                        ctypes.c_char_p, ctypes.c_uint64,
                        ctypes.POINTER(_U8P), _U64P], ctypes.c_int),
                    ("crc32c", [ctypes.c_char_p, ctypes.c_uint64, _U32],
                     _U32)):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _error(path: str, rc: int) -> Exception:
    if rc in REFUSED:
        return Refused(path, rc)
    return ValueError(f"{path} {ERRORS.get(rc, f'failed with code {rc}')}")


def decode_counts() -> Dict[str, int]:
    """Decodes since the last :func:`zero_decode_counts`: native PNG and
    JPEG (any thread, the C++ loader's included) and PIL."""
    png, jpeg = ctypes.c_uint64(), ctypes.c_uint64()
    library().frameio_decode_counts(ctypes.byref(png), ctypes.byref(jpeg))
    return {"png": png.value, "jpeg": jpeg.value, "pil": _pil_decodes}


def zero_decode_counts() -> None:
    global _pil_decodes
    library().frameio_zero_decode_counts()
    with _pil_lock:
        _pil_decodes = 0


def pil_open(refused: Refused):
    """PIL's image of a file the codec refused (counted as a PIL decode);
    an ImportError naming the file's format when PIL cannot be imported."""
    global _pil_decodes
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{refused}, which the port's codec does not take, "
                          f"and PIL cannot be imported") from e
    with _pil_lock:
        _pil_decodes += 1
    return Image.open(refused.path)


def _pil_decode(refused: Refused) -> np.ndarray:
    """(H, W, C) uint8 through PIL: L, LA, RGB and RGBA as they are, any
    other mode converted to RGB (as the JAX package does)."""
    with pil_open(refused) as img:
        if img.mode not in ("L", "LA", "RGB", "RGBA"):
            img = img.convert("RGB")
        arr = np.asarray(img)
    return arr if arr.ndim == 3 else arr[..., None]


def _take(lib, rc: int, pixels, w, h, c, path: str) -> np.ndarray:
    """The decoded frame of a call that returned ``rc``: the codec's
    buffer, or :class:`Refused` / an error naming the file."""
    if rc != 0:
        raise _error(path, rc)
    n = h.value * w.value * c.value
    try:
        return np.ctypeslib.as_array(pixels, shape=(n,)).reshape(
            h.value, w.value, c.value).copy()
    finally:
        lib.frameio_free(pixels)


def _out_args():
    return _U8P(), _U32(), _U32(), _U32()


def decode_native(path) -> np.ndarray:
    """uint8 (H, W, C) of a PNG or JPEG the codec reads, by its signature:
    C = 1 (L), 2 (LA), 3 (RGB) or 4 (RGBA). Raises :class:`Refused` for a
    file it does not take by its format, ValueError for a damaged file or
    one that cannot be read."""
    p = str(path)
    lib = library()
    pixels, w, h, c = _out_args()
    rc = lib.frameio_decode(p.encode(), ctypes.byref(pixels), ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(c))
    return _take(lib, rc, pixels, w, h, c, p)


def decode_png(path) -> np.ndarray:
    """Decode an image file to uint8 (H, W, C), C in 1-4: through the
    codec, or through PIL for a file the codec refuses by its format."""
    try:
        return decode_native(path)
    except Refused as r:
        return _pil_decode(r)


def probe(path) -> Tuple[int, int, int]:
    """(width, height, channels) of a PNG or JPEG from its header, without
    decoding it (any kind of JPEG, refused ones included). Raises
    :class:`Refused` for a file of neither signature, ValueError for a
    header that does not parse."""
    p = str(path)
    w, h, c = _U32(), _U32(), _U32()
    rc = library().frameio_probe(p.encode(), ctypes.byref(w), ctypes.byref(h),
                                 ctypes.byref(c))
    if rc != 0:
        raise _error(p, rc)
    return w.value, h.value, c.value


def _as_hwc(array: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(array, dtype=np.uint8)
    return arr[..., None] if arr.ndim == 2 else arr


def _native_png(path: str) -> bool:
    return path.lower().endswith(".png")


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


def encode_jpeg(path, rgb: np.ndarray, quality: int = 95,
                comment: Optional[bytes] = None) -> None:
    """Write uint8 (H, W, 3) RGB as a baseline 4:2:0 JPEG at ``quality``,
    the bytes Pillow's ``save(path, format="JPEG", quality=quality)``
    writes, whatever the file's name; a non-empty ``comment`` goes in a COM
    segment after APP0, as Pillow's save writes ``info["comment"]`` (see
    :func:`read_comment`). Raises OSError when the write fails."""
    p, arr = str(path), np.ascontiguousarray(rgb, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"encode_jpeg: {arr.shape} is not (H, W, 3)")
    com = bytes(comment or b"")
    rc = library().frameio_encode_jpeg(p.encode(), arr.ctypes.data_as(_U8P),
                                       arr.shape[1], arr.shape[0],
                                       int(quality), com, len(com))
    if rc != 0:
        raise OSError(f"{p} {ERRORS.get(rc, f'failed with code {rc}')}")


def read_comment(path) -> Optional[bytes]:
    """The comment Pillow's ``Image.open(path).info["comment"]`` holds
    once the image is loaded, as the bytes its JPEG ``save`` writes: a
    JPEG's last COM segment before its scan, as it is; a PNG's last
    ``tEXt``, ``zTXt`` or ``iTXt`` chunk keyed ``comment`` before IEND,
    decoded (Latin-1, or UTF-8 for iTXt) and written as UTF-8. None without
    one. Only segment and chunk headers and text chunks are read: the
    pixel data is skipped."""
    found: Optional[bytes] = None
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            while True:
                seg = f.read(4)
                if len(seg) < 4 or seg[0] != 0xFF:
                    break
                marker = seg[1]
                if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                    f.seek(-2, 1)
                    continue
                n = int.from_bytes(seg[2:], "big")
                if marker in (0xDA, 0xD9) or n < 2:
                    break  # SOS, EOI: no header past here
                if marker == 0xFE:
                    found = f.read(n - 2)
                else:
                    f.seek(n - 2, 1)
            return found
        if head != b"\x89PNG\r\n\x1a\n":
            return None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8 or chunk[4:] == b"IEND":
                break
            n, kind = int.from_bytes(chunk[:4], "big"), chunk[4:]
            if kind not in (b"tEXt", b"zTXt", b"iTXt"):
                f.seek(n + 4, 1)  # the body and its CRC
                continue
            body = f.read(n)
            f.seek(4, 1)
            if b"\0" not in body:
                continue
            key, rest = body.split(b"\0", 1)
            if key != b"comment":
                continue
            try:
                if kind == b"tEXt":
                    text = rest.decode("latin-1")
                elif kind == b"zTXt":
                    text = zlib.decompress(rest[1:]).decode("latin-1")
                else:
                    flag, _method = rest[0], rest[1]
                    _lang, _tkey, value = rest[2:].split(b"\0", 2)
                    text = (zlib.decompress(value) if flag else value
                            ).decode("utf-8")
            except (ValueError, IndexError, zlib.error):
                continue  # Pillow skips a chunk it cannot decode
            found = text.encode("utf-8")
    return found


def resize_lanczos(array: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W) or (H, W, 1 or 3) resized to (height, width) as
    Pillow's ``resize((width, height), Image.Resampling.LANCZOS)`` of an L
    or RGB image, in C++ (plain version: ``data/resample.py``)."""
    arr = np.ascontiguousarray(array, dtype=np.uint8)
    hwc = _as_hwc(arr)
    if hwc.ndim != 3 or hwc.shape[-1] not in (1, 3):
        raise ValueError(f"resize_lanczos: {arr.shape} is not (H, W[, 1|3])")
    out = np.empty((height, width) + arr.shape[2:], np.uint8)
    rc = library().frameio_resize(hwc.ctypes.data_as(_U8P), hwc.shape[1],
                                  hwc.shape[0], hwc.shape[-1],
                                  out.ctypes.data_as(_U8P), width, height)
    if rc != 0:
        raise ValueError(f"resize_lanczos {arr.shape} -> ({height}, {width}) "
                         f"{ERRORS.get(rc, f'failed with code {rc}')}")
    return out


class FrameLoader:
    """In-order threaded decoder over a list of paths: ``get(i)`` blocks
    until frame ``i`` is decoded (PNG or JPEG, in C++ threads); at most
    ``window`` frames past the last one taken are decoded ahead. A frame
    the codec refuses by its format is read by PIL in ``get``."""

    def __init__(self, paths: Sequence, num_threads: int = 4,
                 window: int = 8):
        self.paths: List[str] = [str(p) for p in paths]
        self._handle = None
        self._lib = library()
        if self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.frameio_loader_create(
                arr, len(self.paths), num_threads, window)
            if not self._handle:
                raise MemoryError("frameio_loader_create failed")

    def get(self, index: int) -> np.ndarray:
        if self._handle is None:
            raise IndexError(f"frame {index} of an empty FrameLoader")
        pixels, w, h, c = _out_args()
        rc = self._lib.frameio_loader_get(
            self._handle, index, ctypes.byref(pixels), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(c))
        try:
            return _take(self._lib, rc, pixels, w, h, c, self.paths[index])
        except Refused as r:
            return _pil_decode(r)

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
