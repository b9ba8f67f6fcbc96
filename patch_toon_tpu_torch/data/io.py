"""Image listing, decode and encode.

Counterpart of ``patch_toon_tpu/data/io.py`` with the same value semantics:
RGB decode as PIL's ``convert("RGB")``, masks as grayscale binarized at
> 128 (reference dataset.py:157). PNG goes through the port's own codec
(``native/frameio.py``), as the JAX package's does through its own
(``patch_toon_tpu/data/io.py:52-62``, ``:106-108``); the conversions to RGB
and to L are PIL's, bit for bit. PIL is imported only for a file the codec
refuses by its format (JPEG, palette, 16-bit, interlaced), so importing
this module, and reading or writing an 8-bit PNG, needs no PIL.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Union

import numpy as np

from patch_toon_tpu_torch.native.frameio import decode_png_native, encode_png

# byte / 255 * 2 - 1 for the 256 byte values in IEEE fp32, computed by
# numpy on the host: the JAX package's host arithmetic (its dataset,
# reference dataset.py:34-44 and :191). The port gathers from this table
# wherever a byte becomes [-1, 1], training data and serving alike, so every
# device gives these values. (The JAX inference program, jitted by XLA,
# multiplies by the reciprocal instead and differs from them by 1 ulp at
# 205 of the 256 bytes on the CPU; PyTorch's CUDA division by a scalar
# does the same at 111.)
SIGNED_UNIT = np.arange(256, dtype=np.float32) / np.float32(255.0) \
    * np.float32(2.0) - np.float32(1.0)

# multi-extension resolver order of reference dataset.py:102
_EXTENSIONS = [".png", ".jpg", ".jpeg", ".PNG", ".JPG", ".JPEG"]


def list_images(directory: Union[str, Path]) -> List[str]:
    """Sorted image file names in a directory (reference dataset.py:47-50)."""
    return sorted(f for f in os.listdir(directory)
                  if f.lower().endswith((".png", ".jpg", ".jpeg")))


def find_corresponding_image(base_dir: Union[str, Path],
                             image_name: str) -> str:
    """A file with the same stem under any supported extension, else the
    joined original name (reference dataset.py:85-111)."""
    base_name = os.path.splitext(os.path.basename(image_name))[0]
    for ext in _EXTENSIONS:
        candidate = os.path.join(str(base_dir), base_name + ext)
        if os.path.exists(candidate):
            return candidate
    return os.path.join(str(base_dir), image_name)


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 with C in 1-4 -> (H, W, 3) as PIL's
    ``convert("RGB")``: gray replicated, LA's L replicated, alpha
    dropped."""
    c = arr.shape[-1]
    if c == 3:
        return arr
    if c in (1, 2):
        return np.repeat(arr[..., :1], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def to_luma(arr: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 with C in 1-4 -> (H, W) as PIL's ``convert("L")``:
    gray as it is, LA's L, and from RGB(A) the ITU-R 601-2 luma in PIL's
    16-bit fixed point, (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    if arr.shape[-1] in (1, 2):
        return arr[..., 0]
    r, g, b = (arr[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _codec_or_pil(path: Union[str, Path], codec, pil):
    """``codec`` of the codec's decode of a PNG it reads; ``pil`` of the
    PIL image of any other file (the JAX package's per-file rule)."""
    if str(path).lower().endswith(".png"):
        arr = decode_png_native(path)
        if arr is not None:
            return codec(arr)
    from PIL import Image

    with Image.open(str(path)) as img:
        return pil(img)


def decode_rgb_uint8(path: Union[str, Path]) -> np.ndarray:
    """(H, W, 3) uint8 RGB; gray replicated, alpha dropped."""
    return _codec_or_pil(path, to_rgb,
                         lambda img: np.asarray(img.convert("RGB")))


def load_image_rgb(path: Union[str, Path]) -> np.ndarray:
    """(H, W, 3) float32 RGB in [-1, 1]: the decoded bytes through
    :data:`SIGNED_UNIT`, the reference transform (dataset.py:34-44)."""
    return SIGNED_UNIT[decode_rgb_uint8(path)]


def load_image_channels(path: Union[str, Path], depth: int) -> np.ndarray:
    """A guide-channel image as float32 in [-1, 1], the first ``depth``
    bands of its RGB conversion (reference dataset.py:191)."""
    return load_image_rgb(path)[..., :depth]


def image_bands(path: Union[str, Path]) -> int:
    """Number of bands an image file holds (L = 1, LA = 2, RGB = 3,
    RGBA = 4): the codec's channel count for a PNG it reads, PIL's bands
    for any other file."""
    return _codec_or_pil(path, lambda arr: arr.shape[-1],
                         lambda img: len(img.getbands()))


def load_luma(path: Union[str, Path]) -> np.ndarray:
    """(H, W) uint8 as PIL's ``convert("L")`` of the file."""
    return _codec_or_pil(path, to_luma,
                         lambda img: np.asarray(img.convert("L")))


def load_mask(path: Union[str, Path],
              binarize_threshold: int = 128) -> np.ndarray:
    """(H, W) float32 mask in {0, 1}: grayscale > threshold."""
    luma = load_luma(path)
    return (luma.astype(np.float32) > binarize_threshold).astype(np.float32)


def save_image_uint8(frame: np.ndarray, path: Union[str, Path]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    encode_png(path, frame)
