"""Image transform callables, for code written against the reference's
``src/data/transforms.py``.

Counterpart of ``patch_toon_tpu/data/transforms.py``: ``RGBConvert`` and
``GrayscaleConvert`` coerce as PIL's ``convert("RGB")`` and ``convert("L")``
(``data/io.py::to_rgb`` and ``to_luma``, bit for bit), ``ToTensor`` gives
float32 channel-last values in [0, 1], ``Normalize`` (x - mean) / std, and
``Compose`` chains them, as the JAX callables do. They take uint8 arrays
(H, W) or (H, W, C) with C in 1-4, CPU tensors of the same, or PIL images;
PIL is imported only to convert a PIL image. The port's own pipelines go
through ``data/io.py`` directly.
"""

from __future__ import annotations

import numpy as np
import torch

from patch_toon_tpu_torch.data.io import to_luma, to_rgb


def _hwc(img) -> np.ndarray:
    """uint8 (H, W, C) of an array, a tensor or a PIL image."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    return arr[..., None] if arr.ndim == 2 else arr


def _is_pil(img) -> bool:
    return type(img).__module__.startswith("PIL.")


class RGBConvert:
    """Coerce to (H, W, 3) uint8 RGB (reference transforms.py:6-11)."""

    def __call__(self, img) -> np.ndarray:
        if _is_pil(img):
            return np.asarray(img.convert("RGB"))
        return to_rgb(_hwc(img))


class GrayscaleConvert:
    """Coerce to (H, W) uint8 luma (reference transforms.py:13-17)."""

    def __call__(self, img) -> np.ndarray:
        if _is_pil(img):
            return np.asarray(img.convert("L"))
        return to_luma(_hwc(img))


class ToTensor:
    """uint8 -> float32 HWC array in [0, 1] (channel-last)."""

    def __call__(self, img) -> np.ndarray:
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return arr if arr.ndim == 3 else arr[..., None]


class Normalize:
    """(x - mean) / std, channel-last."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (arr - self.mean) / self.std


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x
