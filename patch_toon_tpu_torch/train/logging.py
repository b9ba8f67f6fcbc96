"""TensorBoard scalar and image logging (counterpart of
patch_toon_tpu/train/logging.py).

The same scalar series as the reference (lightning_model.py:315-319:
d_real_loss, d_fake_loss, d_total_loss, g_image_loss, g_perception_loss,
g_adversarial_loss, g_total_loss) plus ``lr-Adam``, the epoch mean and
patches/s, and the ``training/comparison_grid`` image: per sample one row
of Input | Generated | Target | <each guide channel>, built on the host
with numpy exactly as the JAX package builds it. ``tensorboardX`` is
imported when the logger is made; without it the logger degrades to the
console, as the JAX logger does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


def _to01(x: np.ndarray) -> np.ndarray:
    """[-1,1] -> [0,1] with clamp (lightning_model.py:390-393)."""
    return (np.clip(x, -1.0, 1.0) + 1.0) / 2.0


def build_comparison_grid(
    pre: np.ndarray,           # (B,H,W,3) in [-1,1]
    generated: np.ndarray,     # (B,H,W,3)
    target: np.ndarray,        # (B,H,W,3)
    channels: Optional[np.ndarray] = None,   # (B,H,W,C_extra)
    channel_depths: Optional[List[int]] = None,
    max_images: int = 8,
    padding: int = 2,
) -> np.ndarray:
    """HWC float grid in [0,1], rows = samples, cols = views.

    Channel views with depth 1 are replicated to gray-RGB, depth 3 shown
    as-is, other depths averaged (lightning_model.py:400-420).
    """
    n = min(max_images, pre.shape[0])
    views: List[np.ndarray] = [_to01(pre[:n]), _to01(generated[:n]),
                               _to01(target[:n])]
    if channels is not None and channel_depths:
        start = 0
        for depth in channel_depths:
            chunk = channels[:n, :, :, start:start + depth]
            if depth == 1:
                chunk = np.repeat(chunk, 3, axis=-1)
            elif depth != 3:
                chunk = np.repeat(chunk.mean(axis=-1, keepdims=True), 3,
                                  axis=-1)
            views.append(_to01(chunk))
            start += depth
    rows = []
    for i in range(n):
        row = np.concatenate(
            [np.pad(v[i], ((padding,) * 2, (padding,) * 2, (0, 0)),
                    constant_values=1.0) for v in views],
            axis=1,
        )
        rows.append(row)
    return np.concatenate(rows, axis=0)


class MetricsLogger:
    """Thin tensorboardX wrapper; console-only when it is absent."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if not log_dir:
            return
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(log_dir)
        except Exception as e:
            print(f"TensorBoard logging unavailable ({e}); console only")

    def log_scalars(self, metrics: Dict[str, Any], step: int) -> None:
        if self.writer is None:
            return
        for name, value in metrics.items():
            self.writer.add_scalar(name, float(value), step)

    def log_image(self, tag: str, image_hwc01: np.ndarray, step: int) -> None:
        if self.writer is None:
            return
        self.writer.add_image(tag, image_hwc01, step, dataformats="HWC")

    def log_text(self, tag: str, text: str, step: int) -> None:
        if self.writer is None:
            return
        self.writer.add_text(tag, text, step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
