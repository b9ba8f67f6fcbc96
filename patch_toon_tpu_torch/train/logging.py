"""TensorBoard scalar logging (counterpart of
patch_toon_tpu/train/logging.py::MetricsLogger).

The same scalar series as the reference (lightning_model.py:315-319:
d_real_loss, d_fake_loss, d_total_loss, g_image_loss, g_perception_loss,
g_adversarial_loss, g_total_loss) plus ``lr-Adam``, the epoch mean and
patches/s. ``tensorboardX`` is imported when the logger is made; without
it the logger degrades to the console, as the JAX logger does. The
``training/comparison_grid`` images of the JAX loop are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class MetricsLogger:
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

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
