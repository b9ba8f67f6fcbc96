"""The train state: both networks, the frozen VGG prefix, the optimizers
and the step count (counterpart of patch_toon_tpu/train/state.py).

JAX keeps one immutable pytree; here the modules hold the parameters and
the generator's BatchNorm statistics, the step updates them in place and
bumps ``step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from torch import nn

from patch_toon_tpu_torch.train.optim import Adam


@dataclass
class GANTrainState:
    step: int
    generator: nn.Module
    g_opt: Adam
    discriminator: Optional[nn.Module] = None  # None without a discriminator
    d_opt: Optional[Adam] = None
    perception: Optional[nn.Module] = None     # frozen, never updated
