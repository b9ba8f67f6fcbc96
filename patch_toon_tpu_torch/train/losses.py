"""Loss criteria by their torch class names (counterpart of
patch_toon_tpu/train/losses.py): the reference instantiates criteria by
name from the config (lightning_model.py:48-54). Every reduction is a mean
in fp32.
"""

from __future__ import annotations

from typing import Callable

import torch

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred.float() - target.float())
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def bce_with_logits_loss(pred: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    p, t = pred.float(), target.float()
    return torch.mean(torch.clamp_min(p, 0) - p * t
                      + torch.log1p(torch.exp(-torch.abs(p))))


CRITERIA = {
    "L1Loss": l1_loss,
    "MSELoss": mse_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "BCEWithLogitsLoss": bce_with_logits_loss,
}


def get_criterion(name: str) -> LossFn:
    if name not in CRITERIA:
        raise ValueError(f"Unknown criterion {name!r}; known: "
                         f"{sorted(CRITERIA)}")
    return CRITERIA[name]
