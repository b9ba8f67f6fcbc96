"""The VGG19 prefix of the perceptual loss in PyTorch (counterpart of
patch_toon_tpu/models/perception.py:58-123).

The network walks torchvision's ``vgg19.features`` index sequence up to
``max(feature_layers)`` and returns the NHWC maps at those indices (for the
default ``[0, 3, 5]``: conv1_1 before its ReLU, relu1_2, conv2_1 before its
ReLU: three 3x3 convs and a 2x2 max-pool). ``perceptual_mse`` reduces the
maps directly as sum of squared errors over count in fp32, which equals the
reference's MSE over the flattened concatenation (lightning_model.py:
271-275); ``flatten_features`` builds that concatenation, for tests.

Weights: an ``.npz`` in the ``tools/convert_vgg.py`` layout
(``features.<i>.weight`` OIHW, ``features.<i>.bias``). With no path, the
JAX package's documented deterministic fallback (``init_vgg_params`` with
seed 42; ``tools/export_vgg_fallback.py`` wrote it once) from
:data:`FALLBACK_NPZ`, committed beside this module: it holds features 0, 2
and 5, so it serves any ``feature_layers`` up to index 5.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from patch_toon_tpu_torch.models.layers import Conv2d

FALLBACK_NPZ = Path(__file__).resolve().parent / "vgg19_fallback_seed42.npz"
FALLBACK_MAX_INDEX = 5

# torchvision VGG19 'E' configuration: conv widths with 'M' maxpools
VGG19_CFG: Tuple[Any, ...] = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
    512, 512, 512, 512, "M", 512, 512, 512, 512, "M",
)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg19_layer_plan(max_index: int) -> List[Tuple[str, int]]:
    """[(op, width)] for features indices 0..max_index: 'conv', 'relu' or
    'pool' (JAX perception.py:38-55)."""
    plan: List[Tuple[str, int]] = []
    for width in VGG19_CFG:
        if width == "M":
            plan.append(("pool", 0))
        else:
            plan.append(("conv", int(width)))
            plan.append(("relu", 0))
        if len(plan) > max_index:
            break
    return plan[: max_index + 1]


def load_vgg_state(path: Optional[str],
                   max_index: int) -> Dict[str, torch.Tensor]:
    """``features.<i>.weight/bias`` of every conv up to ``max_index`` from
    an ``.npz`` (copies), or from the fallback when ``path`` is None."""
    if path is None:
        if max_index > FALLBACK_MAX_INDEX:
            raise NotImplementedError(
                f"perception feature layers up to {max_index}: the committed "
                f"fallback holds layers up to {FALLBACK_MAX_INDEX}; give "
                "perception_model.args.path (tools/convert_vgg.py)")
        path = str(FALLBACK_NPZ)
    out = {}
    with np.load(path) as arrays:
        for idx, (op, _) in enumerate(vgg19_layer_plan(max_index)):
            if op == "conv":
                for kind in ("weight", "bias"):
                    key = f"features.{idx}.{kind}"
                    out[key] = torch.from_numpy(
                        np.array(arrays[key], np.float32, copy=True))
    return out


class PerceptualVGG19(nn.Module):
    """VGG19 prefix feature extractor (NHWC input in [-1, 1]); frozen."""

    def __init__(self, feature_layers: Sequence[int] = (0, 3, 5),
                 use_normalization: bool = True,
                 path: Optional[str] = None, **unused: Any):
        super().__init__()
        self.feature_layers = tuple(sorted(int(i) for i in feature_layers))
        self.use_normalization = bool(use_normalization)
        layers: List[nn.Module] = []
        cin = 3
        for op, width in vgg19_layer_plan(max(self.feature_layers)):
            if op == "conv":
                layers.append(Conv2d(cin, width, 3, 1, 1))
                cin = width
            elif op == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.features.load_state_dict(
            {k[len("features."):]: v for k, v in load_vgg_state(
                path, max(self.feature_layers)).items()}, strict=True)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (N, H, W, 3) -> the NHWC maps at ``feature_layers``, in x's
        type."""
        if self.use_normalization:
            mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
            std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
            x = ((x + 1.0) / 2.0 - mean) / std
        cur = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feats = []
        for idx, layer in enumerate(self.features):
            cur = F.relu(cur) if isinstance(layer, nn.ReLU) else layer(cur)
            if idx in self.feature_layers:
                feats.append(cur.permute(0, 2, 3, 1))
        return tuple(feats)


def flatten_features(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """The reference's layout: each map flattened NCHW, concatenated."""
    n = feats[0].shape[0]
    return torch.cat([f.permute(0, 3, 1, 2).reshape(n, -1) for f in feats],
                     dim=1)


def perceptual_mse(feats_a: Sequence[torch.Tensor],
                   feats_b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean squared error over all feature elements: sum of the squared
    errors over the total count, in fp32 (JAX perception.py:107-121)."""
    sse = torch.zeros((), dtype=torch.float32, device=feats_a[0].device)
    count = 0
    for a, b in zip(feats_a, feats_b):
        sse = sse + torch.sum(torch.square(a.float() - b.float()))
        count += a.numel()
    return sse / count
