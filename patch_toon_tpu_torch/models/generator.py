"""GeneratorJ in PyTorch (counterpart of patch_toon_tpu/models/generator.py).

7x7 conv stem, two stride-2 downsamples, N residual blocks, two
bilinear-upsample + conv blocks with skip concats, a 7x7 conv over
(decoded, stem, raw input), optional conv/BN smoothers, and a 1x1 head with
tanh (reference src/models/generator.py:60-238). All 19 InstanceNorm sites
go through ``ops.instance_norm.instance_norm_act``.

Module names are the reference's (table in
``patch_toon_tpu/utils/torch_compat.py:13-30``), so a reference state dict
loads with ``strict=True``. Parameterless layers (InstanceNorm without
affine, ReLU, the upsample) hold their index as ``nn.Identity`` or
``nn.ReLU``; ``forward`` calls the layers by index.

The public interface is NHWC like the JAX module: ``forward`` takes
(N, H, W, C) in [-1, 1] and returns (N, H, W, 3), in the input's type (the
convs cast their fp32 weights to it). ``train()`` mode is the JAX module's
``train=True``: the smoother BatchNorm normalizes with fp32 batch
statistics and advances its running statistics once
(``layers.batch_norm_train_fp32``).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from patch_toon_tpu_torch.models.layers import (
    batch_norm_eval_fp32,
    batch_norm_train_fp32,
    conv,
    norm_act,
    upsample2x,
)


class ResNetBlock(nn.Module):
    """x + (ReLU -> Conv3x3 -> IN -> ReLU -> Conv3x3 -> IN)(x)
    (reference src/models/generator.py:18-58)."""

    def __init__(self, channels: int, use_bias: bool):
        super().__init__()
        self.block = nn.Sequential(
            nn.ReLU(), conv(channels, channels, 3, 1, 1, use_bias),
            nn.Identity(), nn.ReLU(),
            conv(channels, channels, 3, 1, 1, use_bias), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block[1](F.relu(x))
        y = norm_act(y, "relu")  # IN, then the block's second ReLU
        y = norm_act(self.block[4](y), None)
        return x + y


class GeneratorJ(nn.Module):
    def __init__(self, input_channels: int = 3,
                 filters: Sequence[int] = (32, 64, 128, 128, 128, 64),
                 norm_layer: str = "instance_norm", use_bias: bool = False,
                 resnet_blocks: int = 7, tanh: bool = True,
                 append_smoothers: bool = True, **unused: Any):
        """Arguments as the reference constructor; ``additional_channels``
        and ``input_size`` are accepted and unused, as there."""
        super().__init__()
        if norm_layer != "instance_norm":
            raise NotImplementedError(
                f"norm_layer={norm_layer!r} is not ported yet")
        f = list(filters)
        c = int(input_channels)
        self.tanh = bool(tanh)
        self.initial_conv = nn.Sequential(conv(c, f[0], 7, 1, 3, use_bias))
        self.downsample1 = nn.Sequential(conv(f[0], f[1], 3, 2, 1, use_bias))
        self.downsample2 = nn.Sequential(conv(f[1], f[2], 3, 2, 1, use_bias))
        self.resnet_blocks = nn.Sequential(
            *[ResNetBlock(f[2], use_bias) for _ in range(resnet_blocks)])
        self.upsample2 = nn.Sequential(
            nn.Identity(), conv(2 * f[2], f[4], 3, 1, 1, use_bias))
        self.upsample1 = nn.Sequential(
            nn.Identity(), conv(f[4] + f[1], f[4], 3, 1, 1, use_bias))
        self.conv11 = nn.Sequential(
            conv(f[4] + f[0] + c, f[5], 7, 1, 3, use_bias))
        self.smoothers = nn.Sequential(
            conv(f[5], f[5], 3, 1, 1, use_bias), nn.ReLU(),
            nn.BatchNorm2d(f[5]),
            conv(f[5], f[5], 3, 1, 1, use_bias), nn.ReLU(),
        ) if append_smoothers else None
        self.output = nn.Sequential(conv(f[5], 3, 1, 1, 0, True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        conv0 = norm_act(self.initial_conv[0](x), "leaky_relu")
        conv1 = norm_act(self.downsample1[0](conv0), "leaky_relu")
        conv2 = norm_act(self.downsample2[0](conv1), "leaky_relu")
        out = self.resnet_blocks(conv2)
        out = norm_act(self.upsample2[1](upsample2x(
            torch.cat([out, conv2], dim=1))), "relu")
        out = norm_act(self.upsample1[1](upsample2x(
            torch.cat([out, conv1], dim=1))), "relu")
        out = F.relu(self.conv11[0](torch.cat([out, conv0, x], dim=1)))
        if self.smoothers is not None:
            out = F.relu(self.smoothers[0](out))
            bn = self.smoothers[2]
            out = batch_norm_train_fp32(out, bn) if self.training \
                else batch_norm_eval_fp32(out, bn)
            out = F.relu(self.smoothers[3](out))
        out = self.output[0](out)
        if self.tanh:
            out = torch.tanh(out)
        return out.permute(0, 2, 3, 1)


def input_channels_of(state_dict) -> int:
    """Channel sniff from the stem's weight (reference generator.py:118-119)."""
    return int(state_dict["initial_conv.0.weight"].shape[1])
