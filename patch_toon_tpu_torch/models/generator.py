"""GeneratorJ in PyTorch (counterpart of patch_toon_tpu/models/generator.py).

7x7 conv stem, two stride-2 downsamples, N residual blocks, two
bilinear-upsample + conv blocks with skip concats, a 7x7 conv over
(decoded, stem, raw input), optional conv/BN smoothers, and a 1x1 head with
tanh (reference src/models/generator.py:60-238). All 19 InstanceNorm sites
go through ``ops.instance_norm.instance_norm_act``; ``norm_layer`` null or
"none" (any value but "instance_norm"; "batch_norm" is refused, as JAX's
``ConvBlock`` refuses it) builds no norm at any site, as in JAX, each site
then its activation alone (``layers.norm_act(..., norm=False)``), and each
residual block's second conv moves to ``block.3`` (the reference's
Sequential without its norms). Every conv but the 1x1
head is a ``layers.QuantConv2d`` (22 at 7 residual blocks): ``quant_mode``
None is the fp conv, "calib" and "int8" are JAX's w8a8 serving modes
(``GeneratorJ.clone(quant_mode=...)``; ``quant_layers`` names the sites).

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

Every conv goes through ``layers.site`` with its per-channel ops. With
``tp`` set (tensor parallelism, ``parallel/tp.py::shard_module_``) a
sharded conv computes this rank's output channels from the whole input,
B1, ReLU and the smoothers' BatchNorm run on them, and the whole tensor is
gathered before the next conv, concat or residual add; so the two
upsamples run on gathered quarter- and half-resolution tensors. ``tp``
None is the one-device forward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from patch_toon_tpu_torch.models.layers import (
    QUANT_MODES,
    QuantConv2d,
    batch_norm_eval_fp32,
    batch_norm_train_fp32,
    check_norm_layer,
    conv,
    norm_act,
    site,
    upsample2x,
)


class ResNetBlock(nn.Module):
    """x + (ReLU -> Conv3x3 -> IN -> ReLU -> Conv3x3 -> IN)(x)
    (reference src/models/generator.py:18-58); without ``norm`` the INs
    go, and the second conv is ``block.3``."""

    def __init__(self, channels: int, use_bias: bool,
                 conv_precision: Optional[str] = None, norm: bool = True):
        super().__init__()
        cp = conv_precision
        self.norm = norm
        self.tp = None  # a parallel.tp.ModelShard under tensor parallelism
        n = [nn.Identity()] if norm else []
        self.block = nn.Sequential(
            nn.ReLU(), conv(channels, channels, 3, 1, 1, use_bias, cp, True),
            *n, nn.ReLU(),
            conv(channels, channels, 3, 1, 1, use_bias, cp, True), *n)

    @property
    def conv2(self) -> QuantConv2d:
        return self.block[4 if self.norm else 3]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nm = self.norm
        y = site(self.tp, self.block[1], F.relu(x),
                 lambda t: norm_act(t, "relu", nm))  # IN, the second ReLU
        y = site(self.tp, self.conv2, y, lambda t: norm_act(t, None, nm))
        return x + y


class GeneratorJ(nn.Module):
    def __init__(self, input_channels: int = 3,
                 filters: Sequence[int] = (32, 64, 128, 128, 128, 64),
                 norm_layer: str = "instance_norm", use_bias: bool = False,
                 resnet_blocks: int = 7, tanh: bool = True,
                 append_smoothers: bool = True,
                 conv_precision: Optional[str] = None, **unused: Any):
        """Arguments as the reference constructor; ``additional_channels``
        and ``input_size`` are accepted and unused, as there.
        ``conv_precision`` "high" is precision ``32_fast`` (JAX
        ``models/generator.py:85``): every conv of an fp32 forward runs as
        ``layers.conv2d_3xtf32``."""
        super().__init__()
        check_norm_layer(norm_layer)
        self.norm = norm_layer == "instance_norm"
        self.tp = None  # a parallel.tp.ModelShard under tensor parallelism
        f = list(filters)
        c = int(input_channels)
        cp = conv_precision
        self.tanh = bool(tanh)
        q = True  # every conv but the 1x1 head takes w8a8 (JAX :100-155)
        self.initial_conv = nn.Sequential(
            conv(c, f[0], 7, 1, 3, use_bias, cp, q))
        self.downsample1 = nn.Sequential(
            conv(f[0], f[1], 3, 2, 1, use_bias, cp, q))
        self.downsample2 = nn.Sequential(
            conv(f[1], f[2], 3, 2, 1, use_bias, cp, q))
        self.resnet_blocks = nn.Sequential(
            *[ResNetBlock(f[2], use_bias, cp, self.norm)
              for _ in range(resnet_blocks)])
        self.upsample2 = nn.Sequential(
            nn.Identity(), conv(2 * f[2], f[4], 3, 1, 1, use_bias, cp, q))
        self.upsample1 = nn.Sequential(
            nn.Identity(), conv(f[4] + f[1], f[4], 3, 1, 1, use_bias, cp, q))
        self.conv11 = nn.Sequential(
            conv(f[4] + f[0] + c, f[5], 7, 1, 3, use_bias, cp, q))
        self.smoothers = nn.Sequential(
            conv(f[5], f[5], 3, 1, 1, use_bias, cp, q), nn.ReLU(),
            nn.BatchNorm2d(f[5]),
            conv(f[5], f[5], 3, 1, 1, use_bias, cp, q), nn.ReLU(),
        ) if append_smoothers else None
        # the head stays fp for output fidelity (JAX :159)
        self.output = nn.Sequential(conv(f[5], 3, 1, 1, 0, True, cp))

    def quant_layers(self) -> Dict[str, QuantConv2d]:
        """The w8a8 sites in forward order, by their module path in the
        JAX generator's ``quant`` collection ("initial_conv/conv", ...,
        "resnet_0/conv1", ..., "conv11", "smoother_conv2")."""
        out = {"initial_conv/conv": self.initial_conv[0],
               "downsample1/conv": self.downsample1[0],
               "downsample2/conv": self.downsample2[0]}
        for i, blk in enumerate(self.resnet_blocks):
            out[f"resnet_{i}/conv1"] = blk.block[1]
            out[f"resnet_{i}/conv2"] = blk.conv2
        out["upsample2/conv"] = self.upsample2[1]
        out["upsample1/conv"] = self.upsample1[1]
        out["conv11"] = self.conv11[0]
        if self.smoothers is not None:
            out["smoother_conv1"] = self.smoothers[0]
            out["smoother_conv2"] = self.smoothers[3]
        return out

    @property
    def quant_mode(self) -> Optional[str]:
        return self.initial_conv[0].quant_mode

    @quant_mode.setter
    def quant_mode(self, mode: Optional[str]) -> None:
        """JAX ``GeneratorJ.clone(quant_mode=...)``: None, "calib" or
        "int8" at every w8a8 site. "int8" needs :meth:`QuantConv2d.
        quantize_weights` on the fp32 weights first."""
        if mode not in QUANT_MODES:
            raise ValueError(f"Unknown quant mode: {mode!r}")
        for layer in self.quant_layers().values():
            layer.quant_mode = mode

    def _smoother_bn(self, y: torch.Tensor) -> torch.Tensor:
        bn = self.smoothers[2]
        return batch_norm_train_fp32(y, bn, tp=self.tp) if self.training \
            else batch_norm_eval_fp32(y, bn, self.tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        nm, tp = self.norm, self.tp

        def ina(act):
            return lambda t: norm_act(t, act, nm)

        conv0 = site(tp, self.initial_conv[0], x, ina("leaky_relu"))
        conv1 = site(tp, self.downsample1[0], conv0, ina("leaky_relu"))
        conv2 = site(tp, self.downsample2[0], conv1, ina("leaky_relu"))
        out = conv2
        for block in self.resnet_blocks:
            out = block(out)
        out = site(tp, self.upsample2[1], upsample2x(
            torch.cat([out, conv2], dim=1)), ina("relu"))
        out = site(tp, self.upsample1[1], upsample2x(
            torch.cat([out, conv1], dim=1)), ina("relu"))
        out = site(tp, self.conv11[0], torch.cat([out, conv0, x], dim=1),
                   F.relu)
        if self.smoothers is not None:
            out = site(tp, self.smoothers[0], out,
                       lambda t: self._smoother_bn(F.relu(t)))
            out = site(tp, self.smoothers[3], out, F.relu)
        out = site(tp, self.output[0], out, lambda t: t)
        if self.tanh:
            out = torch.tanh(out)
        return out.permute(0, 2, 3, 1)


def input_channels_of(state_dict) -> int:
    """Channel sniff from the stem's weight (reference generator.py:118-119)."""
    return int(state_dict["initial_conv.0.weight"].shape[1])
