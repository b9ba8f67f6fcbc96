"""DiscriminatorN_IN in PyTorch (counterpart of
patch_toon_tpu/models/discriminator.py:22-82).

PatchGAN: a 4x4 stride-2 conv stem with LeakyReLU(0.2) and no norm, then
``n_layers - 1`` stride-2 blocks that double the filters (capped at 8x),
a stride-1 pre-output block, each conv -> InstanceNorm -> LeakyReLU, and a
4x4 conv to one channel (reference src/models/discriminator.py:42-93).
Both InstanceNorm sites go through ``layers.norm_act`` (kernel B1 and, under
autograd, its backward kernel).

Module names are the reference's (``initial.0``, ``intermediate.{i}.0``,
``pre_output.0``, ``output.0``), so its state dict reads through JAX
``utils/torch_compat.py::discriminator_params_from_torch``. The interface
is NHWC like the JAX module: (N, H, W, C) in [-1, 1] -> the (N, H', W', 1)
logit map, in the input's type.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from patch_toon_tpu_torch.models.layers import conv, leaky_relu, norm_act


class DiscriminatorN_IN(nn.Module):
    def __init__(self, input_channels: int = 3, num_filters: int = 64,
                 n_layers: int = 3, use_noise: bool = False,
                 noise_sigma: float = 0.2,
                 norm_layer: str = "instance_norm", use_bias: bool = True,
                 **unused: Any):
        """Arguments as the reference constructor; ``additional_channels``
        is accepted and unused, as there."""
        super().__init__()
        if norm_layer != "instance_norm":
            raise NotImplementedError(
                f"discriminator norm_layer={norm_layer!r} is not ported yet")
        self.use_noise = bool(use_noise)
        self.noise_sigma = float(noise_sigma)
        nf = int(num_filters)
        self.initial = nn.Sequential(
            conv(int(input_channels), nf, 4, 2, 1, use_bias), nn.LeakyReLU(0.2))
        blocks, curr = [], nf
        for _ in range(1, n_layers):
            nxt = min(curr * 2, nf * 8)
            blocks.append(nn.Sequential(conv(curr, nxt, 4, 2, 1, use_bias),
                                        nn.Identity(), nn.LeakyReLU(0.2)))
            curr = nxt
        self.intermediate = nn.Sequential(*blocks)
        nxt = min(curr * 2, nf * 8)
        self.pre_output = nn.Sequential(conv(curr, nxt, 4, 1, 1, use_bias),
                                        nn.Identity(), nn.LeakyReLU(0.2))
        self.output = nn.Sequential(conv(nxt, 1, 4, 1, 1, use_bias))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (N, H, W, C). In train mode with ``use_noise``, Gaussian noise
        of ``noise_sigma`` drawn from ``generator`` is added to the input
        (JAX draws it from the step's ``noise_rng``)."""
        if self.use_noise and self.training:
            if generator is None:
                raise ValueError("use_noise=True needs a torch.Generator in "
                                 "training")
            x = x + torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype) * self.noise_sigma
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        out = leaky_relu(self.initial[0](x))
        for block in self.intermediate:
            out = norm_act(block[0](out), "leaky_relu")
        out = norm_act(self.pre_output[0](out), "leaky_relu")
        return self.output[0](out).permute(0, 2, 3, 1)
