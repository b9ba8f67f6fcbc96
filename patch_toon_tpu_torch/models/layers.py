"""The networks' building blocks in PyTorch.

Counterpart of ``patch_toon_tpu/models/layers.py``. Activations run as NCHW
tensors in ``channels_last`` memory, which is NHWC in memory: convolutions
go to cuDNN in that layout and the InstanceNorm kernel reads it without a
copy. Conv weights are torch's OIHW (reference ``nn.Conv2d``), kept in fp32
for training and cast to the activation's type in each forward, as flax
casts fp32 parameters to a module's compute dtype.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from patch_toon_tpu_torch.ops.instance_norm import instance_norm_act_autograd


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in its input's type: the weight and bias are
    cast to it (a no-op when they already have it; differentiable, so fp32
    parameters receive fp32 gradients from a bf16 forward)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)


def conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
         bias: bool = True) -> Conv2d:
    """Torch-compatible conv: explicit zero padding, N(0, 0.02) weights and
    zero bias as at reference generator.py:149-154."""
    layer = Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)
    nn.init.normal_(layer.weight, 0.0, 0.02)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jnp.where(x >= 0, x, x * slope)``: gradient 1 at exactly 0, as in
    JAX (``F.leaky_relu`` passes ``slope`` there)."""
    return torch.where(x >= 0, x, x * slope)


def norm_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """InstanceNorm + activation of an NCHW tensor through the NHWC kernel
    entry point (a free view for channels_last memory); differentiable
    through the backward kernel when autograd records."""
    nhwc = y.permute(0, 2, 3, 1).contiguous()
    return instance_norm_act_autograd(nhwc, act).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=64)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Interpolation matrix A (out x in): y = A @ x, align_corners=True
    (own copy of patch_toon_tpu/models/layers.py::_align_corners_matrix)."""
    a = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        a[:, 0] = 1.0
        return a
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        src = i * scale
        lo = min(int(np.floor(src)), in_size - 2)
        w = src - lo
        a[i, lo] = 1.0 - w
        a[i, lo + 1] = w
    return a


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The 2x interpolation matrix, built in fp32 and cast to ``dtype``
    (the JAX package casts it to the compute type, so bf16 rounds weights
    such as 1/3), one copy per (size, dtype, device)."""
    a = torch.from_numpy(_align_corners_matrix(in_size, 2 * in_size))
    return a.to(device=device, dtype=dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with align_corners=True (reference
    generator.py:13) as the JAX package computes it: two matrix products in
    the activation's type, over H on the (N, H, W*C) view of the NHWC
    memory, then over W on the (N*2H, W, C) view. Takes and returns an NCHW
    tensor in channels_last memory; no permute copies. fp32 products run at
    full fp32 when ``torch.backends.cuda.matmul.allow_tf32`` is False (the
    engine sets it), as the JAX package asks for HIGHEST precision."""
    n, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1).contiguous()  # a view for channels_last
    ah = _interp_matrix(h, x.dtype, x.device)
    aw = _interp_matrix(w, x.dtype, x.device)
    y = torch.matmul(ah, nhwc.view(n, h, w * c))            # (N, 2H, W*C)
    y = torch.matmul(aw, y.view(n * 2 * h, w, c))           # (N*2H, 2W, C)
    return y.view(n, 2 * h, 2 * w, c).permute(0, 3, 1, 2)


def batch_norm_eval_fp32(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm computed in fp32 whatever the compute type, as
    the JAX generator's smoother does; the result returns to x's type."""
    y = F.batch_norm(x.float(), bn.running_mean.float(),
                     bn.running_var.float(), bn.weight.float(),
                     bn.bias.float(), False, 0.0, bn.eps)
    return y.to(x.dtype)


def batch_norm_train_fp32(x: torch.Tensor, bn: nn.BatchNorm2d,
                          momentum: float = 0.9) -> torch.Tensor:
    """Train-mode BatchNorm as flax computes it (``nn.BatchNorm`` with
    ``use_fast_variance``): fp32 batch mean and BIASED variance
    ``max(0, E[x^2] - E[x]^2)`` over N, H, W, ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``, and the running statistics advanced in place
    as ``momentum * running + (1 - momentum) * batch`` with that biased
    variance (torch's own BatchNorm uses the unbiased one there)."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = torch.clamp_min(torch.square(x32).mean(dim=(0, 2, 3))
                          - torch.square(mean), 0.0)
    with torch.no_grad():
        bn.running_mean.copy_(momentum * bn.running_mean
                              + (1 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var
                             + (1 - momentum) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None] \
        + bn.bias.float()[None, :, None, None]
    return y.to(x.dtype)
