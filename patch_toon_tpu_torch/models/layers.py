"""GeneratorJ's building blocks in PyTorch.

Counterpart of ``patch_toon_tpu/models/layers.py``. Activations run as NCHW
tensors in ``channels_last`` memory, which is NHWC in memory: convolutions
go to cuDNN in that layout and the InstanceNorm kernel reads it without a
copy. Conv weights are torch's OIHW (reference ``nn.Conv2d``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from patch_toon_tpu_torch.ops.instance_norm import instance_norm_act


def conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
         bias: bool = True) -> nn.Conv2d:
    """Torch-compatible conv: explicit zero padding, N(0, 0.02) weights and
    zero bias as at reference generator.py:149-154."""
    layer = nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                      bias=bias)
    nn.init.normal_(layer.weight, 0.0, 0.02)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def norm_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """InstanceNorm + activation of an NCHW tensor through the NHWC kernel
    entry point (a free view for channels_last memory)."""
    nhwc = y.permute(0, 2, 3, 1).contiguous()
    return instance_norm_act(nhwc, act).permute(0, 3, 1, 2)


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
