"""Plain reference of the GeneratorJ configurations: the networks as the
published description gives them (Texler et al. 2020, arXiv:2004.14489,
and its reference code's ``models/generator.py`` and
``models/discriminator.py``), in fp32 PyTorch on NCHW tensors, with no
kernel, cache or batching of the program's.

Every network is a function of a state dict keyed by the reference code's
module names (so the benchmark's seeded weights load into the program
unchanged) and of an input; nothing here holds state. The forms follow the
description:

- GeneratorJ: 7x7 stem, two stride-2 3x3 downsamples, residual blocks
  (ReLU, conv, IN, ReLU, conv, IN, added to the input), two bilinear
  2x upsamples (align_corners) each concatenated with its skip and
  convolved, a 7x7 conv over (decoded, stem, input), the smoothers (conv,
  ReLU, BatchNorm, conv, ReLU), a 1x1 head and tanh. IN: per sample and
  channel, biased variance, eps 1e-5; LeakyReLU slope 0.2 with gradient 1
  at 0. The upsample is the interpolation written as two matrix products
  (rows, then columns), which is what bilinear align_corners means.
- DiscriminatorN_IN: a stride-2 4x4 conv and LeakyReLU, n_layers - 1
  stride-2 4x4 conv/IN/LeakyReLU blocks doubling the width, a stride-1
  4x4 conv/IN/LeakyReLU, a 4x4 conv to one channel.
- The VGG19 prefix (torchvision ``features`` indices): 3x3 convs, ReLU,
  2x2 max-pool; the maps at ``feature_layers``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str]  # name, shape, kind
State = Dict[str, torch.Tensor]


def _conv_spec(name: str, cout: int, cin: int, k: int,
               bias: bool = True) -> List[Spec]:
    out = [(f"{name}.weight", (cout, cin, k, k), "conv")]
    if bias:
        out.append((f"{name}.bias", (cout,), "bias"))
    return out


def generator_specs(args: dict, cin: int) -> List[Spec]:
    """The parameters and BatchNorm buffers of GeneratorJ."""
    f = list(args["filters"])
    bias = bool(args.get("use_bias", True))
    s = _conv_spec("initial_conv.0", f[0], cin, 7, bias)
    s += _conv_spec("downsample1.0", f[1], f[0], 3, bias)
    s += _conv_spec("downsample2.0", f[2], f[1], 3, bias)
    for i in range(int(args["resnet_blocks"])):
        s += _conv_spec(f"resnet_blocks.{i}.block.1", f[2], f[2], 3, bias)
        s += _conv_spec(f"resnet_blocks.{i}.block.4", f[2], f[2], 3, bias)
    s += _conv_spec("upsample2.1", f[4], 2 * f[2], 3, bias)
    s += _conv_spec("upsample1.1", f[4], f[4] + f[1], 3, bias)
    s += _conv_spec("conv11.0", f[5], f[4] + f[0] + cin, 7, bias)
    if args.get("append_smoothers", True):
        s += _conv_spec("smoothers.0", f[5], f[5], 3, bias)
        s += [("smoothers.2.weight", (f[5],), "bn_weight"),
              ("smoothers.2.bias", (f[5],), "bn_bias"),
              ("smoothers.2.running_mean", (f[5],), "bn_mean"),
              ("smoothers.2.running_var", (f[5],), "bn_var"),
              ("smoothers.2.num_batches_tracked", (), "bn_count")]
        s += _conv_spec("smoothers.3", f[5], f[5], 3, bias)
    s += _conv_spec("output.0", 3, f[5], 1, True)
    return s


def discriminator_specs(args: dict) -> List[Spec]:
    nf, bias = int(args["num_filters"]), bool(args.get("use_bias", True))
    s = _conv_spec("initial.0", nf, int(args.get("input_channels", 3)), 4,
                   bias)
    curr = nf
    for i in range(1, int(args["n_layers"])):
        nxt = min(curr * 2, nf * 8)
        s += _conv_spec(f"intermediate.{i - 1}.0", nxt, curr, 4, bias)
        curr = nxt
    nxt = min(curr * 2, nf * 8)
    s += _conv_spec("pre_output.0", nxt, curr, 4, bias)
    s += _conv_spec("output.0", 1, nxt, 4, bias)
    return s


VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def vgg_plan(max_index: int) -> List[Tuple[str, int]]:
    """[(op, width)] of torchvision's vgg19 ``features`` up to an index."""
    plan: List[Tuple[str, int]] = []
    for width in VGG19:
        plan += [("pool", 0)] if width == "M" else [("conv", int(width)),
                                                    ("relu", 0)]
        if len(plan) > max_index:
            break
    return plan[:max_index + 1]


def vgg_specs(feature_layers: Sequence[int]) -> List[Spec]:
    s: List[Spec] = []
    cin = 3
    for idx, (op, width) in enumerate(vgg_plan(max(feature_layers))):
        if op == "conv":
            s += _conv_spec(f"features.{idx}", width, cin, 3)
            cin = width
    return s


# -- the networks ---------------------------------------------------------

def _conv(sd: State, name: str, x: torch.Tensor, stride: int = 1,
          pad: int = 0) -> torch.Tensor:
    return F.conv2d(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"),
                    stride, pad)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


@functools.lru_cache(maxsize=16)
def _interp(n: int) -> np.ndarray:
    """(2n, n): y = A x is the align_corners bilinear 2x upsample of x."""
    a = np.zeros((2 * n, n), np.float64)
    if n == 1:
        a[:, 0] = 1.0
        return a
    for i in range(2 * n):
        src = i * (n - 1) / (2 * n - 1)
        lo = min(int(np.floor(src)), n - 2)
        a[i, lo] += 1.0 - (src - lo)
        a[i, lo + 1] += src - lo
    return a


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x, align_corners, NCHW: the rows' product, then the
    columns'."""
    ah = torch.as_tensor(_interp(x.shape[2]), dtype=x.dtype, device=x.device)
    aw = torch.as_tensor(_interp(x.shape[3]), dtype=x.dtype, device=x.device)
    y = torch.matmul(ah, x)                       # (N, C, 2H, W)
    return torch.matmul(y, aw.t())                # (N, C, 2H, 2W)


def batch_norm(x: torch.Tensor, sd: State, name: str,
               train: bool, eps: float = 1e-5) -> torch.Tensor:
    if train:  # batch statistics, biased variance
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = torch.square(x - mean).mean(dim=(0, 2, 3), keepdim=True)
    else:
        mean = sd[f"{name}.running_mean"][None, :, None, None]
        var = sd[f"{name}.running_var"][None, :, None, None]
    w = sd[f"{name}.weight"][None, :, None, None]
    b = sd[f"{name}.bias"][None, :, None, None]
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def generator(sd: State, x: torch.Tensor, args: dict,
              train: bool = False) -> torch.Tensor:
    """GeneratorJ: (N, C, H, W) in [-1, 1] -> (N, 3, H, W)."""
    def block(name, t, stride, pad, act):
        return act(instance_norm(_conv(sd, name, t, stride, pad)))

    c0 = block("initial_conv.0", x, 1, 3, leaky_relu)
    c1 = block("downsample1.0", c0, 2, 1, leaky_relu)
    c2 = block("downsample2.0", c1, 2, 1, leaky_relu)
    out = c2
    for i in range(int(args["resnet_blocks"])):
        y = block(f"resnet_blocks.{i}.block.1", F.relu(out), 1, 1, F.relu)
        y = instance_norm(_conv(sd, f"resnet_blocks.{i}.block.4", y, 1, 1))
        out = out + y
    out = block("upsample2.1", upsample2x(torch.cat([out, c2], 1)), 1, 1,
                F.relu)
    out = block("upsample1.1", upsample2x(torch.cat([out, c1], 1)), 1, 1,
                F.relu)
    out = F.relu(_conv(sd, "conv11.0", torch.cat([out, c0, x], 1), 1, 3))
    if args.get("append_smoothers", True):
        out = batch_norm(F.relu(_conv(sd, "smoothers.0", out, 1, 1)), sd,
                         "smoothers.2", train)
        out = F.relu(_conv(sd, "smoothers.3", out, 1, 1))
    out = _conv(sd, "output.0", out)
    return torch.tanh(out) if args.get("tanh", True) else out


def discriminator(sd: State, x: torch.Tensor, args: dict) -> torch.Tensor:
    """DiscriminatorN_IN: (N, 3, H, W) -> (N, 1, H', W') logits."""
    h = leaky_relu(_conv(sd, "initial.0", x, 2, 1))
    for i in range(1, int(args["n_layers"])):
        h = leaky_relu(instance_norm(_conv(sd, f"intermediate.{i - 1}.0", h,
                                           2, 1)))
    h = leaky_relu(instance_norm(_conv(sd, "pre_output.0", h, 1, 1)))
    return _conv(sd, "output.0", h, 1, 1)


def vgg_features(sd: State, x: torch.Tensor,
                 feature_layers: Sequence[int]) -> List[torch.Tensor]:
    """The VGG19 prefix's maps at ``feature_layers`` of (N, 3, H, W) in
    [-1, 1] (no input normalization)."""
    want = set(int(i) for i in feature_layers)
    feats = []
    for idx, (op, _) in enumerate(vgg_plan(max(want))):
        if op == "conv":
            x = _conv(sd, f"features.{idx}", x, 1, 1)
        elif op == "relu":
            x = F.relu(x)
        else:
            x = F.max_pool2d(x, 2, 2)
        if idx in want:
            feats.append(x)
    return feats
