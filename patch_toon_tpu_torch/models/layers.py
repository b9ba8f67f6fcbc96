"""The networks' building blocks in PyTorch.

Counterpart of ``patch_toon_tpu/models/layers.py``. Activations run as NCHW
tensors in ``channels_last`` memory, which is NHWC in memory: convolutions
go to cuDNN in that layout and the InstanceNorm kernel reads it without a
copy. Conv weights are torch's OIHW (reference ``nn.Conv2d``), kept in fp32
for training and cast to the activation's type in each forward, as flax
casts fp32 parameters to a module's compute dtype.

Precision ``32_fast`` (JAX ``conv_precision="high"``, ``lax.Precision.HIGH``:
a 3-pass bf16 product with fp32 tensors) is :func:`conv2d_3xtf32` here:
each fp32 operand splits into hi (rounded to TF32's 10 mantissa bits) and
lo = x - hi, and three fp32 cuDNN convolutions with TF32 allowed for them
alone, hi*hi + hi*lo + lo*hi, sum in fp32. The forward and both gradients
take the same split (:class:`_Conv3xTF32`); the flag is restored after
each call, so the strict fp32 path keeps TF32 off.
"""

from __future__ import annotations

import functools
import contextlib
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from patch_toon_tpu_torch.ops.instance_norm import instance_norm_act_autograd
from patch_toon_tpu_torch.ops.quant import (
    activation_scale,
    conv_s8,
    pack_weight,
    padded_channels,
    quantize_act,
    quantize_weight,
)
from patch_toon_tpu_torch.parallel import comm


FAST_PRECISIONS = ("32_fast", "tf32", "fp32_fast")


def resolve_conv_precision(precision: Any) -> Optional[str]:
    """The networks' conv precision for a precision name (JAX
    ``train/model.py::_resolve_conv_precision``): "high" for ``32_fast``
    and its aliases, None (the dtype's own policy) for the others."""
    return "high" if str(precision) in FAST_PRECISIONS else None


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to the nearest value with 10 mantissa bits (ties to
    even), the part of an operand that a TF32 tensor core multiplies
    exactly."""
    i = t.view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32)


def _split(t: torch.Tensor):
    hi = _round_tf32(t)
    return hi, t - hi


@contextlib.contextmanager
def _tf32_convs():
    """TF32 allowed in cuDNN convolutions for the block only; the flag is
    put back as it was (the strict fp32 path keeps it off)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _conv_backward(gy, x, w, stride, padding, want_input: bool):
    """One cuDNN product of a conv's backward pass: the input gradient
    (``want_input``) or the weight gradient, of ``gy`` against ``w`` or
    ``x``."""
    mask = [want_input, not want_input, False]
    out = torch.ops.aten.convolution_backward(
        gy, x, w, None, list(stride), list(padding), [1, 1], False, [0, 0],
        1, mask)
    return out[0] if want_input else out[1]


class _Conv3xTF32(torch.autograd.Function):
    """An fp32 conv as three TF32 products of the hi/lo split, in the
    forward and in both gradients (JAX differentiates a HIGH conv into
    transposed convs at the same precision)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, padding, b is not None)
        (xh, xl), (wh, wl) = _split(x), _split(w)
        with _tf32_convs():
            y = F.conv2d(xh, wh, None, stride, padding)
            y = y + F.conv2d(xh, wl, None, stride, padding)
            y = y + F.conv2d(xl, wh, None, stride, padding)
        return y if b is None else y + b[None, :, None, None]

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, has_bias = ctx.geometry
        (gh, gl), (xh, xl), (wh, wl) = _split(gy), _split(x), _split(w)
        gx = gw = gb = None
        with _tf32_convs():
            if ctx.needs_input_grad[0]:
                gx = _conv_backward(gh, xh, wh, stride, padding, True)
                gx = gx + _conv_backward(gh, xh, wl, stride, padding, True)
                gx = gx + _conv_backward(gl, xh, wh, stride, padding, True)
            if ctx.needs_input_grad[1]:
                gw = _conv_backward(gh, xh, wh, stride, padding, False)
                gw = gw + _conv_backward(gh, xl, wh, stride, padding, False)
                gw = gw + _conv_backward(gl, xh, wh, stride, padding, False)
        if has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum(dim=(0, 2, 3))
        return gx, gw, gb, None, None


def conv2d_3xtf32(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], stride, padding) -> torch.Tensor:
    """``F.conv2d`` of fp32 tensors at JAX's ``Precision.HIGH``: three TF32
    products of the hi/lo split summed in fp32 (within 2e-5 of the fp32
    conv; the gradients split alike)."""
    return _Conv3xTF32.apply(x, w, b, tuple(stride), tuple(padding))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in its input's type: the weight and bias are
    cast to it (a no-op when they already have it; differentiable, so fp32
    parameters receive fp32 gradients from a bf16 forward).
    ``conv_precision="high"`` runs an fp32 input through
    :func:`conv2d_3xtf32` (precision ``32_fast``)."""

    conv_precision: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.conv_precision == "high" and x.dtype == torch.float32:
            return conv2d_3xtf32(x, w, b, self.stride, self.padding)
        return self._conv_forward(x, w, b)


QUANT_MODES = (None, "calib", "int8")
_QUANT_BUFFERS = ("a_scale", "wq", "w_s")


class QuantConv2d(Conv2d):
    """:class:`Conv2d` with JAX's w8a8 serving modes (``QuantConv``,
    patch_toon_tpu/models/layers.py:165-251): the same parameters and
    state-dict keys, so every checkpoint loads unchanged, and
    ``quant_mode``:

    - None: :class:`Conv2d`, bit for bit;
    - ``"calib"``: :class:`Conv2d`'s forward, folding the input's fp32
      ``max|x|`` into ``a_scale`` (repeated calls take the max);
    - ``"int8"``: ``ops.quant.quantize_act`` against the scale
      (``ops.quant.activation_scale``: the stored one where positive, else
      the dynamic ``max|x|``; ``calibrated``, a host flag, takes the stored
      one without the reduction), then ``ops.quant.conv_s8`` over ``wq``
      and ``w_s``, the weight quantized by :meth:`quantize_weights`.

    ``a_scale``, ``wq`` and ``w_s`` are non-persistent buffers (JAX keeps
    them in a ``quant`` collection apart from the params): they never
    enter ``state_dict()``, and ``.to(dtype)`` leaves their types alone
    (they follow the weight's device), so the engine's cast of every conv
    to the serving type keeps the fp32 scales and the int8 weight."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant_mode: Optional[str] = None
        self.calibrated = False
        self.register_buffer("a_scale", torch.zeros((), dtype=torch.float32,
                                                    device=self.weight.device),
                             persistent=False)
        self.register_buffer("wq", None, persistent=False)
        self.register_buffer("w_s", None, persistent=False)

    def _apply(self, fn, recurse=True):
        keep = {k: self._buffers.pop(k) for k in _QUANT_BUFFERS}
        super()._apply(fn, recurse)
        for k, t in keep.items():
            self._buffers[k] = None if t is None else t.to(self.weight.device)
        return self

    def quantize_weights(self) -> None:
        """``wq`` (packed for ``conv_s8``) and ``w_s`` from the fp32 weight,
        as JAX quantizes the fp32 kernel: call it before the weight is cast
        to the serving type."""
        if self.weight.dtype != torch.float32:
            raise ValueError("quantize_weights needs the fp32 weight, got "
                             f"{self.weight.dtype}")
        wq, w_s = quantize_weight(self.weight.detach())
        self.wq = pack_weight(wq, padded_channels(self.in_channels))
        self.w_s = w_s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.quant_mode
        if mode is None:
            return super().forward(x)
        if mode == "calib":
            with torch.no_grad():
                self.a_scale = torch.maximum(
                    self.a_scale, x.detach().float().abs().amax())
            return super().forward(x)
        if mode != "int8":
            raise ValueError(f"Unknown quant mode: {mode!r}")
        if self.wq is None:
            raise RuntimeError("int8 mode before quantize_weights()")
        s = activation_scale(self.a_scale, x, self.calibrated)
        xq = quantize_act(x.permute(0, 2, 3, 1).contiguous(), s)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = conv_s8(xq, self.wq, s, self.w_s, b, self.kernel_size[0],
                    self.stride[0], self.padding[0], x.dtype)
        return y.permute(0, 3, 1, 2)


def conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
         bias: bool = True, conv_precision: Optional[str] = None,
         quantizable: bool = False) -> Conv2d:
    """Torch-compatible conv: explicit zero padding, N(0, 0.02) weights and
    zero bias as at reference generator.py:149-154; ``conv_precision``
    None or "high" (JAX ``models/layers.py::resolve_mxu_precision``);
    ``quantizable``: a :class:`QuantConv2d` (the generator's w8a8 sites)."""
    if conv_precision not in (None, "high"):
        raise ValueError(f"Unknown conv_precision: {conv_precision!r}")
    cls = QuantConv2d if quantizable else Conv2d
    layer = cls(cin, cout, k, stride=stride, padding=padding, bias=bias)
    layer.conv_precision = conv_precision
    nn.init.normal_(layer.weight, 0.0, 0.02)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jnp.where(x >= 0, x, x * slope)``: gradient 1 at exactly 0, as in
    JAX (``F.leaky_relu`` passes ``slope`` there)."""
    return torch.where(x >= 0, x, x * slope)


def check_norm_layer(norm_layer: Any) -> None:
    """Raise where JAX's ``ConvBlock`` raises (``models/layers.py:289-292``):
    BatchNorm inside a conv block is used by no shipped configuration.
    Otherwise only ``"instance_norm"`` normalizes; any other value
    (``None``, ``"none"``) builds no norm (JAX :285-292, 321-324,
    ``generator.py:47-48``)."""
    if norm_layer == "batch_norm":
        raise NotImplementedError(
            "batch_norm inside ConvBlock is not used by any shipped config")


def norm_act(y: torch.Tensor, act: Optional[str],
             norm: bool = True) -> torch.Tensor:
    """InstanceNorm + activation of an NCHW tensor through the NHWC kernel
    entry point (a free view for channels_last memory); differentiable
    through the backward kernel when autograd records. ``norm`` False: the
    activation alone (``norm_layer`` none), ``leaky_relu`` or ``F.relu``."""
    if not norm:
        if act == "leaky_relu":
            return leaky_relu(y)
        return F.relu(y) if act == "relu" else y
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


def site(tp: Any, conv: nn.Module, x: torch.Tensor,
         post: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """A conv and the per-channel ops after it, ``post(conv(x))``. Under
    tensor parallelism (``tp`` a ``parallel.tp.ModelShard``) a conv whose
    output channels are sharded (``tp_sharded``) takes the whole input,
    computes this rank's channels with its weight slice, runs ``post`` on
    them and gathers the whole output (``ModelShard.site``); a replicated
    conv runs whole on every rank."""
    if tp is None or not getattr(conv, "tp_sharded", False):
        return post(conv(x))
    return tp.site(conv, x, post)


def _bn_sharded(bn: nn.BatchNorm2d) -> bool:
    """Whether ``bn``'s parameters are a tensor-parallel slice of its
    (whole, replicated) running statistics' channels."""
    return bn.weight.shape[0] != bn.running_mean.shape[0]


def _bn_slice(bn: nn.BatchNorm2d, tp: Any) -> slice:
    """The channels of ``bn``'s running statistics that its parameters
    hold: all of them, or this rank's slice when they are sharded."""
    c = bn.running_mean.shape[0]
    return tp.channels(c) if _bn_sharded(bn) else slice(0, c)


def batch_norm_eval_fp32(x: torch.Tensor, bn: nn.BatchNorm2d,
                         tp: Any = None) -> torch.Tensor:
    """Eval-mode BatchNorm computed in fp32 whatever the compute type, as
    the JAX generator's smoother does; the result returns to x's type.
    Under tensor parallelism (``tp``) a sharded BatchNorm normalizes its
    channel slice with its slice of the running statistics."""
    sl = _bn_slice(bn, tp)
    y = F.batch_norm(x.float(), bn.running_mean[sl].float(),
                     bn.running_var[sl].float(), bn.weight.float(),
                     bn.bias.float(), False, 0.0, bn.eps)
    return y.to(x.dtype)


def batch_norm_train_fp32(x: torch.Tensor, bn: nn.BatchNorm2d,
                          momentum: float = 0.9,
                          tp: Any = None) -> torch.Tensor:
    """Train-mode BatchNorm as flax computes it (``nn.BatchNorm`` with
    ``use_fast_variance``): fp32 batch mean and BIASED variance
    ``max(0, E[x^2] - E[x]^2)`` over N, H, W, ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``, and the running statistics advanced in place
    as ``momentum * running + (1 - momentum) * batch`` with that biased
    variance (torch's own BatchNorm uses the unbiased one there).

    Over several data ranks (``parallel.comm.data_layout(tp)``) the
    statistics are those of the global batch, as GSPMD takes them over
    every shard: each rank's per-channel fp32 sums of x and x^2 and its
    element count go through the differentiable all-reduce over the data
    group (``parallel.all_reduce_sum``), so each rank's gradient carries
    the cross-rank terms, and every rank advances the running statistics
    alike. Under tensor parallelism (``tp``) a sharded BatchNorm takes x's
    channel slice with its parameter slices, and the batch statistics of
    every slice are gathered over the model group (no gradient) to
    advance the whole running statistics, which stay replicated as JAX's
    ``batch_stats``. On one rank the function is the one-device arithmetic
    (``mean`` over N, H, W), bitwise."""
    x32 = x.float()
    data, _, group = comm.data_layout(tp)
    if data > 1:
        c = x32.shape[1]
        sums = comm.all_reduce_sum(torch.cat([
            x32.sum(dim=(0, 2, 3)), torch.square(x32).sum(dim=(0, 2, 3)),
            x32.new_full((1,), float(x32.numel() // c))]), group)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp_min(sums[c:2 * c] / sums[2 * c]
                              - torch.square(mean), 0.0)
    else:
        mean = x32.mean(dim=(0, 2, 3))
        var = torch.clamp_min(torch.square(x32).mean(dim=(0, 2, 3))
                              - torch.square(mean), 0.0)
    with torch.no_grad():
        new_mean, new_var = mean, var
        if _bn_sharded(bn):
            parts = tp.comm.all_gather(torch.stack([mean, var])[None])
            new_mean = parts[:, 0].reshape(-1)
            new_var = parts[:, 1].reshape(-1)
        bn.running_mean.copy_(momentum * bn.running_mean
                              + (1 - momentum) * new_mean)
        bn.running_var.copy_(momentum * bn.running_var
                             + (1 - momentum) * new_var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None] \
        + bn.bias.float()[None, :, None, None]
    return y.to(x.dtype)
