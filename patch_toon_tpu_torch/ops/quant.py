"""w8a8 int8 convolution for serving (``inference.quantize: int8``).

Counterpart of the arithmetic of ``patch_toon_tpu/models/layers.py::
QuantConv`` (:165-251), in the same order:

- weights per output channel (:238-241): ``w_amax = max(max|w|, 1e-12)``
  over (cin, kh, kw), ``w_s = w_amax / 127``, ``wq = round(w / w_s)`` as
  int8, from the fp32 weights (:func:`quantize_weight`);
- activations per tensor (:226-237): the calibrated ``a_scale`` where it
  is positive, else the dynamic ``max|x|``; ``s = max(eff, 1e-12) / 127``
  in fp32 on the device (:func:`activation_scale`), then
  ``clip(round(x_f32 / s), -127, 127)`` as int8 (:func:`quantize_act`);
- the int32 accumulator of the int8 convolution, then
  ``(float32(acc) * (s * w_s)).to(cdt) + bias.to(cdt)`` (:242-250;
  :func:`conv_s8`).

JAX runs the int8 product as XLA's ``conv_general_dilated`` with
``preferred_element_type=int32``, not as a Pallas kernel. No PyTorch call
convolves int8 on the card, so the port has kernels of its own in
``csrc/quant_conv.cu``: ``quantize_act_kernel`` (NHWC bf16 or fp32 in,
NHWC int8 out with the channels zero-padded to ``Cp``, a multiple of 16;
bound by bytes) and, for :func:`conv_s8`, two implicit GEMMs bound by int8
operations (1,979 TOPS on an H100): ``wgmma`` s8 products from 128-byte
swizzled shared memory fed by mbarrier rings (a producer warpgroup, two
consumer warpgroups, B by TMA), a persistent grid whose tiles cover Cout
up to 128, and an epilogue staged in shared memory and written with
16-byte stores. The gather kernel gathers A with cp.async, a 128-pixel
tile at a time; the halo kernel (stride-1 windows of Cout 33-64: conv11
and the smoothers) loads each 16 x 16 tile's input patch once and reads A
out of it at every tap. ``csrc/quant_conv.cu::conv_plan`` picks the kernel
and sizes the launch (N, the stages, whether the whole weight stays
resident) from the shared-memory layout that only the kernels' source
knows; :func:`conv_plan` asks it. The quantization is symmetric, so zero
padding (of the image, the channels, K and N) is exact.

Layouts: ``xq`` is (N, H, W, Cp) int8; the packed weight is (Cout, Kp)
int8 with row ``(ky, kx, c)`` flattened K-contiguous (K = k * k * Cp) and
zeros up to ``Kp``, the next multiple of 32 (:func:`pack_weight`); the
output is (N, Ho, Wo, Cout), NHWC, in the layer's type, or the int32
accumulator itself.

On a CUDA tensor :func:`quantize_act` and :func:`conv_s8` launch the
kernels (counted in ``.launches`` and ``.by_device``) or raise; on a CPU
tensor they run the plain versions. Scalars that divide are 0-d tensors
on the operand's device: CUDA divides by a host scalar through its
reciprocal, which is not IEEE division.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from patch_toon_tpu_torch import _build

CP_ALIGN = 16  # channels of xq: whole 16-byte vectors, never across taps
KP_ALIGN = 32  # K of the packed weight: whole k32 steps, TMA's 16-byte rows
KERNEL_SIZES = (3, 7)
STRIDES = (1, 2)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_CONSTS: Dict[Tuple[float, torch.device], torch.Tensor] = {}


def _const(v: float, device: torch.device) -> torch.Tensor:
    """A 0-d fp32 tensor on ``device``, one copy a (value, device)."""
    key = (v, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(v, dtype=torch.float32,
                                        device=device)
    return t


VARIANTS = ("gather", "halo")  # conv_s8's kernels, by a plan's variant


@dataclass(frozen=True)
class ConvPlan:
    variant: int     # 0 the gather kernel, 1 the halo kernel
    bn: int          # output channels a tile (wgmma's N)
    n_tiles: int     # tiles across Cout (1 up to Cout 128)
    stages: int      # depth of the ring (of B, in the halo kernel)
    resident: bool   # the whole packed weight stays in shared memory
    smem_bytes: int  # dynamic shared memory a CTA


@functools.lru_cache(maxsize=None)
def _plan(cout: int, kp: int, out_dtype: torch.dtype, k: int, stride: int,
          variant: int, resident: bool, stages: int) -> Optional[ConvPlan]:
    """``ptt_conv_s8_plan``: ``variant`` -1 is conv_s8's own plan; 0 or 1
    forces that kernel, ``resident`` and ``stages`` too (0: as deep as
    fits), None where it does not take the layer (the card's tests and
    tools/conv_s8_plans_torch.py time and check plans the main path
    does not take)."""
    out = (ctypes.c_int * 6)()
    rc = _build.library().ptt_conv_s8_plan(
        cout, kp, k, stride, _DTYPE_CODE[out_dtype], variant, int(resident),
        stages, ctypes.addressof(out))
    if rc:
        return None
    return ConvPlan(out[0], out[1], out[2], out[3], bool(out[4]), out[5])


def conv_plan(cout: int, kp: int, out_dtype: torch.dtype, k: int = 3,
              stride: int = 1) -> ConvPlan:
    """The kernel and its tiling that :func:`conv_s8` launches for a layer
    (``csrc/quant_conv.cu::conv_plan``; needs the kernels' library): the
    halo kernel for a stride-1 window of Cout 33-64, else the gather
    kernel with N the least tile width that covers Cout (128 past it, in
    several tiles) and the weight resident where it fits."""
    p = _plan(cout, kp, out_dtype, k, stride, -1, False, 0)
    if p is None:
        raise ValueError(f"conv_s8: no plan for Cout={cout}, Kp={kp}, "
                         f"k={k}, stride={stride}")
    return p


def padded_channels(c: int) -> int:
    return -(-c // CP_ALIGN) * CP_ALIGN


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 OIHW weight -> (int8 OIHW ``wq``, fp32 (Cout,) ``w_s``), per
    output channel (JAX ``layers.py:238-241``)."""
    if w.dtype != torch.float32:
        raise ValueError(f"quantize_weight: fp32 weights expected, got "
                         f"{w.dtype}")
    w_amax = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12)
    w_s = w_amax / _const(127.0, w.device)
    wq = torch.round(w / w_s[:, None, None, None]).to(torch.int8)
    return wq, w_s


def pack_weight(wq: torch.Tensor, cp: int) -> torch.Tensor:
    """int8 OIHW ``wq`` -> the kernel's (Cout, Kp) layout: each row
    ``(ky, kx, c)`` K-contiguous with the channels zero-padded to ``cp``
    and K zero-padded to a multiple of 32."""
    cout, cin, kh, kw = wq.shape
    if cp % CP_ALIGN or cp < cin:
        raise ValueError(f"pack_weight: Cp={cp} for Cin={cin}")
    w = torch.zeros((cout, kh, kw, cp), dtype=torch.int8, device=wq.device)
    w[..., :cin] = wq.permute(0, 2, 3, 1)
    k = kh * kw * cp
    kp = -(-k // KP_ALIGN) * KP_ALIGN
    out = torch.zeros((cout, kp), dtype=torch.int8, device=wq.device)
    out[:, :k] = w.reshape(cout, k)
    return out


def unpack_weight(wp: torch.Tensor, k: int, cp: int) -> torch.Tensor:
    """The packed (Cout, Kp) weight as (Cout, Cp, k, k) int8."""
    return wp[:, :k * k * cp].reshape(-1, k, k, cp).permute(0, 3, 1, 2)


def activation_scale(a_scale: torch.Tensor, x: torch.Tensor,
                     calibrated: bool = False) -> torch.Tensor:
    """The per-tensor activation scale ``s`` (0-d fp32 on x's device; JAX
    ``layers.py:233-235``): ``a_scale`` where it is positive, else the
    dynamic ``max|x|``, then ``max(eff, 1e-12) / 127``. ``calibrated``
    (a host flag, set once the stored scale is known to be positive)
    takes the stored scale without the reduction; nothing syncs."""
    if calibrated:
        eff = a_scale
    else:
        dyn = x.float().abs().amax()
        eff = torch.where(a_scale > 0, a_scale, dyn)
    return torch.clamp_min(eff, 1e-12) / _const(127.0, eff.device)


def quantize_act_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` (any float type) -> NHWC int8 ``clip(round(x / s), -127,
    127)`` with the channels zero-padded to a multiple of 16."""
    n, h, w, c = x.shape
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    out = torch.zeros((n, h, w, padded_channels(c)), dtype=torch.int8,
                      device=x.device)
    out[..., :c] = q
    return out


def quantize_act(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Quantize an NHWC activation (bf16 or fp32, contiguous) against the
    0-d fp32 scale ``s`` -> (N, H, W, Cp) int8, Cp = C rounded up to 16.
    CUDA: one launch of ``quantize_act_kernel``; CPU: the plain version."""
    if x.device.type == "cpu":
        return quantize_act_plain(x, s)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_act: bf16 or fp32 expected, got "
                         f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"quantize_act: a contiguous NHWC tensor is "
                         f"needed (a channels_last activation's permuted "
                         f"view), got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    _check_scale("quantize_act", s, x.device)
    n, h, w, c = x.shape
    cp = padded_channels(c)
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    if xq.numel() == 0:
        return xq
    rc = _build.library().ptt_quantize_act(
        x.data_ptr(), xq.data_ptr(), s.data_ptr(), n * h * w, c, cp,
        _DTYPE_CODE[x.dtype], x.device.index, _build.stream_of(x))
    _build.check(rc, "quantize_act")
    _build.count_launch(quantize_act, x)
    return xq


quantize_act.launches = 0
quantize_act.by_device = {}


def _check_scale(what: str, s: torch.Tensor, device) -> None:
    if s.dtype != torch.float32 or s.numel() != 1 or s.device != device:
        raise ValueError(f"{what}: the scale must be one fp32 value on "
                         f"{device}, got {s.dtype} {tuple(s.shape)} on "
                         f"{s.device}")


def out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def conv_s8_acc_plain(xq: torch.Tensor, wp: torch.Tensor, k: int,
                      stride: int, padding: int) -> torch.Tensor:
    """The int32 accumulator, (N, Ho, Wo, Cout): an fp64 convolution of
    the int8 values, exact as |acc| <= 127^2 * K < 2^53."""
    cp = xq.shape[-1]
    w = unpack_weight(wp, k, cp).double()
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, None, stride,
                   padding)
    return acc.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def dequantize_plain(acc: torch.Tensor, s: torch.Tensor, w_s: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The epilogue, NHWC: ``(float32(acc) * (s * w_s)).to(cdt) +
    bias.to(cdt)``, each step rounded on its own."""
    y = (acc.float() * (s * w_s)).to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def conv_s8_plain(xq: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
                  w_s: torch.Tensor, bias: Optional[torch.Tensor], k: int,
                  stride: int, padding: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`conv_s8`: the accumulator, then the
    epilogue (``out_dtype`` int32: the accumulator itself)."""
    acc = conv_s8_acc_plain(xq, wp, k, stride, padding)
    if out_dtype == torch.int32:
        return acc
    return dequantize_plain(acc, s, w_s, bias, out_dtype)


def conv_s8(xq: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
            w_s: torch.Tensor, bias: Optional[torch.Tensor], k: int,
            stride: int, padding: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The w8a8 convolution: ``xq`` (N, H, W, Cp) int8, the packed weight
    ``wp`` (Cout, Kp) int8, the activation scale ``s`` (0-d fp32), the
    weight scales ``w_s`` (Cout,) fp32, ``bias`` (Cout,) in ``out_dtype``
    or None, a k x k window (3 or 7) at ``stride`` (1 or 2) over zero
    ``padding`` -> (N, Ho, Wo, Cout) in ``out_dtype`` (bf16, fp32, or
    int32 for the raw accumulator). CUDA: one launch of the kernel of
    :func:`conv_plan`'s plan, counted in ``.launches``, ``.by_device`` and
    ``.by_variant``; CPU: the plain version."""
    return _conv_s8(xq, wp, s, w_s, bias, k, stride, padding, out_dtype,
                    None)


def _conv_s8(xq, wp, s, w_s, bias, k, stride, padding, out_dtype,
             plan: Optional[ConvPlan]) -> torch.Tensor:
    """:func:`conv_s8` under ``plan`` (None: :func:`conv_plan`'s), for the
    card's tests and tools/conv_s8_plans_torch.py."""
    if xq.device.type == "cpu":
        return conv_s8_plain(xq, wp, s, w_s, bias, k, stride, padding,
                             out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"conv_s8: unsupported device {xq.device}")
    dev = xq.device
    if xq.dtype != torch.int8 or xq.dim() != 4 or not xq.is_contiguous():
        raise ValueError(f"conv_s8: xq must be a contiguous (N, H, W, Cp) "
                         f"int8 tensor, got {xq.dtype} {tuple(xq.shape)}")
    n, h, w, cp = xq.shape
    if cp % CP_ALIGN:
        raise ValueError(f"conv_s8: Cp={cp} is not a multiple of "
                         f"{CP_ALIGN}")
    if k not in KERNEL_SIZES or stride not in STRIDES or padding < 0:
        raise ValueError(f"conv_s8: k={k}, stride={stride}, "
                         f"padding={padding} (k in {KERNEL_SIZES}, stride "
                         f"in {STRIDES})")
    kdim = k * k * cp
    kp = -(-kdim // KP_ALIGN) * KP_ALIGN
    if wp.dtype != torch.int8 or wp.dim() != 2 or wp.shape[1] != kp \
            or not wp.is_contiguous() or wp.device != dev:
        raise ValueError(f"conv_s8: the packed weight must be contiguous "
                         f"(Cout, {kp}) int8 on {dev}, got {wp.dtype} "
                         f"{tuple(wp.shape)} on {wp.device}")
    cout = wp.shape[0]
    if cout % 2:
        raise ValueError(f"conv_s8: Cout={cout} must be even")
    if w_s.dtype != torch.float32 or w_s.shape != (cout,) \
            or w_s.device != dev or not w_s.is_contiguous():
        raise ValueError(f"conv_s8: w_s must be ({cout},) fp32 on {dev}")
    _check_scale("conv_s8", s, dev)
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"conv_s8: out_dtype {out_dtype}")
    if bias is not None and (out_dtype == torch.int32
                             or bias.dtype != out_dtype
                             or bias.shape != (cout,) or bias.device != dev
                             or not bias.is_contiguous()):
        raise ValueError(f"conv_s8: bias must be ({cout},) {out_dtype} on "
                         f"{dev}")
    ho, wo = out_size(h, k, stride, padding), out_size(w, k, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"conv_s8: empty output {ho}x{wo}")
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=dev)
    if n == 0:
        return out
    p = plan or conv_plan(cout, kp, out_dtype, k, stride)
    rc = _build.library().ptt_conv_s8(
        xq.data_ptr(), wp.data_ptr(), s.data_ptr(), w_s.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(), n, h, w,
        cp, cout, kp, k, stride, padding, ho, wo, _DTYPE_CODE[out_dtype],
        p.variant, p.bn, p.stages, int(p.resident), dev.index,
        _build.stream_of(xq))
    _build.check(rc, "conv_s8")
    _build.count_launch(conv_s8, xq)
    conv_s8.by_variant[VARIANTS[p.variant]] += 1
    return out


conv_s8.launches = 0
conv_s8.by_device = {}
conv_s8.by_variant = {"gather": 0, "halo": 0}  # launches of each kernel
