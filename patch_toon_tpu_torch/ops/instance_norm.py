"""Fused InstanceNorm + activation over NHWC (kernel B1).

Replaces ``patch_toon_tpu/ops/pallas_norm.py::instance_norm_act``. On a CUDA
tensor :func:`instance_norm_act` launches one of five variants (the head
notes of ``csrc/instance_norm.cu``, ``csrc/instance_norm_resident.cu``,
``csrc/instance_norm_split.cu`` and ``csrc/instance_norm_sample.cu`` say
what bounds them and how they are laid out), as :func:`plan` picks from the
shape, type and alignment:

- the cluster variant (:func:`instance_norm_act_cluster`): one (sample,
  group of G channels) a thread-block cluster of k CTAs, each element read
  from HBM once; the tiles of the tiled program and every training site;
- the resident variant (:func:`instance_norm_act_resident`): one
  cooperative launch whose CTAs, all resident at once, each hold a chunk of
  a unit in shared memory and meet at a grid barrier, for units larger than
  8 CTAs' slices whose chunks fit the whole grid (the planes of a full
  frame but the largest); one read and one write;
- the split variant (:func:`instance_norm_act_split`): the reduction split
  across the CTAs of two launches, for the planes the resident variant
  cannot hold (upsample1's at a full frame); two reads and one write;
- the sample variant (:func:`instance_norm_act_sample`): a whole sample in
  the shared memory of one CTA or a cluster of up to 8, at any C and any
  element-aligned pointer (C times the item size not a multiple of 16
  bytes, or a pointer not 16-byte aligned); one read and one write;
- the streaming variant (:func:`instance_norm_act_streaming`): three reads,
  for what none of them takes (such rows in a sample beyond 8 CTAs).

This is the counterpart of the Pallas wrapper's ``fits_vmem`` shape
dispatch, between two hand-written kernels. On a CPU tensor every wrapper
runs its plain version. A CUDA tensor that a kernel does not take raises:
nothing falls back.

Under autograd, :class:`InstanceNormAct` runs the same forward variants,
which then also write the fp32 mean and rstd, and its backward pass
(:func:`instance_norm_act_backward`) launches one of the two variants of
``csrc/instance_norm_bwd.cu`` or ``csrc/instance_norm_sample.cu``, as
:func:`plan_backward` picks:

- the cluster variant (:func:`instance_norm_act_backward_cluster`): x and
  dy read from HBM once, dx written once;
- the sample variant (:func:`instance_norm_act_backward_sample`): x and dy
  of a whole sample held, dy read through its pixel stride (a channel
  slice of a wider gradient needs no copy), for what the cluster variant
  does not take and a sample fits 8 CTAs;
- the streaming variant (:func:`instance_norm_act_backward_streaming`): x
  and dy read twice, for the rest.

The JAX package has no such kernel: its Pallas kernel serves inference only
and JAX training differentiates the plain ops.

Numerics follow ``patch_toon_tpu/models/layers.py::instance_norm``: fp32
mean and biased variance per (sample, channel) over H x W, eps 1e-5, then
the activation in fp32 and one cast back to the input type, as the Pallas
kernel does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from patch_toon_tpu_torch import _build

ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUPS = (32, 16, 8, 4)       # channels a unit, the largest that fits first
CLUSTER_SIZES = (1, 2, 4, 8)  # the portable cluster sizes
# a CTA's slice of its unit in shared memory, so that two CTAs share an SM
# (csrc/instance_norm.cu kSliceBytes)
CTA_BYTES = 110 * 1024
_MAX_GRID = 2 ** 31 - 1
SMS = 132  # streaming multiprocessors of one H100
# the split variant's CTAs over a whole launch: two an SM, one wave
SPLIT_CTAS = 2 * SMS
# the resident variant's chunk a CTA, one CTA an SM: the 227 KB a block may
# use less 2 KB of static shared memory (csrc/b1_common.cuh kResidentBytes)
RESIDENT_CTA_BYTES = 225 * 1024
# warps of a sample variant's CTA (csrc/b1_common.cuh kWarpsC)
SAMPLE_WARPS = 8


class Plan(NamedTuple):
    """What runs an (N, H, W, C) tensor: the variant; for the cluster
    variant G (channels a unit), k (CTAs a cluster) and a CTA's bytes; for
    the split and resident variants G, a CTA's bytes (its chunk), the
    chunks a unit (CTAs a unit in a launch) and the pixels a chunk; for the
    sample variant k (CTAs a sample, a cluster), a CTA's shared memory,
    chunks = k and the pixels a CTA."""
    variant: str  # "cluster", "resident", "split", "sample", "streaming"
    group: int = 0
    k: int = 0
    cta_bytes: int = 0
    chunks: int = 0
    ppc: int = 0


def _whole_groups(c: int, item: int):
    """The G of ``GROUPS`` that divide C in whole 16-byte vectors, largest
    first."""
    return [g for g in GROUPS if c % g == 0 and (g * item) % 16 == 0]


def cluster_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
                 group: int) -> Optional[Plan]:
    """The cluster variant at G = ``group`` with the least k of
    ``CLUSTER_SIZES`` whose CTAs each hold at most ``CTA_BYTES``, or
    None."""
    item = dtype.itemsize
    for k in CLUSTER_SIZES:
        cta_bytes = -(-h * w // k) * group * item
        if cta_bytes <= CTA_BYTES and n * (c // group) * k <= _MAX_GRID:
            return Plan("cluster", group, k, cta_bytes)
    return None


def split_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
               ctas: int = SPLIT_CTAS) -> Optional[Plan]:
    """The split variant at the largest G that takes C, each unit cut into
    chunks so that a launch has about ``ctas`` CTAs (one wave: the chunks
    stream through registers, nothing is held in shared memory); or None
    when C does not come in whole 16-byte vectors or the grid is too
    large."""
    item = dtype.itemsize
    groups = _whole_groups(c, item)
    if not groups or h * w == 0:
        return None
    group = groups[0]
    hw, units = h * w, n * (c // group)
    chunks = min(hw, -(-ctas // units))
    ppc = -(-hw // chunks)
    chunks = -(-hw // ppc)
    if units * chunks > _MAX_GRID:
        return None
    return Plan("split", group, 0, ppc * group * item, chunks, ppc)


def resident_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
                  sms: int = SMS) -> Optional[Plan]:
    """The resident variant at the largest G that takes C, one CTA an SM:
    each unit cut into as many chunks as ``sms`` CTAs allow (at most one a
    pixel), if a chunk fits ``RESIDENT_CTA_BYTES``; or None when C does not
    come in whole 16-byte vectors or the chunks do not fit (a plane beyond
    about 30 MB on 132 SMs, or more units than SMs)."""
    item = dtype.itemsize
    groups = _whole_groups(c, item)
    if not groups or h * w == 0:
        return None
    group = groups[0]
    hw, units = h * w, n * (c // group)
    chunks = min(hw, sms // units)
    if chunks == 0:
        return None
    ppc = -(-hw // chunks)
    if ppc * group * item > RESIDENT_CTA_BYTES:
        return None
    return Plan("resident", group, 0, ppc * group * item, -(-hw // ppc), ppc)


def _subs(c: int) -> int:
    """Sub-stripes a warp of the sample variant holds: 32 // C groups of C
    lanes for C <= 32, else one (csrc/instance_norm_sample.cu subs_of)."""
    return 32 // c if c <= 32 else 1


def sample_smem(ppc: int, c: int, item: int, backward: bool = False) -> int:
    """A sample variant CTA's shared memory for ``ppc`` pixels of C
    channels of ``item`` bytes (csrc/instance_norm_sample.cu forward_smem,
    backward_smem): the run of x (and of dy) with 16 bytes to align it,
    then fp32 per-warp partials and per-channel sums."""
    def r16(b):
        return -(-b // 16) * 16
    run = r16(ppc * c * item) + 16
    if backward:
        return r16(2 * run + 4 * (2 * SAMPLE_WARPS * c + 6 * c))
    return r16(run + 4 * (SAMPLE_WARPS * c + 4 * c))


def sample_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
                backward: bool = False) -> Optional[Plan]:
    """The sample variant: a whole sample in the shared memory of the least
    k of ``CLUSTER_SIZES`` CTAs (a cluster) whose ``ceil(H*W / k)`` pixels
    of x (the backward pass: of x and dy) fit ``CTA_BYTES`` each; or None.
    It takes any C and any element-aligned pointer."""
    item = dtype.itemsize
    hw = h * w
    if hw == 0 or c == 0:
        return None
    for k in CLUSTER_SIZES:
        ppc = -(-hw // k)
        smem = sample_smem(ppc, c, item, backward)
        if smem <= CTA_BYTES and n * k <= _MAX_GRID:
            return Plan("sample", 0, k, smem, k, ppc)
    return None


def plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
         aligned: bool, sms: int = SMS) -> Plan:
    """C times the item size a multiple of 16 bytes and an aligned data
    pointer (``aligned``): the cluster variant at the largest G of
    ``GROUPS`` that divides C in whole 16-byte vectors, with the least k of
    ``CLUSTER_SIZES`` that keeps a CTA's slice within ``CTA_BYTES``; else
    (a unit larger than 8 CTAs' slices: a full frame's planes) the resident
    variant where the tensor's chunks fit ``sms`` SMs' shared memory
    (:func:`resident_plan`), and the split variant where they do not. No
    smaller G is tried for the cluster variant: at the quarter-resolution
    planes of a full frame, where one fits (G 8 at bf16, 4 at fp32, half of
    each 32-byte sector read), the resident variant is the faster
    (``chip_smoke.py`` times both; ``PERF.md``). Otherwise the sample
    variant where a sample fits 8 CTAs (:func:`sample_plan`), else the
    streaming variant."""
    if dtype not in _DTYPES:
        raise TypeError(f"instance_norm_act: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    item = dtype.itemsize
    if aligned and (c * item) % 16 == 0:
        p = cluster_plan(n, h, w, c, dtype, _whole_groups(c, item)[0]) \
            or resident_plan(n, h, w, c, dtype, sms) \
            or split_plan(n, h, w, c, dtype)
        if p is not None:
            return p
    return sample_plan(n, h, w, c, dtype) or Plan("streaming")


def _sms_of(x: torch.Tensor) -> int:
    """The SMs of a CUDA tensor's card (the resident variant's grid must
    fit them), ``SMS`` for a CPU tensor."""
    if x.device.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def plan_for(x: torch.Tensor) -> Plan:
    """:func:`plan` for an (N, H, W, C) tensor, its data pointer and its
    card's SMs."""
    n, h, w, c = x.shape
    return plan(n, h, w, c, x.dtype, x.data_ptr() % 16 == 0, _sms_of(x))


def plan_backward(n: int, h: int, w: int, c: int, dtype: torch.dtype,
                  aligned: bool) -> Plan:
    """The backward pass's variant. A CTA holds its slice of x and of dy,
    twice the forward's bytes a pixel: ``ceil(H*W/k) * G * itemsize * 2``
    within ``CTA_BYTES``. The cluster variant with the largest G of
    ``GROUPS`` that takes C in whole 16-byte vectors and lets the unit fit
    8 CTAs, then the least k of ``CLUSTER_SIZES``; so the 80x80 sites of a
    training step take G = 32 at bf16 and G = 16 at fp32, both k = 8. Else
    (C times the item size not a multiple of 16 bytes, a pointer of x or dy
    not 16-byte aligned (``aligned`` False), or a unit of even the least G
    larger than 8 CTAs' slices) the sample variant where a sample's x and
    dy fit 8 CTAs (:func:`sample_plan`), else the streaming variant."""
    if dtype not in _DTYPES:
        raise TypeError(f"instance_norm_act_backward: dtype {dtype} not "
                        "supported (float32 or bfloat16)")
    item = dtype.itemsize
    if aligned and (c * item) % 16 == 0:
        for group in GROUPS:
            if c % group or (group * item) % 16:
                continue
            for k in CLUSTER_SIZES:
                cta_bytes = -(-h * w // k) * group * item * 2
                if cta_bytes <= CTA_BYTES and \
                        n * (c // group) * k <= _MAX_GRID:
                    return Plan("cluster", group, k, cta_bytes)
    return sample_plan(n, h, w, c, dtype, backward=True) or \
        Plan("streaming")


def plan_backward_for(x: torch.Tensor, dy: torch.Tensor) -> Plan:
    """:func:`plan_backward` for an (N, H, W, C) x and dy and their data
    pointers."""
    n, h, w, c = x.shape
    return plan_backward(n, h, w, c, x.dtype,
                         x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)


def _activate(y: torch.Tensor, act: Optional[str], slope: float):
    if act == "leaky_relu":
        return torch.where(y >= 0, y, y * slope)
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    return y


def _plain_forward(x: torch.Tensor, act: Optional[str], slope: float,
                   eps: float):
    """-> (y, mean, rstd): two-pass fp32 statistics over dims 1, 2; mean
    and rstd (N, C) fp32."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x32 - mean).mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = _activate((x32 - mean) * rstd, act, slope).to(x.dtype)
    return y, mean[:, 0, 0], rstd[:, 0, 0]


def instance_norm_act_plain(x: torch.Tensor, act: Optional[str] = None,
                            slope: float = 0.2,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: two-pass fp32 statistics over dims 1, 2."""
    return _plain_forward(x, act, slope, eps)[0]


def instance_norm_act_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                                     mean: torch.Tensor, rstd: torch.Tensor,
                                     act: Optional[str] = None,
                                     slope: float = 0.2) -> torch.Tensor:
    """Plain version of the backward kernel: with x^ = (x - mean) * rstd
    and g = dy * act'(x^), dx = rstd * (g - mean(g) - x^ * mean(g * x^))
    over H x W in fp32, in x's type. The derivative at exactly 0 follows
    JAX: LeakyReLU (``jnp.where(x >= 0, ...)``) passes 1, ReLU 0."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    m, r = mean[:, None, None, :], rstd[:, None, None, :]
    xh = (x.float() - m) * r
    g = dy.float()
    if act == "leaky_relu":
        g = torch.where(xh >= 0, g, g * slope)
    elif act == "relu":
        g = torch.where(xh > 0, g, torch.zeros_like(g))
    mg = g.mean(dim=(1, 2), keepdim=True)
    mgx = (g * xh).mean(dim=(1, 2), keepdim=True)
    return (r * (g - mg - xh * mgx)).to(x.dtype)


def _cuda_input(x: torch.Tensor, act: Optional[str]) -> bool:
    """True for a CUDA tensor that a kernel may take, False for a CPU
    tensor; raises for anything else."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm_act wants (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm_act: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("instance_norm_act wants NHWC-contiguous memory")
    return True


def _forward_kernel(x: torch.Tensor, act: Optional[str], slope: float,
                    eps: float, stats: bool):
    """The variant :func:`plan` picks for a CUDA tensor x."""
    variant = plan_for(x).variant if x.numel() else "streaming"
    fn = {"cluster": instance_norm_act_cluster,
          "resident": instance_norm_act_resident,
          "split": instance_norm_act_split,
          "sample": instance_norm_act_sample}.get(
              variant, instance_norm_act_streaming)
    return fn(x, act, slope, eps, stats)


def instance_norm_act(x: torch.Tensor, act: Optional[str] = None,
                      slope: float = 0.2, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm(+activation) of an (N, H, W, C) tensor.

    CUDA: the launch of the variant that :func:`plan` picks; needs fp32 or
    bf16 and NHWC-contiguous memory. CPU: the plain version.
    """
    if not _cuda_input(x, act):
        return instance_norm_act_plain(x, act, slope, eps)
    return _forward_kernel(x, act, slope, eps, False)


def _stats_out(x: torch.Tensor, stats: bool):
    """(mean, rstd) (N, C) fp32 outputs and their pointers, or none."""
    if not stats:
        return None, 0, 0
    n, c = x.shape[0], x.shape[3]
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n, c), dtype=torch.float32, device=x.device)
    return (mean, rstd), mean.data_ptr(), rstd.data_ptr()


def instance_norm_act_cluster(x: torch.Tensor, act: Optional[str] = None,
                              slope: float = 0.2, eps: float = 1e-5,
                              stats: bool = False,
                              p: Optional[Plan] = None):
    """The cluster variant (counted in ``.launches``), at the plan ``p``
    (:func:`cluster_plan`) or :func:`plan`'s; raises for a CUDA tensor that
    :func:`plan` gives to another variant. With ``stats`` -> (y, mean,
    rstd), else y."""
    if not _cuda_input(x, act):
        out = _plain_forward(x, act, slope, eps)
        return out if stats else out[0]
    y = torch.empty_like(x)
    st, mp, rp = _stats_out(x, stats)
    if x.numel() == 0:
        return (y, *st) if stats else y
    p = plan_for(x) if p is None else p
    if p.variant != "cluster" or x.data_ptr() % 16:
        raise ValueError(f"instance_norm_act_cluster does not take "
                         f"{tuple(x.shape)} {x.dtype} at data_ptr % 16 = "
                         f"{x.data_ptr() % 16} (plan {p})")
    n, h, w, c = x.shape
    rc = _build.library().ptt_instance_norm_act_cluster(
        x.data_ptr(), y.data_ptr(), mp, rp, n, h * w, c, p.group, p.k,
        _DTYPES[x.dtype], ACTS[act], slope, eps, x.device.index,
        _build.stream_of(x))
    _build.check(rc, "instance_norm_act_cluster")
    _build.count_launch(instance_norm_act_cluster, x)
    return (y, *st) if stats else y


def instance_norm_act_streaming(x: torch.Tensor, act: Optional[str] = None,
                                slope: float = 0.2, eps: float = 1e-5,
                                stats: bool = False):
    """The streaming variant (counted in ``.launches``); takes any
    NHWC-contiguous fp32 or bf16 tensor. With ``stats`` -> (y, mean,
    rstd), else y."""
    if not _cuda_input(x, act):
        out = _plain_forward(x, act, slope, eps)
        return out if stats else out[0]
    y = torch.empty_like(x)
    st, mp, rp = _stats_out(x, stats)
    if x.numel() == 0:
        return (y, *st) if stats else y
    n, h, w, c = x.shape
    rc = _build.library().ptt_instance_norm_act_streaming(
        x.data_ptr(), y.data_ptr(), mp, rp, n, h * w, c, _DTYPES[x.dtype],
        ACTS[act], slope, eps, x.device.index, _build.stream_of(x))
    _build.check(rc, "instance_norm_act_streaming")
    _build.count_launch(instance_norm_act_streaming, x)
    return (y, *st) if stats else y


def _stripe_sums(v: torch.Tensor, p: Plan) -> torch.Tensor:
    """Per (sample, channel) sums of v (N, H*W, C) fp32 in the sample
    variant's order: each CTA's ``p.ppc`` pixels cut into S = 8 warps x
    ``_subs(C)`` stripes (stripe s = warp * subs + sub: pixels s, s + S,
    ...), each stripe summed, a warp's sub-stripes added in order, then the
    8 warps in order, then the CTAs' sums in rank order. -> (N, C)."""
    n, hw, c = v.shape
    k, ppc, subs = p.k, p.ppc, _subs(c)
    stripes = SAMPLE_WARPS * subs
    rows = -(-ppc // stripes)
    buf = v.new_zeros((n, k, rows * stripes, c))
    for r in range(k):
        lo = min(hw, r * ppc)
        hi = min(hw, lo + ppc)
        buf[:, r, :hi - lo] = v[:, lo:hi]
    part = buf.view(n, k, rows, SAMPLE_WARPS, subs, c).sum(dim=2)
    warps = part[:, :, :, 0]                 # (n, k, warps, c)
    for j in range(1, subs):
        warps = warps + part[:, :, :, j]
    ctas = warps[:, :, 0]                    # (n, k, c)
    for w in range(1, SAMPLE_WARPS):
        ctas = ctas + warps[:, :, w]
    tot = ctas[:, 0]
    for r in range(1, k):
        tot = tot + ctas[:, r]
    return tot


def _sample_forward_plain(x: torch.Tensor, act: Optional[str], slope: float,
                          eps: float, p: Plan):
    """The sample variant's arithmetic in plain PyTorch: the fp32 mean and
    sum of squared deviations by :func:`_stripe_sums` at the plan's
    CTAs, rstd = 1 / sqrt(var + eps) -> (y, mean, rstd) as
    :func:`_plain_forward`."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    n, h, w, c = x.shape
    hw = h * w
    x32 = x.float().reshape(n, hw, c)
    mean = _stripe_sums(x32, p) / hw
    var = _stripe_sums(torch.square(x32 - mean[:, None]), p) / hw
    rstd = 1.0 / torch.sqrt(var + eps)
    y = _activate((x32 - mean[:, None]) * rstd[:, None], act, slope)
    return y.reshape(x.shape).to(x.dtype), mean, rstd


def _cpu_sample_plan(x: torch.Tensor, p: Optional[Plan],
                     backward: bool = False) -> Plan:
    """The plan a CPU tensor's sample wrapper repeats: ``p``, else
    :func:`sample_plan`'s, else one CTA a sample."""
    n, h, w, c = x.shape
    return p or sample_plan(n, h, w, c, x.dtype, backward) \
        or Plan("sample", k=1, chunks=1, ppc=max(1, h * w))


def instance_norm_act_sample(x: torch.Tensor, act: Optional[str] = None,
                             slope: float = 0.2, eps: float = 1e-5,
                             stats: bool = False, p: Optional[Plan] = None):
    """The sample variant (counted in ``.launches``), at the plan ``p``
    (:func:`sample_plan`) or :func:`plan`'s; raises for a CUDA tensor that
    :func:`plan` gives to another variant, and (from the kernel's entry)
    for a plan whose CTAs cannot hold their pixels. CPU: its arithmetic in
    plain PyTorch (:func:`_sample_forward_plain`). With ``stats`` -> (y,
    mean, rstd), else y."""
    if not _cuda_input(x, act):
        out = _sample_forward_plain(x, act, slope, eps,
                                    _cpu_sample_plan(x, p))
        return out if stats else out[0]
    y = torch.empty_like(x)
    st, mp, rp = _stats_out(x, stats)
    if x.numel() == 0:
        return (y, *st) if stats else y
    p = plan_for(x) if p is None else p
    if p.variant != "sample":
        raise ValueError(f"instance_norm_act_sample does not take "
                         f"{tuple(x.shape)} {x.dtype} (plan {p})")
    n, h, w, c = x.shape
    rc = _build.library().ptt_instance_norm_act_sample(
        x.data_ptr(), y.data_ptr(), mp, rp, n, h * w, c, p.k,
        _DTYPES[x.dtype], ACTS[act], slope, eps, x.device.index,
        _build.stream_of(x))
    _build.check(rc, "instance_norm_act_sample")
    _build.count_launch(instance_norm_act_sample, x)
    return (y, *st) if stats else y


def _split_forward_plain(x: torch.Tensor, act: Optional[str], slope: float,
                         eps: float, p: Plan):
    """The split variant's arithmetic in plain PyTorch: per chunk of
    ``p.ppc`` pixels an fp32 mean and sum of squared deviations, combined
    in chunk order with Chan's formula in fp64, then fp32 mean and
    rstd -> (y, mean, rstd) as :func:`_plain_forward`."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    n, h, w, c = x.shape
    hw, ppc = h * w, p.ppc
    x32 = x.float().reshape(n, hw, c)
    means, m2s, counts = [], [], []
    for p0 in range(0, hw, ppc):
        xs = x32[:, p0:p0 + ppc]
        m = xs.mean(dim=1)
        means.append(m)
        m2s.append(torch.square(xs - m[:, None]).sum(dim=1))
        counts.append(xs.shape[1])
    m_s = torch.stack(means, 1).double()   # (n, chunks, c)
    m2_s = torch.stack(m2s, 1).double()
    n_s = torch.tensor(counts, dtype=torch.float64)[None, :, None]
    mean = (n_s * m_s).sum(dim=1) / hw
    m2 = m2_s.sum(dim=1) + (n_s * torch.square(m_s - mean[:, None])).sum(dim=1)
    mean = mean.float()
    rstd = torch.rsqrt((m2 / hw).float() + eps)
    y = _activate((x32 - mean[:, None]) * rstd[:, None], act, slope)
    return y.reshape(x.shape).to(x.dtype), mean, rstd


def _resident_forward_plain(x: torch.Tensor, act: Optional[str],
                            slope: float, eps: float, p: Plan):
    """The resident variant's arithmetic in plain PyTorch, at its chunks of
    ``p.ppc`` pixels: each chunk's fp32 mean, then its sum of squared
    deviations from that mean (the kernel's two passes over shared
    memory), then the fixed-order fp64 combine. It is the split variant's
    plain arithmetic (:func:`_split_forward_plain`), whose kernel takes a
    chunk's statistics by Welford's update instead."""
    return _split_forward_plain(x, act, slope, eps, p)


def instance_norm_act_resident(x: torch.Tensor, act: Optional[str] = None,
                               slope: float = 0.2, eps: float = 1e-5,
                               stats: bool = False,
                               p: Optional[Plan] = None):
    """The resident variant, one cooperative launch counted in
    ``.launches``, at the plan ``p`` (:func:`resident_plan`) or
    :func:`plan`'s; raises for a CUDA tensor that :func:`plan` gives to
    another variant, and (from the kernel's entry) for a plan whose grid
    cannot be resident on the card at once. CPU: its arithmetic in plain
    PyTorch (:func:`_resident_forward_plain`). With ``stats`` -> (y, mean,
    rstd), else y."""
    if not _cuda_input(x, act):
        n, h, w, c = x.shape
        q = p or resident_plan(n, h, w, c, x.dtype) \
            or Plan("resident", ppc=max(1, h * w))
        out = _resident_forward_plain(x, act, slope, eps, q)
        return out if stats else out[0]
    y = torch.empty_like(x)
    st, mp, rp = _stats_out(x, stats)
    if x.numel() == 0:
        return (y, *st) if stats else y
    p = plan_for(x) if p is None else p
    if p.variant != "resident" or x.data_ptr() % 16:
        raise ValueError(f"instance_norm_act_resident does not take "
                         f"{tuple(x.shape)} {x.dtype} at data_ptr % 16 = "
                         f"{x.data_ptr() % 16} (plan {p})")
    n, h, w, c = x.shape
    part = torch.empty(2 * n * c * -(-p.chunks // 4) * 4,
                       dtype=torch.float32, device=x.device)
    rc = _build.library().ptt_instance_norm_act_resident(
        x.data_ptr(), y.data_ptr(), mp, rp, part.data_ptr(), n, h * w, c,
        p.group, p.ppc, p.chunks, _DTYPES[x.dtype], ACTS[act], slope, eps,
        x.device.index, _build.stream_of(x))
    _build.check(rc, "instance_norm_act_resident")
    _build.count_launch(instance_norm_act_resident, x)
    return (y, *st) if stats else y


# zeroed counters of the split variant a (device, stream), left zero by
# every launch, grown as units require
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _split_counters(x: torch.Tensor, units: int) -> torch.Tensor:
    key = (x.device.index, _build.stream_of(x))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < units:
        buf = _COUNTERS[key] = torch.zeros(max(units, 1024),
                                           dtype=torch.int32, device=x.device)
    return buf


def instance_norm_act_split(x: torch.Tensor, act: Optional[str] = None,
                            slope: float = 0.2, eps: float = 1e-5,
                            stats: bool = False, p: Optional[Plan] = None):
    """The split variant, two launches counted once in ``.launches``, at
    the plan ``p`` (:func:`split_plan`) or :func:`plan`'s; raises for a
    CUDA tensor that :func:`plan` gives to another variant. CPU: its
    arithmetic in plain PyTorch (:func:`_split_forward_plain`). With
    ``stats`` -> (y, mean, rstd), else y."""
    if not _cuda_input(x, act):
        n, h, w, c = x.shape
        q = p or split_plan(n, h, w, c, x.dtype) \
            or Plan("split", ppc=max(1, h * w))
        out = _split_forward_plain(x, act, slope, eps, q)
        return out if stats else out[0]
    y = torch.empty_like(x)
    n, h, w, c = x.shape
    if x.numel() == 0:
        st = _stats_out(x, True)[0]
        return (y, *st) if stats else y
    p = plan_for(x) if p is None else p
    if p.variant != "split" or x.data_ptr() % 16:
        raise ValueError(f"instance_norm_act_split does not take "
                         f"{tuple(x.shape)} {x.dtype} at data_ptr % 16 = "
                         f"{x.data_ptr() % 16} (plan {p})")
    units = n * (c // p.group)
    ws = torch.empty(2 * n * c * (1 + -(-p.chunks // 4) * 4),
                     dtype=torch.float32, device=x.device)
    mean, rstd = ws[:n * c].view(n, c), ws[n * c:2 * n * c].view(n, c)
    counters = _split_counters(x, units)
    rc = _build.library().ptt_instance_norm_act_split(
        x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        ws[2 * n * c:].data_ptr(), counters.data_ptr(), n, h * w, c, p.group,
        p.ppc, p.chunks, _DTYPES[x.dtype], ACTS[act], slope, eps,
        x.device.index, _build.stream_of(x))
    _build.check(rc, "instance_norm_act_split")
    _build.count_launch(instance_norm_act_split, x)
    return (y, mean, rstd) if stats else y


def pixel_strides(t: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(pixel stride, sample stride) in elements of an (N, H, W, C) tensor
    whose pixels are rows of C contiguous elements at one pixel stride, as
    NHWC-contiguous memory or a channel slice of a wider NHWC tensor (the
    gather's gradient under tensor parallelism) has them; else None."""
    n, h, w, c = t.shape
    sn, sh, sw, sc = t.stride()
    if c > 1 and sc != 1:
        return None
    ps = sw if w > 1 else (sh if h > 1 else c)
    if ps < c or (h > 1 and sh != w * ps):
        return None
    return ps, (sn if n > 1 else h * w * ps)


def _backward_input(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, act: Optional[str],
                    strided: bool = False) -> bool:
    """:func:`_cuda_input` for the backward pass, which also checks dy
    (NHWC-contiguous, or with ``strided`` rows of C elements at a pixel
    stride: :func:`pixel_strides`) and the statistics of a CUDA x."""
    if not _cuda_input(x, act):
        return False
    n, h, w, c = x.shape
    layout = pixel_strides(dy) is not None if strided and dy.dim() == 4 \
        else dy.is_contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not layout:
        raise ValueError(f"instance_norm_act_backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} must match x {tuple(x.shape)} "
                         f"{x.dtype}, "
                         + ("rows of C elements at a pixel stride"
                            if strided else "NHWC-contiguous")
                         + f" on {x.device}")
    for t in (mean, rstd):
        if t.shape != (n, c) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError("instance_norm_act_backward: mean and rstd must "
                             f"be contiguous ({n}, {c}) float32 on {x.device}")
    return True


def instance_norm_act_backward(x: torch.Tensor, dy: torch.Tensor,
                               mean: torch.Tensor, rstd: torch.Tensor,
                               act: Optional[str] = None,
                               slope: float = 0.2) -> torch.Tensor:
    """dx of InstanceNorm(+activation) from the forward pass's input, the
    output gradient and the (N, C) fp32 statistics. CUDA: one launch of the
    variant that :func:`plan_backward` picks; dx in x's type,
    NHWC-contiguous; dy NHWC-contiguous, or read through its pixel stride
    where the plan gives the sample variant (the others raise for it). CPU:
    the plain version."""
    if not _backward_input(x, dy, mean, rstd, act, strided=True):
        return instance_norm_act_backward_plain(x, dy, mean, rstd, act, slope)
    variant = plan_backward_for(x, dy).variant if x.numel() else "streaming"
    fn = {"cluster": instance_norm_act_backward_cluster,
          "sample": instance_norm_act_backward_sample}.get(
              variant, instance_norm_act_backward_streaming)
    return fn(x, dy, mean, rstd, act, slope)


def instance_norm_act_backward_cluster(x: torch.Tensor, dy: torch.Tensor,
                                       mean: torch.Tensor, rstd: torch.Tensor,
                                       act: Optional[str] = None,
                                       slope: float = 0.2) -> torch.Tensor:
    """The backward cluster variant (counted in ``.launches``); raises for a
    CUDA tensor that :func:`plan_backward` gives to the streaming
    variant."""
    if not _backward_input(x, dy, mean, rstd, act):
        return instance_norm_act_backward_plain(x, dy, mean, rstd, act, slope)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    p = plan_backward_for(x, dy)
    if p.variant != "cluster":
        raise ValueError(
            f"instance_norm_act_backward_cluster does not take "
            f"{tuple(x.shape)} {x.dtype} at data_ptr % 16 = "
            f"{x.data_ptr() % 16}, {dy.data_ptr() % 16} (the streaming "
            "variant does)")
    n, h, w, c = x.shape
    rc = _build.library().ptt_instance_norm_act_backward_cluster(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), n, h * w, c, p.group, p.k, _DTYPES[x.dtype],
        ACTS[act], slope, x.device.index, _build.stream_of(x))
    _build.check(rc, "instance_norm_act_backward_cluster")
    _build.count_launch(instance_norm_act_backward_cluster, x)
    return dx


def _sample_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                           mean: torch.Tensor, rstd: torch.Tensor,
                           act: Optional[str], slope: float,
                           p: Plan) -> torch.Tensor:
    """The backward sample variant's arithmetic in plain PyTorch: the sums
    of g and g * x^ by :func:`_stripe_sums` at the plan's CTAs, then dx
    as :func:`instance_norm_act_backward_plain`."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    n, h, w, c = x.shape
    hw = h * w
    m, r = mean[:, None, :], rstd[:, None, :]
    xh = (x.float().reshape(n, hw, c) - m) * r
    g = dy.float().reshape(n, hw, c)
    if act == "leaky_relu":
        g = torch.where(xh >= 0, g, g * slope)
    elif act == "relu":
        g = torch.where(xh > 0, g, torch.zeros_like(g))
    mg = _stripe_sums(g, p) / hw
    mgx = _stripe_sums(g * xh, p) / hw
    dx = r * (g - mg[:, None] - xh * mgx[:, None])
    return dx.reshape(x.shape).to(x.dtype)


def instance_norm_act_backward_sample(x: torch.Tensor, dy: torch.Tensor,
                                      mean: torch.Tensor, rstd: torch.Tensor,
                                      act: Optional[str] = None,
                                      slope: float = 0.2,
                                      p: Optional[Plan] = None
                                      ) -> torch.Tensor:
    """The backward sample variant (counted in ``.launches``), at the plan
    ``p`` (:func:`sample_plan` with ``backward``) or
    :func:`plan_backward`'s; dy NHWC-contiguous or rows of C elements at a
    pixel stride (:func:`pixel_strides`), read as they lie. Raises for a
    CUDA tensor that :func:`plan_backward` gives to another variant, and
    (from the kernel's entry) for a plan whose CTAs cannot hold their
    pixels. CPU: its arithmetic in plain PyTorch
    (:func:`_sample_backward_plain`)."""
    if not _backward_input(x, dy, mean, rstd, act, strided=True):
        return _sample_backward_plain(x, dy, mean, rstd, act, slope,
                                      _cpu_sample_plan(x, p, True))
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    p = plan_backward_for(x, dy) if p is None else p
    if p.variant != "sample":
        raise ValueError(f"instance_norm_act_backward_sample does not take "
                         f"{tuple(x.shape)} {x.dtype} (plan {p})")
    n, h, w, c = x.shape
    ps, ns = pixel_strides(dy)
    rc = _build.library().ptt_instance_norm_act_backward_sample(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), n, h * w, c, ps, ns, p.k, _DTYPES[x.dtype], ACTS[act],
        slope, x.device.index, _build.stream_of(x))
    _build.check(rc, "instance_norm_act_backward_sample")
    _build.count_launch(instance_norm_act_backward_sample, x)
    return dx


def instance_norm_act_backward_streaming(x: torch.Tensor, dy: torch.Tensor,
                                         mean: torch.Tensor,
                                         rstd: torch.Tensor,
                                         act: Optional[str] = None,
                                         slope: float = 0.2) -> torch.Tensor:
    """The backward streaming variant (counted in ``.launches``); takes any
    NHWC-contiguous fp32 or bf16 x and dy."""
    if not _backward_input(x, dy, mean, rstd, act):
        return instance_norm_act_backward_plain(x, dy, mean, rstd, act, slope)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    n, h, w, c = x.shape
    rc = _build.library().ptt_instance_norm_act_backward_streaming(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), n, h * w, c, _DTYPES[x.dtype], ACTS[act], slope,
        x.device.index, _build.stream_of(x))
    _build.check(rc, "instance_norm_act_backward_streaming")
    _build.count_launch(instance_norm_act_backward_streaming, x)
    return dx


instance_norm_act_cluster.launches = 0
instance_norm_act_cluster.by_device = {}
instance_norm_act_split.launches = 0
instance_norm_act_split.by_device = {}
instance_norm_act_resident.launches = 0
instance_norm_act_resident.by_device = {}
instance_norm_act_streaming.launches = 0
instance_norm_act_streaming.by_device = {}
instance_norm_act_sample.launches = 0
instance_norm_act_sample.by_device = {}
instance_norm_act_backward_cluster.launches = 0
instance_norm_act_backward_cluster.by_device = {}
instance_norm_act_backward_streaming.launches = 0
instance_norm_act_backward_streaming.by_device = {}
instance_norm_act_backward_sample.launches = 0
instance_norm_act_backward_sample.by_device = {}


class InstanceNormAct(torch.autograd.Function):
    """B1 under autograd. Forward: the variant :func:`plan` picks, writing
    the fp32 mean and rstd as well (CPU: the plain version). Backward:
    :func:`instance_norm_act_backward`, the variant :func:`plan_backward`
    picks (CPU: its plain version). Under tensor parallelism the gather's
    backward hands B1 a strided channel slice of the gathered gradient:
    where the plan gives it to the sample variant, which reads dy through
    its pixel stride, dy goes as it is; otherwise dy is made
    NHWC-contiguous in x's type first, and ``dy_copies`` counts the
    backward passes that needed that copy."""

    dy_copies = 0

    @staticmethod
    def forward(ctx, x, act, slope, eps):
        if not _cuda_input(x, act):
            y, mean, rstd = _plain_forward(x, act, slope, eps)
        else:
            y, mean, rstd = _forward_kernel(x, act, slope, eps, True)
        ctx.save_for_backward(x, mean, rstd)
        ctx.act, ctx.slope = act, slope
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd = ctx.saved_tensors
        if dy.dtype != x.dtype or not (dy.is_contiguous()
                                       or _reads_strided(x, dy)):
            InstanceNormAct.dy_copies += 1
            dy = dy.to(x.dtype).contiguous()
        dx = instance_norm_act_backward(x, dy, mean, rstd, ctx.act,
                                        ctx.slope)
        return dx, None, None, None


def _reads_strided(x: torch.Tensor, dy: torch.Tensor) -> bool:
    """True where the backward pass takes this strided dy as it lies: rows
    of C elements at a pixel stride that :func:`plan_backward` gives to the
    sample variant."""
    return x.numel() > 0 and pixel_strides(dy) is not None and \
        plan_backward_for(x, dy).variant == "sample"


def instance_norm_act_autograd(x: torch.Tensor, act: Optional[str] = None,
                               slope: float = 0.2,
                               eps: float = 1e-5) -> torch.Tensor:
    """:func:`instance_norm_act`, differentiable: through
    :class:`InstanceNormAct` when autograd records (grad mode on and x
    requires grad), else the inference launch that writes no
    statistics."""
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormAct.apply(x, act, slope, eps)
    return instance_norm_act(x, act, slope, eps)
