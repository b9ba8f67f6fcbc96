"""The CUDA kernels of the port against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets JAX up.) Tolerances:
InstanceNorm fp32 1e-5 absolute and relative (sums in other orders); bf16
one bf16 ulp of the value plus 1e-5, as two fp32 results that differ in the
last bits may round to neighbouring bf16 values; the blend and the splat
bit for bit; the int8 kernels (activation quantization, the w8a8
convolution's accumulator and output) bit for bit. The tests of the last
section need two cards (they skip with one): every kernel
entry keeps the caller's current device, the engine names its cards
(replicas, copy streams, a sharded group's outputs bitwise the one-card
dispatch, the flow graph on its frame's card), and tensor parallelism's
site kernels: each card launches B1 on its channel slices (rank r of a
model group of 2 on card r, ``parallel/tp.py::TurnGroup``), and the
gathered outputs hold to the one-card forward (fp32 1e-4, bf16 1/32
absolute, on the tanh output and D's logits).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.ops import blend as tblend  # noqa: E402
from patch_toon_tpu_torch.ops import quant as tquant  # noqa: E402
from patch_toon_tpu_torch.ops import splat as tsplat  # noqa: E402
from patch_toon_tpu_torch import _build  # noqa: E402
from patch_toon_tpu_torch.ops.instance_norm import (  # noqa: E402
    CTA_BYTES,
    RESIDENT_CTA_BYTES,
    InstanceNormAct,
    Plan,
    _sample_backward_plain,
    _sample_forward_plain,
    instance_norm_act,
    instance_norm_act_backward,
    instance_norm_act_backward_cluster,
    instance_norm_act_backward_plain,
    instance_norm_act_backward_sample,
    instance_norm_act_backward_streaming,
    instance_norm_act_cluster,
    instance_norm_act_plain,
    instance_norm_act_resident,
    instance_norm_act_sample,
    instance_norm_act_split,
    instance_norm_act_streaming,
    plan_backward_for,
    plan_for,
    resident_plan,
    sample_plan,
    sample_smem,
    split_plan,
)

ACTS = [None, "relu", "leaky_relu"]
VARIANTS = {"cluster": instance_norm_act_cluster,
            "streaming": instance_norm_act_streaming}
# the distinct InstanceNorm site shapes of one generator call; with fp32 and
# bf16 they give clusters of k = 1, 2, 4 and 8
MAIN_PATH_SHAPES = [(80, 80, 32), (40, 40, 64), (20, 20, 128),
                    (40, 40, 128), (80, 80, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_bf16_close(got, want):
    tol = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-5
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"{bad.sum()} values beyond one bf16 ulp, max |d| "
        f"{np.abs(got - want).max()}")


def _blend_case(seed, B, ps, H, W):
    rng = np.random.default_rng(seed)
    gen = rng.random((B, ps, ps, 3)).astype(np.float32)
    wts = rng.random((B, ps, ps)).astype(np.float32)
    pos = np.stack([rng.integers(0, H - ps, B),
                    rng.integers(0, W - ps, B)], 1).astype(np.int32)
    wts[-2:] = 0
    pos[-2:] = -10000
    return gen, wts, pos, H, W



def _randn(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, device=device, generator=g) * 3 + 1).to(dtype)


def _assert_in_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _assert_bf16_close(got.float().cpu().numpy(),
                           want.float().cpu().numpy())


def _check_variant(x, act, variant):
    """One launch of ``variant``, counted once, against the plain version."""
    fn = VARIANTS[variant]
    before = {k: f.launches for k, f in VARIANTS.items()}
    got = fn(x, act)
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in VARIANTS.items()}
    assert after == {k: v + (k == variant) for k, v in before.items()}
    _assert_in_close(got, instance_norm_act_plain(x, act), x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 20, 20, 128), (3, 9, 7, 40)])
def test_instance_norm_kernel_matches_plain(cuda, act, dtype, shape):
    """The dispatching wrapper: one launch of the variant that the plan
    names (the cluster one here: G = 32 and G = 8)."""
    x = _randn(shape, dtype, cuda)
    variant = plan_for(x).variant
    assert variant == "cluster"
    before = VARIANTS[variant].launches
    got = instance_norm_act(x, act)
    torch.cuda.synchronize()
    assert VARIANTS[variant].launches == before + 1
    _assert_in_close(got, instance_norm_act_plain(x, act), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hwc", MAIN_PATH_SHAPES)
def test_instance_norm_variants_match_plain_at_main_path_shapes(
        cuda, act, dtype, hwc):
    x = _randn((3,) + hwc, dtype, cuda, seed=1)
    assert plan_for(x).variant == "cluster"
    for variant in VARIANTS:
        _check_variant(x, act, variant)


@pytest.mark.cuda
def test_instance_norm_cluster_sizes_one_to_eight_are_exercised(cuda):
    ks = {(dtype, plan_for(torch.empty((3,) + hwc, dtype=dtype,
                                       device=cuda)).k)
          for dtype in (torch.float32, torch.bfloat16)
          for hwc in MAIN_PATH_SHAPES}
    assert {k for _, k in ks} == {1, 2, 4, 8}
    assert _build.library().ptt_instance_norm_slice_bytes() == CTA_BYTES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [
    ((1, 80, 80, 32), {"float32": 8, "bfloat16": 4}),  # N = 1
    ((2, 79, 81, 32), {"float32": 8, "bfloat16": 4}),  # 6399 pixels, ragged
    ((2, 45, 45, 64), {"float32": 4, "bfloat16": 2}),  # 2025 pixels, ragged
    ((1, 3, 5, 128), {"float32": 1, "bfloat16": 1}),   # a few pixels
])
def test_instance_norm_cluster_variant_at_odd_sizes(cuda, dtype, shape, k):
    x = _randn(shape, dtype, cuda, seed=2)
    p = plan_for(x)
    assert p.variant == "cluster" and p.k == k[str(dtype).split(".")[1]]
    for act in ACTS:
        _check_variant(x, act, "cluster")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_streaming_dispatch(cuda, dtype):
    """What the cluster variant does not take goes to the split variant (a
    full frame's plane), to the sample variant (unaligned, or C = 12 at
    bf16, where a sample fits 8 CTAs) or to the streaming one (unaligned
    beyond 8 CTAs); the cluster wrapper refuses them all."""
    full = _randn((1, 540, 960, 128), dtype, cuda, seed=3)  # a full frame
    assert plan_for(full).variant == "split"
    before = instance_norm_act_split.launches
    got = instance_norm_act(full, "relu")
    torch.cuda.synchronize()
    assert instance_norm_act_split.launches == before + 1
    _assert_in_close(got, instance_norm_act_plain(full, "relu"), dtype)
    with pytest.raises(ValueError):
        instance_norm_act_cluster(full, "relu")
    base = _randn((2 * 20 * 20 * 32 + 1,), dtype, cuda, seed=4)
    misaligned = base[1:].view(2, 20, 20, 32)
    odd = _randn((2, 20, 20, 12), dtype, cuda, seed=5)  # C = 12
    big = _randn((540 * 960 * 128 + 1,), dtype, cuda, seed=6)[1:].view(
        1, 540, 960, 128)
    cases = [(misaligned, "sample"), (big, "streaming")] + (
        [(odd, "sample")] if dtype == torch.bfloat16 else [])
    for x, variant in cases:
        assert plan_for(x).variant == variant, tuple(x.shape)
        fn = {"sample": instance_norm_act_sample,
              "streaming": instance_norm_act_streaming}[variant]
        before = fn.launches
        got = instance_norm_act(x, "relu")
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_in_close(got, instance_norm_act_plain(x, "relu"), dtype)
        with pytest.raises(ValueError):
            instance_norm_act_cluster(x, "relu")
    if dtype == torch.float32:  # 48 bytes a pixel: clusters of G = 4
        assert plan_for(odd).group == 4
        _check_variant(odd, "leaky_relu", "cluster")


# the distinct InstanceNorm sites of a full-frame pass over a 512x910 frame
# (padded to 512x912), with their activations
FULLFRAME_SITES = [((512, 912, 32), "leaky_relu"),
                   ((256, 456, 64), "leaky_relu"),
                   ((128, 228, 128), "leaky_relu"), ((128, 228, 128), "relu"),
                   ((128, 228, 128), None), ((256, 456, 128), "relu"),
                   ((512, 912, 128), "relu")]


FULL_FRAME_VARIANTS = dict(VARIANTS, split=instance_norm_act_split,
                           resident=instance_norm_act_resident)
# the variant the plan picks at each distinct full-frame site: the resident
# one where the plane's chunks fit 132 SMs' shared memory
FULLFRAME_PICK = {
    torch.bfloat16: {(512, 912, 32): "resident", (256, 456, 64): "resident",
                     (128, 228, 128): "resident",
                     (256, 456, 128): "resident", (512, 912, 128): "split"},
    torch.float32: {(512, 912, 32): "split", (256, 456, 64): "resident",
                    (128, 228, 128): "resident", (256, 456, 128): "split",
                    (512, 912, 128): "split"},
}


def _check_fullframe_variant(x, act, variant, **kw):
    """One launch of ``variant`` with its statistics, counted once, against
    the plain version and its statistics, and bitwise equal to a second
    call."""
    fn = FULL_FRAME_VARIANTS[variant]
    before = {k: f.launches for k, f in FULL_FRAME_VARIANTS.items()}
    y, mean, rstd = fn(x, act, stats=True, **kw)
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in FULL_FRAME_VARIANTS.items()}
    assert after == {k: v + (k == variant) for k, v in before.items()}
    _assert_in_close(y, instance_norm_act_plain(x, act), x.dtype)
    want_mean, want_rstd = _stats(x)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=1e-6)
    assert torch.equal(y, fn(x, act, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hwc,act", FULLFRAME_SITES)
def test_instance_norm_split_matches_plain_at_fullframe_shapes(cuda, dtype,
                                                                hwc, act):
    """The split variant at every full-frame site (at ``split_plan``'s plan
    where the plan picks the resident variant) against the plain version
    (one launch counted), its statistics against the plain version's, and
    bitwise equal to a second call (the combine runs in a fixed order
    whichever CTA finishes last)."""
    x = _randn((1,) + hwc, dtype, cuda, seed=12)
    assert plan_for(x).variant == FULLFRAME_PICK[dtype][hwc]
    _check_fullframe_variant(x, act, "split", p=split_plan(1, *hwc, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hwc,act", FULLFRAME_SITES)
def test_instance_norm_resident_matches_plain_at_fullframe_shapes(
        cuda, dtype, hwc, act):
    """The resident variant at every full-frame site the plan gives it,
    through the dispatching wrapper and alone: one launch counted, within
    the plain version's tolerance, its statistics within 1e-5, two calls
    bitwise equal (every CTA combines its unit's partials in one fixed
    order). At the sites it does not take, its wrapper raises."""
    x = _randn((1,) + hwc, dtype, cuda, seed=12)
    if FULLFRAME_PICK[dtype][hwc] != "resident":
        assert resident_plan(1, *hwc, dtype) is None
        with pytest.raises(ValueError):
            instance_norm_act_resident(x, act)
        return
    p = plan_for(x)
    assert p.variant == "resident"
    assert p.cta_bytes <= RESIDENT_CTA_BYTES
    before = instance_norm_act_resident.launches
    got = instance_norm_act(x, act)
    torch.cuda.synchronize()
    assert instance_norm_act_resident.launches == before + 1
    _assert_in_close(got, instance_norm_act_plain(x, act), dtype)
    _check_fullframe_variant(x, act, "resident")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 79, 81, 32),   # ragged chunks, two samples
    (3, 9, 7, 40),     # G = 8, units of a few pixels
    (1, 3, 5, 128),    # more CTAs than pixels allow: a pixel a chunk
    (1, 300, 301, 64),  # ragged, two units
])
def test_instance_norm_resident_variant_at_odd_sizes(cuda, dtype, shape):
    """The resident variant on aligned tensors at the plan
    ``resident_plan`` gives them (which ``plan`` would give the cluster
    variant), against the plain version and its statistics, bitwise
    repeatable; then at a forced plan of one CTA a unit."""
    x = _randn(shape, dtype, cuda, seed=14)
    p = resident_plan(*shape, dtype)
    assert p is not None and p.variant == "resident"
    for act in ACTS:
        _check_fullframe_variant(x, act, "resident", p=p)
    hw = shape[1] * shape[2]
    if hw * p.group * dtype.itemsize <= RESIDENT_CTA_BYTES:
        one = p._replace(chunks=1, ppc=hw,
                         cta_bytes=hw * p.group * dtype.itemsize)
        _check_fullframe_variant(x, "relu", "resident", p=one)


@pytest.mark.cuda
def test_instance_norm_resident_variant_refuses_what_it_cannot_hold(cuda):
    """A chunk beyond the budget, a grid that cannot be resident at once,
    another variant's plan and an unaligned tensor raise: nothing falls
    back, and nothing is counted."""
    lib = _build.library()
    assert lib.ptt_instance_norm_resident_bytes() == RESIDENT_CTA_BYTES
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    x = _randn((1, 512, 912, 32), torch.bfloat16, cuda, seed=15)
    p = plan_for(x)
    assert p.variant == "resident" and p.chunks == sms
    before = instance_norm_act_resident.launches
    too_big = p._replace(chunks=p.chunks // 2, ppc=2 * p.ppc,
                         cta_bytes=2 * p.cta_bytes)  # 442 KB a CTA
    # 8 CTAs an SM of 28 KB each: more than the SMs hold at once
    ppc = -(-512 * 912 // (8 * sms))
    too_many = p._replace(chunks=-(-512 * 912 // ppc), ppc=ppc,
                          cta_bytes=ppc * 64)
    for q in (too_big, too_many):
        with pytest.raises(RuntimeError):
            instance_norm_act_resident(x, "relu", p=q)
    with pytest.raises(ValueError):  # the split variant's plane
        instance_norm_act_resident(
            _randn((1, 512, 912, 128), torch.bfloat16, cuda), "relu")
    with pytest.raises(ValueError):
        instance_norm_act_resident(x, "relu", p=Plan("split", 32, 0, 0, 1,
                                                       512 * 912))
    base = _randn((1 * 128 * 228 * 128 + 1,), torch.bfloat16, cuda)
    misaligned = base[1:].view(1, 128, 228, 128)
    assert plan_for(misaligned).variant == "streaming"
    with pytest.raises(ValueError):
        instance_norm_act_resident(misaligned, "relu")
    torch.cuda.synchronize()
    assert instance_norm_act_resident.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ctas", [
    ((2, 79, 81, 32), 40),    # ragged chunks, two samples
    ((3, 9, 7, 40), 7),       # G = 8 (bf16) or 8 (fp32), one chunk a unit
    ((1, 33, 47, 16), 1000),  # more chunks than pixels allow: a pixel each
])
def test_instance_norm_split_variant_at_odd_sizes(cuda, dtype, shape, ctas):
    """The split variant on any aligned tensor, at a plan forced by
    ``split_plan``, against the plain version; a call with another plan
    after it still sees zeroed counters (each launch leaves them zero)."""
    x = _randn(shape, dtype, cuda, seed=13)
    p = split_plan(*shape, dtype, ctas=ctas)
    for act in ACTS:
        _assert_in_close(instance_norm_act_split(x, act, p=p),
                         instance_norm_act_plain(x, act), dtype)
    other = split_plan(*shape, dtype, ctas=max(1, ctas // 3))
    _assert_in_close(instance_norm_act_split(x, "relu", p=other),
                     instance_norm_act_plain(x, "relu"), dtype)


@pytest.mark.cuda
def test_instance_norm_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn(2, 8, 8, 32, device=cuda)
    for fn in (instance_norm_act, *VARIANTS.values(),
               instance_norm_act_split, instance_norm_act_resident):
        with pytest.raises(ValueError):
            fn(x.permute(0, 2, 1, 3), None)  # not contiguous
        with pytest.raises(TypeError):
            fn(x.half(), None)
        with pytest.raises(ValueError):
            fn(x[0], None)  # not (N, H, W, C)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_blend_kernel_bitwise_equals_plain(cuda, seed):
    gen, wts, pos, H, W = _blend_case(seed, 60, 80, 400, 500)
    gen = gen * 2 - 1
    offs, ids = tblend.bin_tiles(pos, H, W, 80)
    g, w = torch.from_numpy(gen).to(cuda), torch.from_numpy(wts).to(cuda)
    before = tblend.blend_tiles.launches
    got = tblend.blend_tiles(g, w, pos, offs, ids, H, W)
    torch.cuda.synchronize()
    assert tblend.blend_tiles.launches == before + 1
    want = tblend.blend_tiles_plain(g, w, pos, H, W)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_blend_kernel_on_the_engine_layout(cuda):
    """Three co-batched frames with clipped boxes and padding rows."""
    from patch_toon_tpu_torch.infer.programs import make_tile_plan
    from patch_toon_tpu_torch.infer.tiling import (
        bucket_size, pack_boxes_multi, tile_boxes_from_mask)

    h, w, ps = 130, 200, 80
    mask = np.zeros((h, w), np.float32)
    mask[:90, 30:] = 1
    boxes = [tile_boxes_from_mask(mask, ps, 30.0)] * 3
    fb, wts, _ = pack_boxes_multi(boxes, ps, bucket_size(3 * len(boxes[0])))
    plan = make_tile_plan(fb, h, w, ps, cuda)
    gen = torch.rand((len(fb), ps, ps, 3), device=cuda) * 2 - 1
    wt = torch.from_numpy(wts).to(cuda)
    args = (gen, wt, plan.positions, 3 * (h + ps), w + ps)
    got = tblend.blend_tiles(gen, wt, plan.positions, plan.offsets,
                             plan.ids, *args[3:])
    want = tblend.blend_tiles_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _window_case(seed: int):
    """A 512x910 frame's upload window (``crop_upload``): an ellipse mask
    near the right edge, its tiles at patch 80, the window of their
    footprints and the mask's support, the boxes shifted into it."""
    from patch_toon_tpu_torch.infer.common import (
        mask_support_bbox, upload_crop_window)
    from patch_toon_tpu_torch.infer.tiling import tile_boxes_from_mask

    h, w, ps = 512, 910, 80
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = 300 + 7 * seed, 760 + 5 * seed
    mask = (((yy - cy) / 110.0) ** 2 + ((xx - cx) / 150.0) ** 2
            <= 1).astype(np.float32)
    boxes = tile_boxes_from_mask(mask, ps, 30.0)
    win = upload_crop_window(boxes, h, w, ps,
                             support_bbox=mask_support_bbox(mask))
    y0, y1, x0, x1 = win
    return ([(b[0] - y0, b[1] - y0, b[2] - x0, b[3] - x0) for b in boxes],
            y1 - y0, x1 - x0, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_blend_kernel_on_an_upload_window(cuda, seed):
    """B2 on the canvas of three co-batched upload windows, whose sides
    (window + patch) are not multiples of its 32-pixel block, bitwise its
    plain version."""
    from patch_toon_tpu_torch.infer.programs import make_tile_plan
    from patch_toon_tpu_torch.infer.tiling import (
        bucket_size, pack_boxes_multi)

    boxes, bh, bw, ps = _window_case(seed)
    ch, cw = 3 * (bh + ps), bw + ps
    assert bh < 512 and ch % 32 and cw % 32
    fb, wts, _ = pack_boxes_multi([boxes] * 3, ps,
                                  bucket_size(3 * len(boxes)))
    plan = make_tile_plan(fb, bh, bw, ps, cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    gen = torch.rand((len(fb), ps, ps, 3), device=cuda, generator=g) * 2 - 1
    wt = torch.from_numpy(wts).to(cuda)
    got = tblend.blend_tiles(gen, wt, plan.positions, plan.offsets,
                             plan.ids, ch, cw)
    want = tblend.blend_tiles_plain(gen, wt, plan.positions, ch, cw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 910), (3, 7, 9), (1, 1)])
def test_unpack_mask_on_the_card_is_numpy_unpackbits(cuda, shape):
    """``unpack_mask`` on the card against ``np.unpackbits(..., count=H*W)``
    (its plain version), bitwise, pad bits dropped; and the flow step's
    graph with a packed mask is bitwise the eager step with the plane."""
    from patch_toon_tpu_torch.infer.common import pack_mask, unpack_mask

    rng = np.random.default_rng(len(shape))
    m = (rng.random(shape) > 0.4).astype(np.uint8)
    packed = pack_mask(m)
    h, w = shape[-2:]
    got = unpack_mask(torch.from_numpy(packed).to(cuda), h, w)
    want = np.unpackbits(packed, axis=-1, count=h * w).reshape(shape)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if shape != (512, 910):
        return
    from patch_toon_tpu_torch.infer.temporal import (
        FlowGraphs, _device_gray, _temporal_device_flow)

    f1, f2, fm = _flow_pair(256, 456, 4)
    f1, f2 = (torch.from_numpy(a).to(cuda) for a in (f1, f2))
    prev = _device_gray(f2)
    plane = torch.from_numpy(fm).to(cuda)
    bits = torch.from_numpy(pack_mask(fm)).to(cuda)
    graphs = FlowGraphs()
    got = [graphs(f1, prev, bits, 1) for _ in range(2)]
    want = _temporal_device_flow(f1, prev, plane, 1)
    torch.cuda.synchronize()
    assert graphs.captures == 1
    for flow, gray in got:
        assert torch.equal(flow, want[0]) and torch.equal(gray, want[1])


# ------------------------------------------------------- B1 under autograd

# (H, W, C) of every InstanceNorm site of a training step at the default
# widths: the generator's five shapes and the discriminator's two
TRAIN_SHAPES = MAIN_PATH_SHAPES + [(20, 20, 24), (19, 19, 48)]


def _stats(x):
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = torch.square(x32 - mean[:, None, None]).mean(dim=(1, 2))
    return mean.contiguous(), torch.rsqrt(var + 1e-5).contiguous()


BACKWARD = {"cluster": instance_norm_act_backward_cluster,
            "streaming": instance_norm_act_backward_streaming,
            "sample": instance_norm_act_backward_sample}


def _check_backward(x, dy, act, variant):
    """One launch of the backward ``variant`` (through the dispatching
    wrapper for None), counted once on the variant that ran, against the
    plain version on the same x, dy and statistics: fp32 within 2e-5
    absolute and relative (sums in other orders); bf16 within one bf16 ulp
    of the value (one rounding of an fp32 result that may differ in the
    last bits). A second call is bitwise equal (a fixed order, no
    atomics)."""
    mean, rstd = _stats(x)
    ran = variant or plan_backward_for(x, dy).variant
    fn = BACKWARD[variant] if variant else instance_norm_act_backward
    before = {k: f.launches for k, f in BACKWARD.items()}
    got = fn(x, dy, mean, rstd, act)
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in BACKWARD.items()}
    assert after == {k: v + (k == ran) for k, v in before.items()}
    assert got.dtype == x.dtype and got.is_contiguous()
    want = instance_norm_act_backward_plain(x, dy, mean, rstd, act)
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        _assert_bf16_close(got.float().cpu().numpy(),
                           want.float().cpu().numpy())
    assert torch.equal(got, fn(x, dy, mean, rstd, act))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["cluster", "streaming"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hwc", TRAIN_SHAPES)
def test_instance_norm_backward_kernel_matches_plain(cuda, act, dtype, hwc,
                                                     variant):
    """Both backward variants at every site shape of a training step; the
    plan sends each of them to the cluster variant."""
    x = _randn((3,) + hwc, dtype, cuda, seed=6)
    dy = _randn((3,) + hwc, dtype, cuda, seed=7)
    assert plan_backward_for(x, dy).variant == "cluster"
    _check_backward(x, dy, act, variant)


@pytest.mark.cuda
def test_instance_norm_backward_cluster_sizes_one_to_eight(cuda):
    """k = 1, 2, 4 and 8 at each dtype, H*W ragged against k (21x23, 29x31,
    45x45 and 79x81 pixels), through the dispatching wrapper."""
    shapes = [(1, 3, 5, 128), (2, 21, 23, 64), (2, 29, 31, 32),
              (2, 45, 45, 64), (1, 79, 81, 32)]
    for dtype in (torch.float32, torch.bfloat16):
        ks = set()
        for i, shape in enumerate(shapes):
            x = _randn(shape, dtype, cuda, seed=20 + i)
            dy = _randn(shape, dtype, cuda, seed=40 + i)
            p = plan_backward_for(x, dy)
            assert p.variant == "cluster"
            ks.add(p.k)
            for act in ACTS:
                _check_backward(x, dy, act, None)
        assert ks == {1, 2, 4, 8}, (dtype, ks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_backward_streaming_dispatch(cuda, dtype):
    """What the backward cluster variant does not take goes to the sample
    variant where a sample's x and dy fit 8 CTAs (a misaligned x or dy,
    C = 12 at bf16) and to the streaming variant where not (a full-frame
    plane); the cluster wrapper refuses both."""
    full = (1, 540, 960, 128)
    base = _randn((2 * 20 * 20 * 32 + 1,), dtype, cuda, seed=11)
    aligned = _randn((2, 20, 20, 32), dtype, cuda, seed=12)
    misaligned = base[1:].view(2, 20, 20, 32)
    cases = [(_randn(full, dtype, cuda, seed=13),
              _randn(full, dtype, cuda, seed=14), "streaming"),
             (misaligned, aligned, "sample"), (aligned, misaligned, "sample")]
    if dtype == torch.bfloat16:
        odd = (2, 20, 20, 12)
        cases.append((_randn(odd, dtype, cuda, seed=15),
                      _randn(odd, dtype, cuda, seed=16), "sample"))
    for x, dy, variant in cases:
        assert plan_backward_for(x, dy).variant == variant, x.shape
        _check_backward(x, dy, "relu", None)
        mean, rstd = _stats(x)
        with pytest.raises(ValueError):
            instance_norm_act_backward_cluster(x, dy, mean, rstd, "relu")


@pytest.mark.cuda
def test_instance_norm_backward_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn(2, 8, 8, 32, device=cuda)
    dy = torch.randn_like(x)
    mean, rstd = _stats(x)
    for fn in (instance_norm_act_backward, *BACKWARD.values()):
        with pytest.raises(ValueError):  # dy not contiguous
            fn(x, dy.transpose(1, 2).contiguous().transpose(1, 2), mean,
               rstd)
        with pytest.raises(ValueError):  # dy in another type
            fn(x, dy.bfloat16(), mean, rstd)
        with pytest.raises(ValueError):  # statistics of another shape
            fn(x, dy, mean[:, :16].contiguous(), rstd)
        with pytest.raises(TypeError):
            fn(x.half(), dy.half(), mean, rstd)
        with pytest.raises(ValueError):
            fn(x, dy, mean, rstd, "gelu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 20, 20, 24), (2, 540, 960, 32),
                                   (1, 128, 228, 128)])
def test_instance_norm_forward_writes_the_statistics(cuda, dtype, shape):
    """Every forward variant that takes the shape (the second shape goes to
    the split one, the third to the resident one, and the streaming one
    takes all) gives the plain version's mean and rstd with
    ``stats=True``: within 1e-5 relative, 5e-5 for rstd of the
    518,400-pixel plane, whose streaming sums add 32,400 values a thread
    in sequence."""
    rtol = 5e-5 if shape[1] * shape[2] > 100_000 else 1e-5
    x = _randn(shape, dtype, cuda, seed=8)
    want_mean, want_rstd = _stats(x)
    picked = plan_for(x).variant
    for variant, fn in FULL_FRAME_VARIANTS.items():
        if variant != "streaming" and variant != picked:
            continue
        y, mean, rstd = fn(x, "relu", stats=True)
        torch.cuda.synchronize()
        _assert_in_close(y, instance_norm_act_plain(x, "relu"), dtype)
        torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(rstd, want_rstd, rtol=rtol, atol=1e-6)


@pytest.mark.cuda
def test_instance_norm_function_launches_both_kernels(cuda):
    from patch_toon_tpu_torch.ops.instance_norm import InstanceNormAct

    x = _randn((4, 20, 20, 128), torch.float32, cuda, seed=9)
    dy = _randn(x.shape, torch.float32, cuda, seed=10)
    xg = x.clone().requires_grad_(True)
    f0 = instance_norm_act_cluster.launches
    b0 = {k: f.launches for k, f in BACKWARD.items()}
    y = InstanceNormAct.apply(xg, "leaky_relu", 0.2, 1e-5)
    (dx,) = torch.autograd.grad(y, xg, dy)
    torch.cuda.synchronize()
    assert instance_norm_act_cluster.launches == f0 + 1
    assert {k: f.launches for k, f in BACKWARD.items()} == {
        **b0, "cluster": b0["cluster"] + 1}
    mean, rstd = _stats(x)
    torch.testing.assert_close(dx, instance_norm_act_backward_plain(
        x, dy, mean, rstd, "leaky_relu"), rtol=2e-5, atol=2e-5)


# ------------------------------------------------ B1's sample variant

# the discriminator's B1 slices under tensor parallelism whose rows are not
# whole 16-byte vectors (tests/test_torch_kernels.py D_SLICES)
D_SLICES = [(torch.bfloat16, (80, 20, 20, 12)),
            (torch.bfloat16, (80, 20, 20, 6)),
            (torch.bfloat16, (80, 19, 19, 12)),
            (torch.float32, (80, 20, 20, 6))]


def _check_sample(x, act, p=None):
    """One launch of the sample variant (through the dispatching wrapper
    when ``p`` is None) with its statistics, counted once, against the
    plain version (the kernels' tolerance) and its own plain arithmetic at
    the same plan, statistics within 1e-5, two calls bitwise equal."""
    fn = instance_norm_act if p is None else instance_norm_act_sample
    kw = {} if p is None else {"p": p}
    q = p or plan_for(x)
    assert q.variant == "sample"
    before = instance_norm_act_sample.launches
    if p is None:
        y = fn(x, act)
        _, mean, rstd = instance_norm_act_sample(x, act, stats=True)
        count = 2
    else:
        y, mean, rstd = fn(x, act, stats=True, **kw)
        count = 1
    torch.cuda.synchronize()
    assert instance_norm_act_sample.launches == before + count
    _assert_in_close(y, instance_norm_act_plain(x, act), x.dtype)
    want, pmean, prstd = _sample_forward_plain(x, act, 0.2, 1e-5, q)
    _assert_in_close(y, want, x.dtype)
    torch.testing.assert_close(mean, pmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, prstd, rtol=1e-5, atol=1e-5)
    assert torch.equal(y, fn(x, act, **kw))


def _check_sample_backward(x, dy, act, p=None):
    """One launch of the backward sample variant (through the dispatching
    wrapper when ``p`` is None), counted once, against the plain backward
    and its own plain arithmetic (fp32 2e-5, bf16 one ulp), bitwise
    repeatable; dy may be a channel slice of a wider gradient."""
    mean, rstd = _stats(x)
    fn = instance_norm_act_backward if p is None else \
        instance_norm_act_backward_sample
    kw = {} if p is None else {"p": p}
    q = p or plan_backward_for(x, dy)
    assert q.variant == "sample"
    before = {k: f.launches for k, f in BACKWARD.items()}
    got = fn(x, dy, mean, rstd, act, **kw)
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in BACKWARD.items()}
    assert after == {**before, "sample": before["sample"] + 1}
    assert got.dtype == x.dtype and got.is_contiguous()
    for want in (instance_norm_act_backward_plain(x, dy, mean, rstd, act),
                 _sample_backward_plain(x, dy, mean, rstd, act, 0.2, q)):
        if x.dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        else:
            _assert_bf16_close(got.float().cpu().numpy(),
                               want.float().cpu().numpy())
    assert torch.equal(got, fn(x, dy, mean, rstd, act, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype,shape", D_SLICES)
def test_instance_norm_sample_variant_at_every_d_slice(cuda, act, dtype,
                                                       shape):
    """Forward and backward at every slice shape of D's sites that the
    plan gives the sample variant, dy a rank's channel slice of the
    gathered gradient (rank 1 of 2: offset C, pixel stride 2C)."""
    x = _randn(shape, dtype, cuda, seed=30)
    _check_sample(x, act)
    wide = _randn(shape[:3] + (2 * shape[3],), dtype, cuda, seed=31)
    dy = wide[..., shape[3]:]
    _check_sample_backward(x, dy, act)
    _check_sample_backward(x, dy.contiguous(), act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 17, 7), (3, 19, 19, 1),
                                   (1, 5, 3, 3), (2, 11, 19, 301),
                                   (1, 120, 130, 13)])
def test_instance_norm_sample_variant_at_odd_sizes_and_cluster_sizes(
        cuda, dtype, shape):
    """Odd C (1 to 301: more channels than threads), ragged planes, at the
    plan's k (the last shape needs 4 CTAs a sample at bf16, 8 at fp32) and
    forced to clusters of 1, 2, 4 and 8 CTAs where they hold the sample
    (more CTAs than pixels at the third shape), forward and backward; the
    last shape's x and dy at fp32 fit no 8 CTAs, so its backward goes to
    the streaming variant."""
    n, h, w, c = shape
    x = _randn(shape, dtype, cuda, seed=32)
    dy = _randn(shape, dtype, cuda, seed=33)
    own, ownb = plan_for(x), plan_backward_for(x, dy)
    if shape == (1, 120, 130, 13):
        assert own.k == (4 if dtype == torch.bfloat16 else 8)
    ks = set()
    for k in (1, 2, 4, 8):
        ppc = -(-h * w // k)
        item = dtype.itemsize
        if sample_smem(ppc, c, item) <= CTA_BYTES:
            _check_sample(x, "leaky_relu", Plan("sample", 0, k, 0, k, ppc))
            ks.add(k)
        if sample_smem(ppc, c, item, True) <= CTA_BYTES:
            _check_sample_backward(x, dy, "relu",
                                   Plan("sample", 0, k, 0, k, ppc))
    assert own.k in ks
    _check_sample(x, None)
    if ownb.variant == "sample":
        _check_sample_backward(x, dy, "leaky_relu")
    else:
        assert ownb.variant == "streaming" and shape[1] == 120
        assert sample_plan(*shape, dtype, backward=True) is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset_bytes", [2, 4, 8])
def test_instance_norm_sample_variant_at_unaligned_pointers(
        cuda, dtype, offset_bytes):
    """x, dy and a strided dy that start 2 (bf16 only), 4 or 8 bytes past
    a 16-byte boundary: the run's ends are copied element by element, its
    inside by 16-byte copies; dy's rows at the widest copy their address
    and strides allow."""
    item = dtype.itemsize
    if offset_bytes < item:
        pytest.skip("an fp32 tensor is 4-byte aligned")
    off = offset_bytes // item
    for shape in ((3, 20, 20, 6), (2, 19, 19, 12), (2, 9, 7, 32)):
        n, h, w, c = shape
        size = n * h * w * c
        x = _randn((size + off,), dtype, cuda, seed=34)[off:].view(shape)
        assert x.data_ptr() % 16 == offset_bytes
        dy = _randn((size + off,), dtype, cuda, seed=35)[off:].view(shape)
        _check_sample(x, "relu")
        _check_sample_backward(x, dy, "leaky_relu")
        wide = _randn((n * h * w * 3 * c + off,), dtype, cuda, seed=36)[
            off:].view(n, h, w, 3 * c)
        _check_sample_backward(x, wide[..., c:2 * c], None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_function_reads_a_strided_dy_on_the_card(cuda, dtype):
    """``InstanceNormAct`` on a D slice: one sample launch forward, one
    backward on the strided dy as it lies (no copy counted), dx bitwise
    the one from the same dy made contiguous; a G slice (16 channels) still
    copies dy for the cluster variant."""
    for shape, sample in (((8, 20, 20, 6), True), ((8, 20, 20, 16), False)):
        x = _randn(shape, dtype, cuda, seed=37)
        wide = _randn(shape[:3] + (4 * shape[3],), dtype, cuda, seed=38)
        dy = wide[..., shape[3]:2 * shape[3]]
        dxs = []
        for g in (dy, dy.contiguous()):
            xg = x.clone().requires_grad_(True)
            f0 = {k: f.launches for k, f in
                  (("sample", instance_norm_act_sample),
                   ("cluster", instance_norm_act_cluster))}
            b0 = {k: f.launches for k, f in BACKWARD.items()}
            copies = InstanceNormAct.dy_copies
            y = InstanceNormAct.apply(xg, "leaky_relu", 0.2, 1e-5)
            (dx,) = torch.autograd.grad(y, xg, g)
            torch.cuda.synchronize()
            v = "sample" if sample else "cluster"
            fn = instance_norm_act_sample if sample else \
                instance_norm_act_cluster
            assert fn.launches == f0[v] + 1
            assert {k: f.launches for k, f in BACKWARD.items()} == {
                **b0, v: b0[v] + 1}
            assert InstanceNormAct.dy_copies - copies == (
                g is dy and not sample)
            dxs.append(dx)
        assert torch.equal(dxs[0], dxs[1])


@pytest.mark.cuda
def test_instance_norm_sample_variant_refuses_what_it_cannot_hold(cuda):
    """A plan whose CTAs cannot hold their share of the sample (one CTA for
    a sample that needs 4), a cluster size the kernel does not take, and a
    shape the plan gives another variant: the entry returns an error code
    and nothing launches."""
    x = _randn((1, 120, 130, 13), torch.bfloat16, cuda, seed=39)
    dy = _randn(x.shape, torch.bfloat16, cuda, seed=40)
    mean, rstd = _stats(x)
    f0 = instance_norm_act_sample.launches
    b0 = instance_norm_act_backward_sample.launches
    for k in (1, 3):
        p = Plan("sample", 0, k, 0, k, -(-120 * 130 // k))
        with pytest.raises(RuntimeError, match="CUDA error"):
            instance_norm_act_sample(x, None, p=p)
        with pytest.raises(RuntimeError, match="CUDA error"):
            instance_norm_act_backward_sample(x, dy, mean, rstd, None, p=p)
    assert instance_norm_act_sample.launches == f0
    assert instance_norm_act_backward_sample.launches == b0
    aligned = _randn((2, 20, 20, 32), torch.float32, cuda, seed=41)
    m2, r2 = _stats(aligned)
    with pytest.raises(ValueError):  # the plan gives it the cluster variant
        instance_norm_act_sample(aligned, None)
    with pytest.raises(ValueError):
        instance_norm_act_backward_sample(aligned, aligned, m2, r2, None)
    full = _randn((1, 540, 960, 6), torch.float32, cuda, seed=42)
    assert plan_for(full).variant == "streaming"
    assert sample_plan(1, 540, 960, 6, torch.float32) is None
    with pytest.raises(ValueError):
        instance_norm_act_sample(full, None)
    assert _build.library().ptt_instance_norm_sample_smem(
        400, 12, 2, 1) == sample_smem(400, 12, 2, True)


@pytest.mark.cuda
def test_generator_backward_on_cuda_matches_the_cpu(cuda):
    """C3: a backward pass through GeneratorJ on the card gives every conv
    a gradient, and each conv's gradient equals, within 5e-5 in relative L2
    norm, the fp64 gradient of the same function with the card's own
    branch at every activation (``train/parity.py::Kinks``), as the CPU
    port's equals its own; where no activation input took the other branch
    on the two devices, the card equals the CPU within 5e-5 as well. fp32,
    TF32 off. A dropped gradient (fault C3) is 1.0; one flipped element
    among the 131,072 of the last InstanceNorm site moved every conv
    gradient upstream of it by 3.3e-3 in a card run of these inputs."""
    import copy

    from patch_toon_tpu_torch.models.generator import GeneratorJ
    from patch_toon_tpu_torch.train.parity import Kinks

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(0)
        cpu = GeneratorJ(input_channels=6, filters=(8, 16, 32, 32, 32, 16),
                         use_bias=True, resnet_blocks=2).train()
        with torch.no_grad():
            for p in cpu.parameters():
                p.add_(torch.randn_like(p) * 0.05)
        card = copy.deepcopy(cpu).to(cuda, memory_format=torch.channels_last)
        g = torch.Generator().manual_seed(1)
        x = torch.rand((4, 32, 32, 6), generator=g) * 2 - 1
        w = torch.randn((4, 32, 32, 3), generator=g)

        def grads(net, dev, kinks, dtype=torch.float32):
            with kinks:
                out = net(x.to(dev, dtype))
                return dict(zip(
                    [n for n, _ in net.named_parameters()],
                    (t.double().cpu() for t in torch.autograd.grad(
                        (out * w.to(dev, dtype)).sum(),
                        list(net.parameters())))))

        b0 = {k: f.launches for k, f in BACKWARD.items()}
        kinks = {"cpu": Kinks(), "card": Kinks()}
        got = {"cpu": grads(cpu, "cpu", kinks["cpu"]),
               "card": grads(card, cuda, kinks["card"])}
        torch.cuda.synchronize()
        # stem, 2 downsamples, 2 blocks x 2, 2 upsamples: 9 sites, all in
        # the cluster variant
        assert {k: f.launches for k, f in BACKWARD.items()} == {
            **b0, "cluster": b0["cluster"] + 9}
        ref = {tag: grads(copy.deepcopy(cpu).double(), "cpu",
                          Kinks(replay=k.masks), torch.float64)
               for tag, k in kinks.items()}
        flips = sum(int((a != b).sum()) for a, b in
                    zip(kinks["cpu"].masks, kinks["card"].masks))
        for name, want in got["cpu"].items():
            if want.dim() != 4:  # conv weights; biases that feed IN get ~0
                continue
            assert got["card"][name].abs().max() > 0, name  # it flows
            for tag in ("cpu", "card"):
                err = float((got[tag][name] - ref[tag][name]).norm()
                            / ref[tag][name].norm())
                assert err <= 5e-5, (tag, name, err)
            if not flips:
                err = float((got["card"][name] - want).norm() / want.norm())
                assert err <= 5e-5, (name, err)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
def test_training_step_on_cuda_against_the_cpu(cuda):
    """One training step at the CPU tests' small widths, batch 4, on the
    card and on the CPU from the same parameters and batch, at precision 32
    (each device against the fp64 step that takes its own branches) and
    bf16 (each device against the CPU's fp32 step), with the limits of
    ``train/parity.py::assert_device_step_parity``."""
    from chip_smoke import _train_model
    from patch_toon_tpu_torch.train.parity import (
        assert_device_step_parity, device_step_parity)

    rng = np.random.default_rng(1)
    batch = {"pre": rng.standard_normal((4, 32, 32, 3)),
             "channels": rng.standard_normal((4, 32, 32, 3)),
             "post": rng.random((4, 32, 32, 3)) * 2 - 1}
    r = device_step_parity(_train_model("32", True, 4),
                           _train_model("bf16", True, 4), batch, cuda)
    assert r["kinks"] == 25
    assert_device_step_parity(r)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["32", "bf16"])
def test_process_directory_on_cuda_equals_stylize_group(cuda, tmp_path,
                                                        precision):
    """The pipelined directory run on the card (pinned staging on the copy
    stream, two groups in flight) writes the frames of ``stylize_group``
    run group by group, bit for bit, with PIL unimportable; the pinned
    upload buffers are reused, not allocated a frame."""
    from chip_smoke import write_scene
    from patch_toon_tpu_torch.config.defaults import inference_config
    from patch_toon_tpu_torch.infer.engine import StyleTransferInference
    from patch_toon_tpu_torch.models.generator import GeneratorJ
    from patch_toon_tpu_torch.native import decode_png

    torch.manual_seed(7)
    model = GeneratorJ(input_channels=6, filters=(8, 16, 16, 16, 16, 8),
                       use_bias=True, resnet_blocks=1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}},
               tmp_path / "gen.ckpt")
    scene = tmp_path / "scene"
    write_scene(scene, 11, 96, 160)
    cfg = inference_config(
        paths={"checkpoint": str(tmp_path / "gen.ckpt"),
               "input_dir": str(scene / "input"),
               "mask_dir": str(scene / "mask"),
               "output_dir": str(tmp_path / "out"),
               "additional_channels": {"point_vector": {
                   "path": str(scene / "tracking"), "depth": 3}}},
        inference={"precision": precision, "frames_per_dispatch": 2})
    cfg["model"]["generator"]["args"].update(
        filters=[8, 16, 16, 16, 16, 8], resnet_blocks=1)
    cfg["data"]["patch_size"] = 32
    eng = StyleTransferInference(cfg, device="cuda")
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        assert eng.process_directory() == 11
    finally:
        del sys.modules["PIL"]
        if saved is not None:
            sys.modules["PIL"] = saved
    assert eng.upload_pools.allocated() <= 6
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    for i in range(0, 11, 2):
        chunk = names[i:i + 2]
        frames = np.stack([eng.load_frame(scene / "input" / n)
                           for n in chunk])
        masks = [eng.load_eroded_mask(scene / "mask" / n, frames.shape[1:3])
                 for n in chunk]
        for n, want in zip(chunk, eng.stylize_group(frames, masks)):
            np.testing.assert_array_equal(decode_png(tmp_path / "out" / n),
                                          want, err_msg=n)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,temporal", [("fullframe", False),
                                           ("fullframe", True),
                                           ("tiled", True),
                                           ("fullframe", "device")])
def test_fullframe_and_temporal_serving_on_cuda_match_the_cpu(
        cuda, tmp_path, mode, temporal):
    """``process_directory`` on the card at precision 32 writes the frames
    of the same engine on the CPU within 1 count: full-frame mode and the
    temporal chain with flows from files (one missing) in both modes, and
    with the device flow (one graph captured, replayed each frame). One
    B1 launch a site and frame (7 sites at one residual block), never the
    streaming variant; in full-frame mode the two 192x256 planes (stem,
    upsample1) go to the resident variant and no B2 runs, tiled one B2
    launch a frame."""
    from chip_smoke import _temporal_scene, write_scene
    from patch_toon_tpu_torch.config.defaults import inference_config
    from patch_toon_tpu_torch.infer.engine import StyleTransferInference
    from patch_toon_tpu_torch.models.generator import GeneratorJ
    from patch_toon_tpu_torch.native import decode_png
    from patch_toon_tpu_torch.ops import blend

    channels = 9 if temporal else 6
    torch.manual_seed(8)
    model = GeneratorJ(input_channels=channels,
                       filters=(8, 16, 16, 16, 16, 8), use_bias=True,
                       resnet_blocks=1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}},
               tmp_path / "gen.ckpt")
    write_scene(tmp_path / "base", 6, 192, 256)
    scene = _temporal_scene(tmp_path / "base", tmp_path / "scene", 6) \
        if temporal else tmp_path / "base"
    inf = {"precision": "32", "mode": mode}
    if temporal:
        inf["temporal"] = {"enabled": True, "depth": 3,
                           "flow_dir": str(scene / "flow_bwd")}
    if temporal == "device":
        inf["temporal"]["flow_source"] = "device"
    outs = {}
    counts = {}
    graphs = {}
    for device in ("cuda", "cpu"):
        cfg = inference_config(
            paths={"checkpoint": str(tmp_path / "gen.ckpt"),
                   "input_dir": str(scene / "input"),
                   "mask_dir": str(scene / "mask"),
                   "output_dir": str(tmp_path / device),
                   "additional_channels": {"point_vector": {
                       "path": str(scene / "tracking"), "depth": 3}}},
            inference=inf)
        cfg["model"]["generator"]["args"].update(
            filters=[8, 16, 16, 16, 16, 8], resnet_blocks=1)
        cfg["data"]["patch_size"] = 32
        fns = {**FULL_FRAME_VARIANTS, "blend": blend.blend_tiles}
        before = {k: f.launches for k, f in fns.items()}
        eng = StyleTransferInference(cfg, device=device)
        assert eng.process_directory() == 6
        torch.cuda.synchronize()
        graphs[device] = (eng.flow_graphs.captures, eng.flow_graphs.replays)
        counts[device] = {k: f.launches - before[k] for k, f in fns.items()}
        outs[device] = {p.name: decode_png(p).astype(int)
                        for p in sorted((tmp_path / device).glob("*.png"))}
    assert counts["cpu"] == {k: 0 for k in counts["cpu"]}
    assert graphs["cpu"] == (0, 0)
    assert graphs["cuda"] == ((1, 5) if temporal == "device" else (0, 0))
    got = counts["cuda"]
    assert got["cluster"] + got["resident"] + got["split"] == 7 * 6
    assert got["streaming"] == 0 and got["split"] == 0
    if mode == "tiled":
        assert got["resident"] == 0 and got["blend"] == 6
    else:
        assert got["resident"] == 2 * 6 and got["blend"] == 0
    assert outs["cuda"].keys() == outs["cpu"].keys() and len(outs["cpu"]) == 6
    for name, want in outs["cpu"].items():
        assert np.abs(outs["cuda"][name] - want).max() <= 1, name


def _flow_pair(h, w, seed):
    """Two (H, W, 3) uint8 frames of flat 10x10 squares, the second moved
    by (3, -2) px, and a partial (H, W) uint8 mask."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 10 + 3, w // 10 + 3, 3),
                          dtype=np.uint8)
    big = np.repeat(np.repeat(coarse, 10, 0), 10, 1)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 8:-h // 8, w // 8:-w // 4] = 1
    return (np.ascontiguousarray(big[4:4 + h, 4:4 + w]),
            np.ascontiguousarray(big[6:6 + h, 1:1 + w]), mask)


@pytest.mark.cuda
def test_flow_graph_replay_is_bitwise_the_eager_step(cuda):
    """The flow step as a replayed CUDA graph equals the eager step on the
    card bit for bit: two frame pairs at scale 1 (masked, then not) and one
    at scale 2, one graph a (shape, scale, mask) and its replays not
    disturbing each other's outputs."""
    from patch_toon_tpu_torch.infer.temporal import (
        FlowGraphs,
        _device_gray,
        _temporal_device_flow,
    )

    graphs = FlowGraphs()
    outs = []
    for seed, scale, masked in ((0, 1, True), (1, 1, False), (2, 2, True)):
        f1, f2, mask = _flow_pair(256, 456, seed)
        f1, f2, mask = (torch.from_numpy(a).to(cuda) for a in (f1, f2, mask))
        prev = _device_gray(f2)
        fm = mask if masked else None
        want = _temporal_device_flow(f1, prev, fm, scale)
        got = graphs(f1, prev, fm, scale)
        outs.append((got, want))
        again = graphs(f1, prev, fm, scale)
        torch.cuda.synchronize()
        assert torch.equal(again[0], got[0])
    for (gf, gg), (wf, wg) in outs:
        assert torch.equal(gg, wg) and torch.equal(gf, wf)
        assert gf.abs().max() > 1.0  # the motion is there
    assert graphs.captures == 3 and graphs.replays == 6


@pytest.mark.cuda
def test_flow_on_cuda_matches_the_cpu(cuda):
    """The card's flow step against the CPU's on a blocky 256x456 pair at
    scale 1 and 2: the luma bitwise, the flow within the CPU tests' blocky
    bars (1e-3 px max, 1e-4 px at the 99.9th percentile) or twice LK's own
    one-ulp spread where that is larger."""
    from chip_smoke import _ulp_spread
    from patch_toon_tpu_torch.infer.temporal import _temporal_device_flow
    from patch_toon_tpu_torch.ops.flow import pil_gray

    f1, f2, _ = _flow_pair(256, 456, 3)
    prev = pil_gray(torch.from_numpy(f2))
    for scale in (1, 2):
        cf, cg = _temporal_device_flow(torch.from_numpy(f1), prev, None,
                                       scale)
        gf, gg = _temporal_device_flow(torch.from_numpy(f1).to(cuda),
                                       prev.to(cuda), None, scale)
        assert torch.equal(gg.cpu(), cg)
        spread = _ulp_spread(cg.to(torch.float32) / 255.0,
                             prev.to(torch.float32) / 255.0, scale)
        d = (gf.cpu() - cf).abs().numpy()
        worst, tail = max(1e-3, 2 * spread[0]), max(1e-4, 2 * spread[1])
        assert d.max() <= worst and np.quantile(d, 0.999) <= tail, (
            scale, float(d.max()), float(np.quantile(d, 0.999)), spread)


def _fast_generator(cuda, conv_precision):
    """The shipped generator at full width (6 input channels) from one
    seed, fp32, on the card."""
    from patch_toon_tpu_torch.models.generator import GeneratorJ

    torch.manual_seed(11)
    gen = GeneratorJ(input_channels=6, use_bias=True,
                     conv_precision=conv_precision)
    with torch.no_grad():  # move off the zero-bias init
        for p in gen.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    return gen.to(cuda, memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,stride,hw", [
    (6, 32, 7, 1, 80), (32, 64, 3, 2, 80), (128, 128, 3, 1, 20),
    (256, 128, 3, 1, 40), (166, 64, 7, 1, 80), (12, 24, 4, 2, 80)])
def test_32_fast_conv_on_cuda_within_the_bar(cuda, cin, cout, k, stride, hw):
    """``conv2d_3xtf32`` on the card against the fp64 conv, the largest
    |d| over the largest |y| of the output and of both gradients: each
    within 2e-6 or closer than one TF32 pass of the same product (the
    split removes the inputs' rounding to TF32, not the tensor cores'
    accumulation), and the output within 2e-6 of 1.5 times the error of
    its hi*hi pass alone, whose inputs are exact in TF32 (what remains is
    that accumulation: at K = 166 x 49 it is 2.3e-5 where the strict fp32
    conv is 3.5e-6); cuDNN's TF32 flag is left off."""
    import torch.nn.functional as F

    from patch_toon_tpu_torch.models.layers import (
        _split,
        _tf32_convs,
        conv2d_3xtf32,
    )

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(cin + k)
    x = torch.rand((8, cin, hw, hw), generator=g) * 2 - 1
    w = torch.randn((cout, cin, k, k), generator=g) * (1.0 / (cin * k * k))
    b = torch.randn((cout,), generator=g) * 0.1
    pad = (k - 1) // 2 if k != 4 else 1
    xd = x.to(cuda).contiguous(memory_format=torch.channels_last)
    xd.requires_grad_(True)
    wd = w.to(cuda).clone().requires_grad_(True)
    bd = b.to(cuda)
    gy = None

    def rel(got, want):
        want = want.detach()
        return float((got.detach().cpu().double() - want).abs().max()) \
            / float(want.abs().max())

    def products(fn, xs, ws):
        nonlocal gy
        y = fn(xs, ws)
        if gy is None:
            gy = torch.randn(y.shape, generator=g)
        return (y, *torch.autograd.grad(y, (xs, ws), gy.to(y.device,
                                                            y.dtype)))

    split = products(lambda a, c: conv2d_3xtf32(a, c, bd, (stride, stride),
                                                (pad, pad)), xd, wd)
    assert torch.backends.cudnn.allow_tf32 is False
    with _tf32_convs():
        one = products(lambda a, c: F.conv2d(a, c, bd, stride, pad), xd, wd)
        (xh, _), (wh, _) = _split(xd.detach()), _split(wd.detach())
        hihi = F.conv2d(xh, wh, bd, stride, pad)
    xr = x.double().requires_grad_(True)
    wr = w.double().requires_grad_(True)
    ref = products(lambda a, c: F.conv2d(a, c, b.double(), stride, pad),
                   xr, wr)
    ref_hihi = F.conv2d(xh.cpu().double(), wh.cpu().double(), b.double(),
                        stride, pad)
    errs = [(rel(s_, r), rel(o, r)) for s_, o, r in zip(split, one, ref)]
    for e_split, e_one in errs:  # 2e-6: a product cuDNN keeps in fp32
        assert e_split <= max(2e-6, e_one), errs
    assert errs[0][0] <= 1.5 * rel(hihi, ref_hihi) + 2e-6, errs
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.cuda
def test_32_fast_generator_on_cuda_within_2e5_of_fp32(cuda):
    """The full-width generator with ``conv_precision="high"`` against the
    same weights at strict fp32, both on the card: within 2e-5 absolute
    and relative (JAX's test's bar). (The whole network's gradient is no
    test of the conv: strict fp32 itself is 0.8 % from fp64 there, through
    the activations' branches; each conv's gradients are held above.)"""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    strict = _fast_generator(cuda, None).eval()
    fast = _fast_generator(cuda, "high").eval()
    x = (torch.rand((16, 80, 80, 6), generator=torch.Generator(
        ).manual_seed(3)) * 2 - 1).to(cuda)
    with torch.no_grad():
        a, b = strict(x), fast(x)
    torch.testing.assert_close(b, a, atol=2e-5, rtol=2e-5)
    assert torch.backends.cudnn.allow_tf32 is False


def _splat_case(seed, h, w, n):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32)
    pts = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)],
                   1).astype(np.float32)
    # within r of each border and corner, overlapping, and invalid
    pts[:8] = [[0, 0], [w - 1e-3, h - 1e-3], [0.4, h / 2], [w - 0.6, 7.5],
               [w / 2, 0.2], [40, 40], [40.25, 40.5], [40.5, 39.75]]
    cols = rng.random((n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.2
    valid[:8] = True
    return [torch.from_numpy(a) for a in (img, pts, cols, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.5, 10.0, 15.0])
@pytest.mark.parametrize("h,w,n", [(130, 250, 300), (512, 910, 1000)])
def test_splat_kernel_bitwise_equals_plain(cuda, sigma, h, w, n):
    args = [t.to(cuda) for t in _splat_case(3, h, w, n)]
    before = tsplat.splat_points.launches
    got = tsplat.splat_points(*args, sigma)
    assert tsplat.splat_points.launches == before + 1
    want = tsplat.splat_points_plain(*args, sigma)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    # invalid points only: the canvas as it was
    none = torch.zeros_like(args[3])
    assert torch.equal(tsplat.splat_points(*args[:3], none, sigma), args[0])


def _splat_block_case(h, w, n, seed):
    """Points that stress the per-block lists: a cluster inside one 32x16
    block, points on block edges and corners (x a multiple of 32, y of 16,
    and half a pixel off them), points whose window only touches a block,
    far more points than a chunk of 256, and every fifth point invalid."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32)
    clustered = np.stack([rng.uniform(64, 96, 300), rng.uniform(32, 48, 300)],
                         1)
    gx, gy = np.meshgrid(np.arange(0, w + 1, 32), np.arange(0, h + 1, 16))
    edges = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float64)
    edges = np.concatenate([edges, edges + 0.5, edges - 0.5, edges + 1e-3])
    rest = np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)],
                    1)
    pts = np.concatenate([clustered, edges, rest]).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]
    cols = rng.random((len(pts), 3)).astype(np.float32)
    valid = np.arange(len(pts)) % 5 != 3
    return [torch.from_numpy(a) for a in (img, pts, cols, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.5, 2.0, 10.0, 15.0])
def test_splat_kernel_bitwise_equals_plain_on_block_edges(cuda, sigma):
    """The per-block point lists keep each pixel's blobs and their order:
    bitwise the plain version with points clustered in one block, on the
    blocks' edges and corners, off the canvas by less than a radius,
    crossing several chunks of 256, and some invalid."""
    args = [t.to(cuda) for t in _splat_block_case(150, 230, 700, seed=5)]
    assert args[1].shape[0] > 3 * 256
    before = tsplat.splat_points.launches
    got = tsplat.splat_points(*args, sigma)
    assert tsplat.splat_points.launches == before + 1
    want = tsplat.splat_points_plain(*args, sigma)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    assert not torch.equal(got, args[0])


@pytest.mark.cuda
def test_splat_kernel_refuses_what_it_cannot_take(cuda):
    img, pts, cols, valid = [t.to(cuda) for t in _splat_case(0, 60, 90,
                                                            10)]
    with pytest.raises(ValueError):
        tsplat.splat_points(img.double(), pts, cols, valid, 2.0)
    with pytest.raises(ValueError):
        tsplat.splat_points(img, pts[:3], cols, valid, 2.0)
    with pytest.raises(ValueError):
        tsplat.splat_points(img, pts, cols, valid.float(), 2.0)
    with pytest.raises(ValueError):
        tsplat.splat_points(img[..., :2], pts, cols, valid, 2.0)


# ------------------------------------------------------- int8 (w8a8) kernels

# (H, W, Cin, Cout, k, stride) of the 22 w8a8 sites of a tile call at full
# width (80x80 tiles, 6 input channels), then shapes off the CTA tile: Cin
# 6 and 166, stride 2, H and W odd, Cout 8 and 40 (N padded to 16 and 64)
QUANT_SITES = [(80, 80, 6, 32, 7, 1), (80, 80, 32, 64, 3, 2),
               (40, 40, 64, 128, 3, 2), (20, 20, 128, 128, 3, 1),
               (40, 40, 256, 128, 3, 1), (80, 80, 192, 128, 3, 1),
               (80, 80, 166, 64, 7, 1), (80, 80, 64, 64, 3, 1)]
QUANT_ODD = [(13, 17, 6, 32, 7, 1), (11, 9, 166, 64, 7, 1),
             (15, 21, 32, 64, 3, 2), (9, 7, 64, 128, 3, 2),
             (7, 5, 40, 8, 3, 1), (9, 11, 32, 40, 3, 1)]


def _quant_case(h, w, cin, cout, k, n, dtype, card, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((n, h, w, cin), generator=g) * 1.5).to(dtype)
    weight = torch.randn((cout, cin, k, k), generator=g) * 0.05
    bias = torch.randn((cout,), generator=g) * 0.1
    s = tquant.activation_scale(torch.zeros(()), x)
    wq, w_s = tquant.quantize_weight(weight)
    wp = tquant.pack_weight(wq, tquant.padded_channels(cin))
    return [t.to(card) for t in (x, s, wp, w_s, bias.to(dtype))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QUANT_SITES + QUANT_ODD)
def test_quantize_act_kernel_bitwise_equals_plain(cuda, dtype, shape):
    h, w, cin, cout, k, stride = shape
    x, s, *_ = _quant_case(h, w, cin, cout, k, 3, dtype, cuda, seed=cin)
    n0 = tquant.quantize_act.launches
    got = tquant.quantize_act(x, s)
    assert tquant.quantize_act.launches == n0 + 1
    want = tquant.quantize_act_plain(x, s)
    assert got.shape == want.shape == (3, h, w, tquant.padded_channels(cin))
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), tquant.quantize_act_plain(x.cpu(),
                                                             s.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QUANT_SITES + QUANT_ODD)
def test_conv_s8_kernel_bitwise_equals_plain(cuda, dtype, shape):
    """The accumulator and the output (with and without bias) bit for
    bit against the plain version on the card, and the card's
    accumulator against the CPU's."""
    h, w, cin, cout, k, stride = shape
    x, s, wp, w_s, bias = _quant_case(h, w, cin, cout, k, 2, dtype, cuda,
                                      seed=cout + k)
    xq = tquant.quantize_act(x, s)
    pad = k // 2
    acc = tquant.conv_s8(xq, wp, s, w_s, None, k, stride, pad, torch.int32)
    want = tquant.conv_s8_acc_plain(xq, wp, k, stride, pad)
    assert torch.equal(acc, want)
    assert torch.equal(acc.cpu(), tquant.conv_s8_acc_plain(
        xq.cpu(), wp.cpu(), k, stride, pad))
    for b in (bias, None):
        n0 = tquant.conv_s8.launches
        y = tquant.conv_s8(xq, wp, s, w_s, b, k, stride, pad, dtype)
        assert tquant.conv_s8.launches == n0 + 1
        y_plain = tquant.conv_s8_plain(xq, wp, s, w_s, b, k, stride, pad,
                                       dtype)
        assert y.dtype == dtype and y.shape == y_plain.shape
        assert torch.equal(y, y_plain)


def _conv_s8_against_plain(xq, wp, s, w_s, bias, k, stride, plans=None):
    """conv_s8 bitwise its plain version: the accumulator, and fp32 and
    bf16 out with and without the bias; one launch a call. ``plans``: the
    plan for an output type, launched through ``_conv_s8`` (None: the
    wrapper with its own plan; a type it maps to None is left out)."""
    pad = k // 2
    want = tquant.conv_s8_acc_plain(xq, wp, k, stride, pad)
    ran = 0
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        plan = None if plans is None else plans(dtype)
        if plans is not None and plan is None:
            continue
        for b in ((None,) if dtype == torch.int32
                  else (bias.to(dtype), None)):
            n0 = tquant.conv_s8.launches
            y = (tquant.conv_s8(xq, wp, s, w_s, b, k, stride, pad, dtype)
                 if plan is None else tquant._conv_s8(
                     xq, wp, s, w_s, b, k, stride, pad, dtype, plan))
            assert tquant.conv_s8.launches == n0 + 1
            assert y.dtype == dtype
            if dtype == torch.int32:
                assert torch.equal(y, want)
            else:
                assert torch.equal(y, tquant.dequantize_plain(want, s, w_s,
                                                              b, dtype))
            ran += 1
    assert ran


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", [
    (3, 97, 131, 32, 32, 3, 1),   # 298 tiles (> 2 x 132), 105 in the last
    (5, 97, 131, 32, 64, 3, 1),   # the halo kernel: 315 tiles of 16 x 16
    (2, 83, 77, 6, 32, 7, 1),     # 100 tiles, the last 110 rows
    (5, 41, 39, 64, 128, 3, 2),   # 16 tiles of the stride-2 site
])
def test_conv_s8_persistent_tiles_and_a_ragged_end(cuda, n, h, w, cin, cout,
                                                   k, stride):
    """More tiles than twice the SM count, so each CTA's loop turns, and an
    M that is not a multiple of the 128-pixel tile (of the 16 x 16 tile
    on both edges, for the halo kernel)."""
    x, s, wp, w_s, bias = _quant_case(h, w, cin, cout, k, n, torch.float32,
                                      cuda, seed=h)
    _conv_s8_against_plain(tquant.quantize_act(x, s), wp, s, w_s, bias, k,
                           stride)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k", [(40, 8, 3), (32, 40, 3), (6, 40, 7),
                                        (64, 2, 3), (64, 192, 3),
                                        (32, 256, 3)])
def test_conv_s8_pads_and_walks_the_output_channels(cuda, cin, cout, k):
    """Cout below its tile (8 in 16, 40 in 64, 2 in 16: rows of B past
    Cout zero-filled, never stored; 4-byte stores where a row is not 16
    bytes) and above 128 (tiles of 128 channels)."""
    x, s, wp, w_s, bias = _quant_case(11, 13, cin, cout, k, 3,
                                      torch.bfloat16, cuda, seed=cout)
    _conv_s8_against_plain(tquant.quantize_act(x, s), wp, s, w_s, bias, k, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,k", [
    (3, 80, 80, 166, 64, 7),   # conv11: two channel chunks, 128 + 48
    (2, 80, 80, 64, 64, 3),    # a smoother
    (3, 37, 45, 192, 64, 3),   # ragged tiles on both edges, 128 + 64
    (2, 29, 21, 6, 32, 7),     # Cp 16: one k32 step a tap, Cout 32 of 64
    (2, 19, 23, 32, 40, 3),    # Cout 40 of 64
    (1, 9, 7, 128, 2, 3),      # 4-byte rows, one tile past both edges
])
def test_conv_s8_halo_kernel_bitwise_equals_plain(cuda, n, h, w, cin, cout,
                                                  k):
    """The halo kernel (stride 1, 16 x 16 tiles, N = 64, the input patch in
    shared memory) bitwise its plain version."""
    x, s, wp, w_s, bias = _quant_case(h, w, cin, cout, k, n, torch.float32,
                                      cuda, seed=h + k)

    def plans(dtype):
        return tquant._plan(cout, wp.shape[1], dtype, k, 1, 1, False, 0)

    _conv_s8_against_plain(tquant.quantize_act(x, s), wp, s, w_s, bias, k,
                           1, plans)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", [
    (3, 80, 80, 166, 64, 7, 1),   # conv11: two channel chunks, 128 + 48
    (3, 80, 80, 6, 32, 7, 1),     # the stem: Cp 16, weight resident
    (3, 20, 20, 128, 128, 3, 1),  # a residual conv: weight streamed
    (2, 40, 40, 256, 128, 3, 1),  # upsample2: two whole chunks
    (2, 80, 80, 32, 64, 3, 2),    # downsample1, stride 2
    (3, 40, 40, 64, 128, 3, 2),   # downsample2, stride 2
    (2, 37, 45, 192, 96, 3, 1),   # ragged rows and tile, Cout 96 of 128
    (2, 29, 21, 6, 40, 7, 1),     # Cp 16, Cout 40 of 64
    (1, 9, 7, 64, 64, 3, 2),      # odd sizes at stride 2, one tile
])
@pytest.mark.parametrize("variant", ["gather resident", "gather streamed",
                                     "halo"])
def test_conv_s8_each_kernel_bitwise_equals_plain(cuda, n, h, w, cin, cout,
                                                  k, stride, variant):
    """Each kernel that takes a shape (the gather kernel with the weight
    loaded once a CTA and kept, or streamed through the ring; the halo
    kernel at stride 1) bitwise its plain version; a kernel that does not
    take the shape is passed over."""
    x, s, wp, w_s, bias = _quant_case(h, w, cin, cout, k, n, torch.float32,
                                      cuda, seed=w + k)
    v = tquant.VARIANTS.index(variant.split()[0])

    def plans(dtype):
        return tquant._plan(cout, wp.shape[1], dtype, k, stride, v,
                            variant == "gather resident", 0)

    if plans(torch.bfloat16) is None:
        return  # this kernel does not take the layer

    _conv_s8_against_plain(tquant.quantize_act(x, s), wp, s, w_s, bias, k,
                           stride, plans)


def _generator_sites(filters, resnet_blocks):
    """(Cin, Cout, k, stride) of every w8a8 site of GeneratorJ."""
    from patch_toon_tpu_torch.models.generator import GeneratorJ
    from patch_toon_tpu_torch.models.layers import QuantConv2d
    gen = GeneratorJ(input_channels=6, filters=filters,
                     resnet_blocks=resnet_blocks, use_bias=True)
    return [(m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0])
            for m in gen.modules() if isinstance(m, QuantConv2d)]


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["shipped", "small"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int32])
def test_conv_plan_fits_every_generator_site(cuda, widths, dtype):
    """Every int8 site of GeneratorJ, at the shipped widths and the CPU
    tests' widths, gets a launch plan that fits in the card's 227 KB of
    shared memory and covers Cout in one N tile; the halo kernel only at
    stride 1 and Cout 33-64, the resident weight only in the gather
    kernel. A plan does not depend on the image's size."""
    filters, blocks = (((32, 64, 128, 128, 128, 64), 7) if widths ==
                       "shipped" else ((8, 16, 32, 32, 32, 16), 2))
    sites = _generator_sites(filters, blocks)
    assert len(sites) == 3 + 2 * blocks + 5
    for cin, cout, k, stride in sites:
        cp = tquant.padded_channels(cin)
        kp = -(-k * k * cp // tquant.KP_ALIGN) * tquant.KP_ALIGN
        p = tquant.conv_plan(cout, kp, dtype, k, stride)
        assert p.n_tiles == 1 and cout <= p.bn <= 128
        assert p.bn in (16, 32, 64, 128) and 2 <= p.stages <= 6
        assert 0 < p.smem_bytes <= 232448
        assert (p.variant == 1) == (stride == 1 and 32 < cout <= 64)
        if p.resident:
            assert p.variant == 0 and p.stages >= 3


@pytest.mark.cuda
def test_conv_plan_past_one_tile_and_odd_widths(cuda):
    """Cout past 128 walks tiles of 128 channels with the weight streamed;
    Cout below a tile takes the smallest N that covers it; a kernel that
    cannot take a layer has no plan for it."""
    kp = 9 * 64
    wide = tquant.conv_plan(256, kp, torch.bfloat16)
    assert (wide.bn, wide.n_tiles, wide.resident) == (128, 2, False)
    assert tquant.conv_plan(8, kp, torch.bfloat16).bn == 16
    assert tquant.conv_plan(40, kp, torch.float32).bn == 64
    assert tquant.conv_plan(2, kp, torch.int32).bn == 16
    assert tquant.conv_plan(40, kp, torch.float32, 3, 2).variant == 0
    for cout in (2, 8, 40, 64, 128, 192, 256):
        for dtype in (torch.bfloat16, torch.float32, torch.int32):
            assert tquant.conv_plan(cout, kp, dtype).smem_bytes <= 232448
    assert tquant._plan(64, kp, torch.float32, 3, 2, 1, False, 0) is None
    assert tquant._plan(128, kp, torch.float32, 3, 1, 1, False, 0) is None
    assert tquant._plan(256, kp, torch.float32, 3, 1, 0, True, 0) is None
    assert tquant._plan(64, kp, torch.float32, 3, 1, 0, False, 7) is None


@pytest.mark.cuda
def test_quant_kernels_refuse_what_they_cannot_take(cuda):
    x, s, wp, w_s, bias = _quant_case(9, 7, 32, 64, 3, 2, torch.float32,
                                      cuda, seed=0)
    with pytest.raises(ValueError):  # a type the kernel does not read
        tquant.quantize_act(x.double(), s)
    with pytest.raises(ValueError):  # not NHWC-contiguous
        tquant.quantize_act(x.permute(0, 2, 1, 3), s)
    with pytest.raises(ValueError):  # the scale elsewhere
        tquant.quantize_act(x, s.cpu())
    xq = tquant.quantize_act(x, s)
    args = (s, w_s, None, 3, 1, 1, torch.float32)
    with pytest.raises(ValueError):  # Cp not a multiple of 16
        tquant.conv_s8(xq[..., :24].contiguous(), wp, *args)
    with pytest.raises(ValueError):  # not contiguous
        tquant.conv_s8(xq.permute(0, 2, 1, 3), wp, *args)
    with pytest.raises(ValueError):  # not int8
        tquant.conv_s8(xq.float(), wp, *args)
    with pytest.raises(ValueError):  # a packed weight of another K
        tquant.conv_s8(xq, wp[:, :-32].contiguous(), *args)
    with pytest.raises(ValueError):  # a window the kernel does not take
        tquant.conv_s8(xq, wp, s, w_s, None, 5, 1, 2, torch.float32)
    with pytest.raises(ValueError):  # bias of another type
        tquant.conv_s8(xq, wp, s, w_s, bias.double(), 3, 1, 1,
                       torch.float32)
    with pytest.raises(ValueError):  # an output type it does not write
        tquant.conv_s8(xq, wp, s, w_s, None, 3, 1, 1, torch.float16)
    halo = tquant._plan(64, wp.shape[1], torch.float32, 3, 1, 1, False, 0)
    with pytest.raises(RuntimeError):  # a plan its kernel does not take
        tquant._conv_s8(xq, wp, s, w_s, None, 3, 2, 1, torch.float32, halo)


# ------------------------------------------------- several cards (2 or more)

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.cuda
def test_kernel_launches_keep_the_callers_current_device(two_cards):
    """Each C entry point launches on its tensor's card and puts the
    caller's current device back: B1 (cluster, split, resident, backward)
    and B2
    interleaved on cards 0 and 1 from either current device, each
    against its plain version; afterwards an index-free allocation lands
    on the current device."""
    gen, wts, pos, H, W = _blend_case(0, 64, 16, 200, 300)
    offsets, ids = tblend.bin_tiles(pos, H, W, 16)
    for current in (0, 1):
        torch.cuda.set_device(current)
        for card in two_cards * 2:
            x = _randn((2, 40, 40, 64), torch.float32, card, seed=1)
            y = instance_norm_act_cluster(x, "relu")
            assert torch.cuda.current_device() == current
            xs = _randn((1, 256, 456, 32), torch.float32, card, seed=2)
            ys = instance_norm_act_split(
                xs, "leaky_relu", p=split_plan(1, 256, 456, 32,
                                               torch.float32))
            assert torch.cuda.current_device() == current
            yr = instance_norm_act_resident(xs, "leaky_relu")
            assert torch.cuda.current_device() == current
            dy = _randn((2, 40, 40, 64), torch.float32, card, seed=3)
            _, mean, rstd = instance_norm_act_cluster(x, "relu", stats=True)
            dx = instance_norm_act_backward(x, dy, mean, rstd, "relu")
            assert torch.cuda.current_device() == current
            canvas, wcanvas = tblend.blend_tiles(
                torch.from_numpy(gen).to(card), torch.from_numpy(wts).to(
                    card), torch.from_numpy(pos).to(card),
                torch.from_numpy(offsets).to(card),
                torch.from_numpy(ids).to(card), H, W)
            assert torch.cuda.current_device() == current
            assert torch.empty(1, device="cuda").device.index == current
            for got in (y, ys, yr, dx, canvas):
                assert got.device == card
            torch.cuda.synchronize(card)
            want = instance_norm_act_plain(x.cpu(), "relu")
            np.testing.assert_allclose(y.cpu().numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)
            want_dx = instance_norm_act_backward_plain(
                x.cpu(), dy.cpu(), mean.cpu(), rstd.cpu(), "relu")
            np.testing.assert_allclose(dx.cpu().numpy(), want_dx.numpy(),
                                       rtol=2e-5, atol=2e-5)
            c_plain, w_plain = tblend.blend_tiles_plain(
                torch.from_numpy(gen), torch.from_numpy(wts),
                torch.from_numpy(pos), H, W)
            assert torch.equal(canvas.cpu(), c_plain)
            assert torch.equal(wcanvas.cpu(), w_plain)
            assert torch.isfinite(ys).all()
            np.testing.assert_allclose(
                yr.cpu().numpy(),
                instance_norm_act_plain(xs.cpu(), "leaky_relu").numpy(),
                rtol=1e-5, atol=1e-5)
    torch.cuda.set_device(0)


@pytest.mark.cuda
def test_quant_kernels_keep_the_callers_current_device(two_cards):
    """The int8 kernels launch on their tensors' card from either current
    device and put the caller's current device back, bitwise their plain
    versions."""
    for current in (0, 1):
        torch.cuda.set_device(current)
        for card in two_cards * 2:
            x, s, wp, w_s, bias = _quant_case(20, 20, 128, 128, 3, 2,
                                              torch.bfloat16, card, seed=1)
            xq = tquant.quantize_act(x, s)
            assert torch.cuda.current_device() == current
            y = tquant.conv_s8(xq, wp, s, w_s, bias, 3, 1, 1,
                               torch.bfloat16)
            assert torch.cuda.current_device() == current
            assert torch.empty(1, device="cuda").device.index == current
            assert xq.device == card and y.device == card
            assert torch.equal(xq, tquant.quantize_act_plain(x, s))
            assert torch.equal(y, tquant.conv_s8_plain(
                xq, wp, s, w_s, bias, 3, 1, 1, torch.bfloat16))
    torch.cuda.set_device(0)


@pytest.mark.cuda
def test_engine_names_its_cards(two_cards):
    """With card 1 current, an engine asked for ``cuda`` serves on card 0
    (the first it owns) and one at ``inference.devices=2`` on both: every
    replica, copy stream and staged frame names its card, a sharded
    group's outputs are each on its card and equal the one-card
    dispatch's, and the caller's current device is left alone. The flow
    graph captures and replays on its frame's card."""
    from patch_toon_tpu_torch.config.defaults import inference_config
    from patch_toon_tpu_torch.infer.engine import StyleTransferInference
    from patch_toon_tpu_torch.infer.temporal import (
        FlowGraphs,
        _temporal_device_flow,
    )

    ckpt = pathlib.Path(__file__).resolve().parents[1] / "docs" / \
        "quality_2000" / "torch_train.ckpt"
    torch.cuda.set_device(1)
    try:
        engines = [StyleTransferInference(inference_config(
            paths={"checkpoint": str(ckpt)},
            inference={"precision": "32", "devices": n})) for n in (1, 2)]
        one, two = engines
        assert one.cards == [two_cards[0]] and two.cards == two_cards
        for eng in engines:
            for card, model in zip(eng.cards, eng.models):
                assert {p.device for p in model.parameters()} == {card}
                assert eng.copy_streams[card].device == card
        assert torch.cuda.current_device() == 1
        rng = np.random.default_rng(0)
        h, w = 96, 176
        staged = []
        for i in range(4):
            parts = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                     rng.integers(0, 256, (h, w, 3), dtype=np.uint8)]
            boxes = two.boxes_for(None, (h, w))
            staged.append(two._stage(parts, None, boxes,
                                     pathlib.Path(f"{i}.png"), None, None,
                                     None, two.card_of(i)))
        assert [s.frame.device.index for s in staged] == [0, 1, 0, 1]
        two._pod_fpd = 2
        outs = two.dispatch_staged(staged)
        assert [o.device.index for o in outs] == [0, 0, 1, 1]
        on_0 = [one._to_card(s, two_cards[0]) for s in staged]
        want = torch.cat([one.dispatch_staged(on_0[:2]),
                          one.dispatch_staged(on_0[2:])])
        assert torch.equal(torch.stack([o.to(two_cards[0]) for o in outs]),
                           want)
        assert torch.cuda.current_device() == 1

        torch.cuda.set_device(0)
        frame = torch.from_numpy(rng.integers(0, 256, (h, w, 3),
                                              dtype=np.uint8)).to(two_cards[1])
        prev = torch.from_numpy(rng.integers(0, 256, (h, w),
                                             dtype=np.uint8)).to(two_cards[1])
        graphs = FlowGraphs()
        for _ in range(2):
            flow, gray = graphs(frame, prev, None, 1)
            assert torch.cuda.current_device() == 0
        eager_flow, eager_gray = _temporal_device_flow(frame, prev, None, 1)
        assert flow.device == two_cards[1] and graphs.captures == 1
        assert torch.equal(flow, eager_flow) and torch.equal(gray, eager_gray)
    finally:
        torch.cuda.set_device(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_parallel_site_kernels_on_two_cards(two_cards, dtype):
    """The shipped G and D (6 input channels, 7 blocks; 12 filters) at
    batch 4 of 80x80, eval mode: a model group of 2, rank r on card r,
    each sharded site's B1 launched on that card on its C/2 channels (at
    bf16 D's 24-channel site is 12 channels, 24 bytes a pixel: the
    streaming variant), the gathered outputs against the one-card
    forward."""
    import copy

    from patch_toon_tpu_torch.models.discriminator import DiscriminatorN_IN
    from patch_toon_tpu_torch.models.generator import GeneratorJ
    from patch_toon_tpu_torch.parallel.tp import (
        ModelShard,
        TurnGroup,
        shard_module_,
    )
    from patch_toon_tpu_torch.train.model import training_backends

    torch.manual_seed(0)
    nets = {"G": (GeneratorJ(input_channels=6, use_bias=True), 6),
            "D": (DiscriminatorN_IN(input_channels=3, num_filters=12,
                                    n_layers=2), 3)}
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    for tag, (whole, cin) in nets.items():
        x = _randn((4, 80, 80, cin), torch.float32, "cpu", seed=3).clamp(
            -1, 1).to(two_cards[0], dtype)
        whole = whole.to(two_cards[0], dtype,
                         memory_format=torch.channels_last).eval()
        with torch.no_grad(), training_backends(dtype):
            want = whole(x).float().cpu()
        group = TurnGroup(2)
        ranks = []
        for r, card in enumerate(two_cards):
            net = copy.deepcopy(whole).to(card)
            shard_module_(net, ModelShard(r, 2, group.member(r)))
            ranks.append((net, x.to(card)))
        for fn in VARIANTS.values():
            fn.by_device = {}

        def forward(net, xr):
            def run():
                with torch.no_grad():
                    return net(xr).float().cpu()
            return run

        with training_backends(dtype):  # fp32 without TF32
            outs = group.run([forward(n, xr) for n, xr in ranks])
        sites = 19 if tag == "G" else 2
        launched = {i: sum(fn.by_device.get(i, 0) for fn in VARIANTS.values())
                    for i in (0, 1)}
        assert launched == {0: sites, 1: sites}, (tag, launched)
        if tag == "D" and dtype == torch.bfloat16:
            assert instance_norm_act_streaming.by_device == {0: 1, 1: 1}
        for out in outs:
            assert float((out - want).abs().max()) <= tol, tag
