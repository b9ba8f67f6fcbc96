"""The CUDA kernels of the port against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets JAX up.) Tolerances:
InstanceNorm fp32 1e-5 absolute and relative (sums in other orders); bf16
one bf16 ulp of the value plus 1e-5, as two fp32 results that differ in the
last bits may round to neighbouring bf16 values; the blend bit for bit.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.ops import blend as tblend  # noqa: E402
from patch_toon_tpu_torch import _build  # noqa: E402
from patch_toon_tpu_torch.ops.instance_norm import (  # noqa: E402
    CTA_BYTES,
    instance_norm_act,
    instance_norm_act_backward,
    instance_norm_act_backward_cluster,
    instance_norm_act_backward_plain,
    instance_norm_act_backward_streaming,
    instance_norm_act_cluster,
    instance_norm_act_plain,
    instance_norm_act_split,
    instance_norm_act_streaming,
    plan_backward_for,
    plan_for,
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
    full frame's plane) or, unaligned, to the streaming one; the cluster
    wrapper refuses both."""
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
    cases = [misaligned] + ([odd] if dtype == torch.bfloat16 else [])
    for x in cases:
        assert plan_for(x).variant == "streaming", tuple(x.shape)
        before = instance_norm_act_streaming.launches
        got = instance_norm_act(x, "relu")
        torch.cuda.synchronize()
        assert instance_norm_act_streaming.launches == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hwc,act", FULLFRAME_SITES)
def test_instance_norm_split_matches_plain_at_fullframe_shapes(cuda, dtype,
                                                                hwc, act):
    """The split variant, which the plan picks at every full-frame site,
    against the plain version (one launch counted), its statistics against
    the plain version's, and bitwise equal to a second call (the combine
    runs in a fixed order whichever CTA finishes last)."""
    x = _randn((1,) + hwc, dtype, cuda, seed=12)
    assert plan_for(x).variant == "split"
    before = {k: f.launches for k, f in
              dict(VARIANTS, split=instance_norm_act_split).items()}
    y, mean, rstd = instance_norm_act_split(x, act, stats=True)
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in
             dict(VARIANTS, split=instance_norm_act_split).items()}
    assert after == {k: v + (k == "split") for k, v in before.items()}
    _assert_in_close(y, instance_norm_act_plain(x, act), dtype)
    want_mean, want_rstd = _stats(x)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=1e-6)
    assert torch.equal(y, instance_norm_act_split(x, act))


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
               instance_norm_act_split):
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
            "streaming": instance_norm_act_backward_streaming}


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
    """What the backward cluster variant does not take (a full-frame plane,
    a misaligned x or dy, C = 12 at bf16) goes to the streaming variant,
    and the cluster wrapper refuses it."""
    full = (1, 540, 960, 128)
    base = _randn((2 * 20 * 20 * 32 + 1,), dtype, cuda, seed=11)
    aligned = _randn((2, 20, 20, 32), dtype, cuda, seed=12)
    misaligned = base[1:].view(2, 20, 20, 32)
    cases = [(_randn(full, dtype, cuda, seed=13),
              _randn(full, dtype, cuda, seed=14)),
             (misaligned, aligned), (aligned, misaligned)]
    if dtype == torch.bfloat16:
        odd = (2, 20, 20, 12)
        cases.append((_randn(odd, dtype, cuda, seed=15),
                      _randn(odd, dtype, cuda, seed=16)))
    for x, dy in cases:
        assert plan_backward_for(x, dy).variant == "streaming", x.shape
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
@pytest.mark.parametrize("shape", [(3, 20, 20, 24), (2, 540, 960, 32)])
def test_instance_norm_forward_writes_the_statistics(cuda, dtype, shape):
    """Every forward variant that takes the shape (the second shape goes to
    the split one, and the streaming one takes both) gives the plain
    version's mean and rstd with ``stats=True``: within 1e-5 relative,
    5e-5 for rstd of the 518,400-pixel plane, whose streaming sums add
    32,400 values a thread in sequence."""
    rtol = 5e-5 if shape[1] * shape[2] > 100_000 else 1e-5
    x = _randn(shape, dtype, cuda, seed=8)
    want_mean, want_rstd = _stats(x)
    picked = plan_for(x).variant
    for variant, fn in dict(VARIANTS, split=instance_norm_act_split).items():
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
        "cluster": b0["cluster"] + 1, "streaming": b0["streaming"]}
    mean, rstd = _stats(x)
    torch.testing.assert_close(dx, instance_norm_act_backward_plain(
        x, dy, mean, rstd, "leaky_relu"), rtol=2e-5, atol=2e-5)


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
            "cluster": b0["cluster"] + 9, "streaming": b0["streaming"]}
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
    streaming variant; in full-frame mode the 192x256 stem plane goes to
    the split variant and no B2 runs, tiled one B2 launch a frame."""
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
        fns = {**VARIANTS, "split": instance_norm_act_split,
               "blend": blend.blend_tiles}
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
    assert got["cluster"] + got["split"] == 7 * 6 and got["streaming"] == 0
    if mode == "tiled":
        assert got["split"] == 0 and got["blend"] == 6
    else:
        assert got["split"] >= 6 and got["blend"] == 0
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
