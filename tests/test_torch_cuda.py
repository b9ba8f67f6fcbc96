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
    instance_norm_act_cluster,
    instance_norm_act_plain,
    instance_norm_act_streaming,
    plan_for,
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
    """What the cluster variant does not take goes to the streaming one,
    and the cluster wrapper refuses it."""
    full = _randn((1, 540, 960, 128), dtype, cuda, seed=3)  # a full frame
    base = _randn((2 * 20 * 20 * 32 + 1,), dtype, cuda, seed=4)
    misaligned = base[1:].view(2, 20, 20, 32)
    odd = _randn((2, 20, 20, 12), dtype, cuda, seed=5)  # C = 12
    cases = [full, misaligned] + ([odd] if dtype == torch.bfloat16 else [])
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


@pytest.mark.cuda
def test_instance_norm_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn(2, 8, 8, 32, device=cuda)
    for fn in (instance_norm_act, *VARIANTS.values()):
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
