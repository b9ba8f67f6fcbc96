"""Kernels B1 (InstanceNorm + activation) and B2 (tile blend) of the port.

On the CPU each wrapper runs its plain PyTorch version; these tests hold the
plain versions to the JAX package's Pallas kernels (interpret mode) and
plain ops on the same numpy inputs. ``tests/test_torch_cuda.py`` holds the
CUDA kernels to these plain versions on a card.

Tolerances:
- fp32 InstanceNorm: 1e-5 absolute and relative, fp32 roundoff of sums
  taken in different orders;
- bf16 InstanceNorm: one bf16 ulp of the value (2^-7 relative) plus 1e-6,
  because the two sides may round a value that lies near a rounding
  boundary to its two neighbours: their fp32 statistics differ in the last
  bits, and the JAX plain path rounds to bf16 before LeakyReLU where the
  kernels round after;
- blend: the plain version is bit-identical to the ordered numpy sum of
  ``tests/test_pallas_blend.py`` (each product and each sum rounded once,
  tile by tile in ascending id), and the CUDA kernel bit-identical to the
  plain version. The JAX scan and the Pallas kernel agree within 1e-6
  absolute (a few fp32 ulps of sums below 4): XLA on the CPU fuses
  ``cur + tile * w`` into a contracted multiply-add, so their sums round
  differently in the last bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patch_toon_tpu.models.layers import instance_norm, leaky_relu
from patch_toon_tpu.ops import pallas_blend
from patch_toon_tpu.ops.pallas_norm import instance_norm_act as jax_in_act

from patch_toon_tpu_torch.ops import blend as tblend
from patch_toon_tpu_torch.ops.instance_norm import (
    CLUSTER_SIZES,
    CTA_BYTES,
    GROUPS,
    SPLIT_CTAS,
    Plan,
    _split_forward_plain,
    instance_norm_act,
    instance_norm_act_backward,
    instance_norm_act_backward_cluster,
    instance_norm_act_backward_plain,
    instance_norm_act_backward_streaming,
    instance_norm_act_cluster,
    instance_norm_act_plain,
    instance_norm_act_split,
    instance_norm_act_streaming,
    plan,
    plan_backward,
    split_plan,
)

ACTS = [None, "relu", "leaky_relu"]


def _bf16_exact(x32: np.ndarray) -> np.ndarray:
    """fp32 values that bf16 represents exactly (so both sides see the same
    bf16 input)."""
    return torch.from_numpy(x32).bfloat16().float().numpy()


def _assert_bf16_close(got: np.ndarray, want: np.ndarray) -> None:
    tol = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"{bad.sum()} values beyond one bf16 ulp, max |d| "
        f"{np.abs(got - want).max()}")


def _jax_plain(x, act):
    y = instance_norm(x)
    if act == "leaky_relu":
        y = leaky_relu(y, 0.2)
    elif act == "relu":
        y = jnp.maximum(y, 0)
    return y


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_plain_matches_jax(act, dtype):
    rng = np.random.default_rng(3)
    x32 = (rng.standard_normal((3, 12, 10, 40)) * 2.5 + 0.7).astype(
        np.float32)
    if dtype == "bfloat16":
        x32 = _bf16_exact(x32)
        xt = torch.from_numpy(x32).bfloat16()
        xj = jnp.asarray(x32).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x32), jnp.asarray(x32)
    got = instance_norm_act_plain(xt, act)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    got = got.float().numpy()
    for want in (jax_in_act(xj, act=act, interpret=True),
                 _jax_plain(xj, act)):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            _assert_bf16_close(got, want)


def test_instance_norm_wrapper_uses_plain_on_cpu():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, 7, 3)).astype(np.float32))
    want = instance_norm_act_plain(x, "leaky_relu")
    counters = (instance_norm_act_cluster, instance_norm_act_streaming)
    before = [f.launches for f in counters + (instance_norm_act_split,)]
    for wrapper in (instance_norm_act, *counters):
        assert torch.equal(wrapper(x, "leaky_relu"), want)
        with pytest.raises(ValueError):
            wrapper(x, "gelu")
    # the split variant runs its own arithmetic (chunks, then Chan's
    # combine) in plain PyTorch: fp32 roundoff from the two-pass version
    got = instance_norm_act_split(x, "leaky_relu")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        instance_norm_act_split(x, "gelu")
    # no launch on the CPU
    assert [f.launches for f in counters + (instance_norm_act_split,)] == \
        before


# the 19 InstanceNorm sites of one generator call at the shipped widths
# (filters 32/64/128/128/128, 7 residual blocks) on 80x80 tiles
MAIN_PATH_SITES = ([(80, 80, 32), (40, 40, 64), (20, 20, 128)]
                   + [(20, 20, 128)] * 14 + [(40, 40, 128), (80, 80, 128)])
# k per distinct site shape: the least cluster whose CTAs each hold at most
# CTA_BYTES of a 32-channel unit
MAIN_PATH_K = {
    torch.bfloat16: {(80, 80, 32): 4, (40, 40, 64): 1, (20, 20, 128): 1,
                     (40, 40, 128): 1, (80, 80, 128): 4},
    torch.float32: {(80, 80, 32): 8, (40, 40, 64): 2, (20, 20, 128): 1,
                    (40, 40, 128): 2, (80, 80, 128): 8},
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_instance_norm_plan_takes_every_main_path_site_to_the_cluster(dtype):
    assert len(MAIN_PATH_SITES) == 19
    for h, w, c in MAIN_PATH_SITES:
        p = plan(512, h, w, c, dtype, aligned=True)
        assert p.variant == "cluster", (h, w, c)
        assert p.group == 32
        assert p.k == MAIN_PATH_K[dtype][(h, w, c)], (h, w, c, p)
        assert p.cta_bytes == -(-h * w // p.k) * 32 * dtype.itemsize
        assert p.cta_bytes <= CTA_BYTES
        if p.k > 1:  # the least k: half as many CTAs would not fit
            assert -(-h * w // (p.k // 2)) * 32 * dtype.itemsize > CTA_BYTES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_instance_norm_plan_gives_the_streaming_variant_what_clusters_cannot_take(
        dtype):
    # a full-frame plane (A8): 540x960 pixels of a 32-channel unit need more
    # than 8 CTAs' slices, and at 16 channels too; it goes to the split
    # variant since it was added, and the streaming variant keeps only what
    # neither takes
    assert plan(1, 540, 960, 128, dtype, True).variant == "split"
    # a pointer that is not 16-byte aligned
    assert plan(2, 20, 20, 128, dtype, False).variant == "streaming"
    # C = 12: 24 bytes a pixel in bf16, not whole 16-byte vectors; in fp32
    # 48 bytes, taken in units of G = 4 channels
    p = plan(2, 20, 20, 12, dtype, True)
    if dtype == torch.bfloat16:
        assert p.variant == "streaming"
    else:
        assert p == Plan("cluster", 4, 1, 400 * 16)
    assert plan(2, 20, 20, 7, dtype, True).variant == "streaming"
    with pytest.raises(TypeError):
        plan(2, 20, 20, 32, torch.float16, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_instance_norm_plan_stays_within_its_limits(dtype):
    """k is a portable cluster size of at most 8, a CTA's slice stays within
    the budget, G is the largest that takes C in whole 16-byte vectors; the
    split variant takes a unit that no such cluster fits, in whole chunks;
    the streaming variant gets only what takes no whole 16-byte vectors."""
    item = dtype.itemsize
    for c in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256):
        whole = [g for g in GROUPS if c % g == 0 and (g * item) % 16 == 0]
        for h, w in ((1, 1), (7, 9), (79, 81), (80, 80), (160, 160),
                     (300, 300)):
            p = plan(3, h, w, c, dtype, True)
            if p.variant == "cluster":
                assert p.k in CLUSTER_SIZES and p.k <= 8
                assert 0 < p.cta_bytes <= CTA_BYTES
                assert p.group == max(whole)
            elif p.variant == "split":
                assert p.group == max(whole)
                assert -(-h * w // 8) * max(whole) * item > CTA_BYTES
                assert 0 < p.cta_bytes == p.ppc * p.group * item
                assert (p.chunks - 1) * p.ppc < h * w <= p.chunks * p.ppc
            else:
                assert p == Plan("streaming") and not whole


# the 19 InstanceNorm sites of a full-frame pass over a 512x910 frame
# (padded to 512x912): stem, downsamples, 14 residual, upsamples
FULLFRAME_SITES = ([(512, 912, 32), (256, 456, 64), (128, 228, 128)]
                   + [(128, 228, 128)] * 14
                   + [(256, 456, 128), (512, 912, 128)])
# (chunks a unit, pixels a chunk) of the split variant at each site shape:
# about SPLIT_CTAS CTAs a launch over the site's units of 32 channels
FULLFRAME_CHUNKS = {(512, 912, 32): (264, 1769), (256, 456, 64): (132, 885),
                    (128, 228, 128): (66, 443), (256, 456, 128): (66, 1769),
                    (512, 912, 128): (66, 7075)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_instance_norm_plan_takes_every_fullframe_site_to_the_split(dtype):
    """Every site of a full-frame pass goes to the split variant at G = 32,
    in about ``SPLIT_CTAS`` CTAs a launch; 540x960 frames too."""
    item = dtype.itemsize
    assert len(FULLFRAME_SITES) == 19
    for h, w, c in FULLFRAME_SITES:
        p = plan(1, h, w, c, dtype, aligned=True)
        assert p.variant == "split" and p.group == 32, (h, w, c, p)
        assert (p.chunks, p.ppc) == FULLFRAME_CHUNKS[(h, w, c)], p
        assert p.cta_bytes == p.ppc * 32 * item
        assert (p.chunks - 1) * p.ppc < h * w <= p.chunks * p.ppc
        assert SPLIT_CTAS <= c // 32 * p.chunks < SPLIT_CTAS + c // 32
    for h, w, c in ((540, 960, 32), (270, 480, 64), (135, 240, 128),
                    (270, 480, 128), (540, 960, 128)):
        assert plan(1, h, w, c, dtype, True).variant == "split"
    assert plan(1, 512, 912, 128, dtype, False).variant == "streaming"


def test_split_combine_matches_jax_at_a_large_mean():
    """The split variant's arithmetic (fp32 chunks, Chan's combine in fp64)
    on planes of mean 100 and standard deviation 1e-2, against JAX's
    ``instance_norm`` (two-pass fp32 over the whole plane). Both lose the
    same few fp32 ulps of 100 against a deviation of 1e-2, so the bound is
    the problem's own conditioning: 16 ulps of the largest |x|, times rstd.
    E[x^2] - E[x]^2 in fp32 misses it by orders of magnitude."""
    rng = np.random.default_rng(11)
    x = (100.0 + 1e-2 * rng.standard_normal((2, 37, 53, 32))).astype(
        np.float32)
    want = np.asarray(instance_norm(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    p = split_plan(2, 37, 53, 32, torch.float32, ctas=48)
    assert p.chunks > 20 and p.ppc * p.chunks > 37 * 53  # a ragged chunk
    got, mean, rstd = _split_forward_plain(xt, None, 0.2, 1e-5, p)
    tol = 16 * 2.0 ** -24 * float(np.abs(x).max()) * float(rstd.max())
    assert tol < 0.02
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # the statistics themselves: rstd of a 1e-2 deviation within 1e-3
    ref_std = x.astype(np.float64).std(axis=(1, 2))
    np.testing.assert_allclose(1.0 / rstd.numpy(),
                               np.sqrt(ref_std ** 2 + 1e-5), rtol=1e-3)
    naive_var = (torch.square(xt).mean(dim=(1, 2))
                 - torch.square(xt.mean(dim=(1, 2)))).clamp_min(0)
    naive = (xt - xt.mean(dim=(1, 2), keepdim=True)) * torch.rsqrt(
        naive_var[:, None, None] + 1e-5)
    assert np.abs(naive.numpy() - want).max() > 10 * tol


# the 25 InstanceNorm sites of a training step at the default widths: the
# generator's 19, then the discriminator's two in each of its 3 calls
TRAIN_SITES = MAIN_PATH_SITES + [(20, 20, 24), (19, 19, 48)] * 3
# (G, k) of the backward cluster variant per distinct site shape: a CTA
# holds x and dy, so the 80x80 units at fp32 fit 8 CTAs only at G = 16
TRAIN_BACKWARD_GK = {
    torch.bfloat16: {(80, 80, 32): (32, 8), (40, 40, 64): (32, 2),
                     (20, 20, 128): (32, 1), (40, 40, 128): (32, 2),
                     (80, 80, 128): (32, 8), (20, 20, 24): (8, 1),
                     (19, 19, 48): (16, 1)},
    torch.float32: {(80, 80, 32): (16, 8), (40, 40, 64): (32, 4),
                    (20, 20, 128): (32, 1), (40, 40, 128): (32, 4),
                    (80, 80, 128): (16, 8), (20, 20, 24): (8, 1),
                    (19, 19, 48): (16, 1)},
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_instance_norm_plan_backward_takes_every_training_site_to_the_cluster(
        dtype):
    item = dtype.itemsize
    assert len(TRAIN_SITES) == 25
    for h, w, c in TRAIN_SITES:
        p = plan_backward(80, h, w, c, dtype, aligned=True)
        assert p.variant == "cluster", (h, w, c)
        assert (p.group, p.k) == TRAIN_BACKWARD_GK[dtype][(h, w, c)], p
        assert p.cta_bytes == -(-h * w // p.k) * p.group * item * 2
        assert p.cta_bytes <= CTA_BYTES and p.k in CLUSTER_SIZES
        if p.k > 1:  # the least k: half as many CTAs would not fit
            assert -(-h * w // (p.k // 2)) * p.group * item * 2 > CTA_BYTES
        for g in GROUPS:  # the largest G whose unit fits 8 CTAs
            if g > p.group and c % g == 0 and (g * item) % 16 == 0:
                assert -(-h * w // 8) * g * item * 2 > CTA_BYTES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_instance_norm_plan_backward_gives_the_streaming_variant_what_clusters_cannot_take(
        dtype):
    # a full-frame plane (A8): even a unit of the least G needs more than 8
    # CTAs' slices of x and dy
    assert plan_backward(1, 540, 960, 128, dtype, True) == Plan("streaming")
    # a pointer of x or dy that is not 16-byte aligned
    assert plan_backward(2, 20, 20, 128, dtype, False) == Plan("streaming")
    # C = 12: 24 bytes a pixel in bf16, not whole 16-byte vectors; in fp32
    # 48 bytes, taken in units of G = 4 channels
    p = plan_backward(2, 20, 20, 12, dtype, True)
    if dtype == torch.bfloat16:
        assert p == Plan("streaming")
    else:
        assert p == Plan("cluster", 4, 1, 400 * 16 * 2)
    assert plan_backward(2, 20, 20, 7, dtype, True) == Plan("streaming")
    with pytest.raises(TypeError):
        plan_backward(2, 20, 20, 32, torch.float16, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_instance_norm_plan_backward_stays_within_its_limits(dtype):
    """k is a portable cluster size of at most 8, a CTA's slice of x and dy
    stays within the budget, and the streaming variant gets a shape only
    where no G that takes C in whole 16-byte vectors fits 8 CTAs."""
    item = dtype.itemsize
    for c in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256):
        whole = [g for g in GROUPS if c % g == 0 and (g * item) % 16 == 0]
        for h, w in ((1, 1), (7, 9), (79, 81), (80, 80), (160, 160),
                     (300, 300)):
            p = plan_backward(3, h, w, c, dtype, True)
            if p.variant == "cluster":
                assert p.k in CLUSTER_SIZES and p.k <= 8
                assert 0 < p.cta_bytes <= CTA_BYTES
                assert p.group in whole
            else:
                assert p == Plan("streaming")
                assert not whole or \
                    -(-h * w // 8) * min(whole) * item * 2 > CTA_BYTES


@pytest.mark.parametrize("act", ACTS)
def test_instance_norm_backward_wrappers_use_plain_on_cpu(act):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, 16)).astype(
        np.float32))
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    mean = x.mean(dim=(1, 2))
    rstd = torch.rsqrt(x.var(dim=(1, 2), unbiased=False) + 1e-5)
    want = instance_norm_act_backward_plain(x, dy, mean, rstd, act)
    counters = (instance_norm_act_backward_cluster,
                instance_norm_act_backward_streaming)
    before = [f.launches for f in counters]
    for wrapper in (instance_norm_act_backward, *counters):
        assert torch.equal(wrapper(x, dy, mean, rstd, act), want)
        with pytest.raises(ValueError):
            wrapper(x, dy, mean, rstd, "gelu")
    assert [f.launches for f in counters] == before  # no launch on the CPU


def _blend_case(seed, B=14, ps=16, H=70, W=90):
    """The inputs of tests/test_pallas_blend.py, padding tiles included."""
    rng = np.random.default_rng(seed)
    gen = rng.random((B, ps, ps, 3)).astype(np.float32)
    wts = rng.random((B, ps, ps)).astype(np.float32)
    pos = np.stack([rng.integers(0, H - ps, B),
                    rng.integers(0, W - ps, B)], 1).astype(np.int32)
    wts[-2:] = 0
    pos[-2:] = -10000
    return gen, wts, pos, H, W


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_tiles_equals_jax(seed):
    gen, wts, pos, H, W = _blend_case(seed)
    rng = np.random.default_rng(seed)
    big = np.stack([rng.integers(0, 700, 60), rng.integers(0, 1000, 60)],
                   1).astype(np.int32)
    big[::7] = -10000
    for p, h, w, ps in ((pos, H, W, 16), (big, 780, 1080, 80),
                        (np.array([[0, 0], [250, 250], [100, 500],
                                   [-10000, -10000]], np.int32),
                         512, 768, 80)):
        want_o, want_i = pallas_blend.bin_tiles(p, h, w, ps)
        got_o, got_i = tblend.bin_tiles(p, h, w, ps, by=256, bx=256)
        np.testing.assert_array_equal(got_o, want_o)
        np.testing.assert_array_equal(got_i, want_i)


def test_bin_tiles_small_blocks_cover_every_pixel_once():
    gen, wts, pos, H, W = _blend_case(0, B=30, ps=40, H=200, W=150)
    offs, ids = tblend.bin_tiles(pos, H, W, 40)
    nbx = -(-W // tblend.BLOCK)
    for b in range(len(offs) - 1):
        lst = ids[offs[b]:offs[b + 1]]
        assert (np.diff(lst) > 0).all()  # ascending tile order
        by0, bx0 = (b // nbx) * tblend.BLOCK, (b % nbx) * tblend.BLOCK
        for t in range(len(pos)):
            y, x = pos[t]
            hit = (y >= 0 and y < by0 + tblend.BLOCK and y + 40 > by0
                   and x < bx0 + tblend.BLOCK and x + 40 > bx0)
            assert hit == (t in lst)


def _ordered_sum(gen, wts, pos, H, W):
    """The numpy reference of tests/test_pallas_blend.py."""
    ps = gen.shape[1]
    ref = np.zeros((H, W, 3), np.float32)
    refw = np.zeros((H, W, 1), np.float32)
    for t in range(len(pos)):
        y, x = pos[t]
        if y < 0:
            continue
        ref[y:y + ps, x:x + ps] += gen[t] * wts[t][..., None]
        refw[y:y + ps, x:x + ps] += wts[t][..., None]
    return ref, refw


@pytest.mark.parametrize("seed", [0, 1])
def test_blend_plain_matches_pallas_interpret(seed):
    gen, wts, pos, H, W = _blend_case(seed)
    offs, ids = pallas_blend.bin_tiles(pos, H, W, 16)
    want_c, want_w = pallas_blend.blend_tiles(
        jnp.asarray(gen), jnp.asarray(wts), jnp.asarray(pos),
        jnp.asarray(offs), jnp.asarray(ids), H, W, interpret=True)
    got_c, got_w = tblend.blend_tiles_plain(
        torch.from_numpy(gen), torch.from_numpy(wts), pos, H, W)
    ref_c, ref_w = _ordered_sum(gen, wts, pos, H, W)
    np.testing.assert_array_equal(got_c.numpy(), ref_c)
    np.testing.assert_array_equal(got_w.numpy(), ref_w)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0,
                               atol=1e-6)


def _jax_scan_blend(gen, wts, pos, H, W):
    """The engine's lax.scan blend (patch_toon_tpu/infer/programs.py:
    213-227) on a flat canvas; padding tiles sit at (0, 0) with zero
    weight, as pack_boxes_multi leaves them."""
    ps = gen.shape[1]
    anchor = np.where(pos < 0, 0, pos).astype(np.int32)

    def body(carry, inp):
        cv_, wv_ = carry
        tile, weight, p = inp
        contrib = tile * weight[..., None]
        cur = jax.lax.dynamic_slice(cv_, (p[0], p[1], 0), (ps, ps, 3))
        cv_ = jax.lax.dynamic_update_slice(cv_, cur + contrib,
                                           (p[0], p[1], 0))
        curw = jax.lax.dynamic_slice(wv_, (p[0], p[1], 0), (ps, ps, 1))
        wv_ = jax.lax.dynamic_update_slice(wv_, curw + weight[..., None],
                                           (p[0], p[1], 0))
        return (cv_, wv_), None

    init = (jnp.zeros((H, W, 3), jnp.float32), jnp.zeros((H, W, 1),
                                                          jnp.float32))
    (c, w), _ = jax.jit(lambda a, b, p: jax.lax.scan(body, init, (a, b, p)))(
        jnp.asarray(gen), jnp.asarray(wts), jnp.asarray(anchor))
    return np.asarray(c), np.asarray(w)


@pytest.mark.parametrize("seed", [0, 3])
def test_blend_wrapper_matches_scan(seed):
    gen, wts, pos, H, W = _blend_case(seed, B=40, ps=24, H=120, W=150)
    gen = gen * 2 - 1  # tanh range: signed products
    want_c, want_w = _jax_scan_blend(gen, wts, pos, H, W)
    offs, ids = tblend.bin_tiles(pos, H, W, 24)
    before = tblend.blend_tiles.launches
    got_c, got_w = tblend.blend_tiles(torch.from_numpy(gen),
                                      torch.from_numpy(wts), pos, offs, ids,
                                      H, W)
    assert tblend.blend_tiles.launches == before
    ref_c, ref_w = _ordered_sum(gen, wts, pos, H, W)
    np.testing.assert_array_equal(got_c.numpy(), ref_c)
    np.testing.assert_array_equal(got_w.numpy(), ref_w)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-6)


def _fake_nvcc(tmp_path, script):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_build_names_library_by_sources_and_reports_nvcc_errors(
        tmp_path, monkeypatch):
    from patch_toon_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path = _build.library_path()
    assert path.parent == tmp_path / "build" and path == _build.library_path()
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(
        tmp_path, 'echo "error: bad kernel" >&2\nexit 2\n')))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []  # nothing left behind


def test_build_moves_the_finished_library_into_place(tmp_path, monkeypatch):
    from patch_toon_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # a stand-in compiler: reports like ptxas -v and writes its -o argument
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(
        tmp_path, 'echo "ptxas info : Used 40 registers" >&2\n'
                  'while [ "$1" != "-o" ]; do shift; done\n'
                  'echo lib > "$2"\n')))
    out = _build.build()
    assert out == _build.library_path() and out.read_text() == "lib\n"
    # the library and, beside it, what the compiler printed
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [out.name, out.with_suffix(".log").name])
    assert _build.build() == out and _build.last_build_seconds == 0.0
    assert "Used 40 registers" in _build.last_build_log  # reused, reported
