"""The port's on-device optical flow against the JAX package on the CPU.

Inputs come from seeded numpy generators at 64x96 and 96x160 (three pyramid
levels at scale 1). ``pil_gray`` is held bitwise (integer arithmetic); the
helpers (``_downsample2``, ``_gradients``, ``_box_filter``) bitwise too, as
they are the same fp32 operations in the same order; the flow resize within
1e-5 of ``jax.image.resize`` at |values| <= 4 (the weights are JAX's to the
bit; XLA's einsum on the CPU sums the taps less exactly than the port's
two-tap lerp: 5.7e-6 from an fp64 sum at 113x50 -> 227x101, the port 3.3e-7).
``dense_flow``, ``masked_flow``, the flow step and the flow tool within
2e-5 px max |d| and 1e-5 px at the 99.9th percentile on smooth frames
(measured at most 1.0e-5 and 5.7e-6), within 1e-3 and 1e-4 px on blocky
ones (flat squares), or within twice JAX's own spread where that is larger:
how far JAX's ``dense_flow`` moves when the first luma is moved by one ulp
at random pixels. On blocky frames LK's 2x2 systems are near-singular and
amplify roundoff, and JAX is no closer to itself than the port is to it: on
the flow tool's 64x96 scene one ulp moves JAX's flow by up to 8.0e-3 px
(3.9e-3 at the 99.9th percentile), and the port differs from JAX's files by
7.3e-3 and 3.5e-3. Against JAX's jitted flow step, which XLA fuses with the
luma's division, JAX's spread also counts how far that step is from its own
``dense_flow`` of the same luma: on the blocky 96x160 pair of seed 4, 7.5e-4
and 3.3e-4 px, with the port 7.4e-4 and 3.2e-4 from the step.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.infer import temporal as jax_temporal
from patch_toon_tpu.ops import flow as jax_flow

from patch_toon_tpu_torch.infer import temporal as port_temporal
from patch_toon_tpu_torch.ops import flow as port_flow
from patch_toon_tpu_torch.ops.resize import resize_bilinear_np

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZES = [(64, 96), (96, 160)]
# (max |d|, 99.9th percentile of |d|) in px, by kind of frame
BARS = {"smooth": (2e-5, 1e-5), "blocky": (1e-3, 1e-4)}


def _frames(kind: str, h: int, w: int, seed: int = 1):
    """Two (H, W, 3) uint8 frames, the second the first moved by (3, -2)
    px: smooth (a bilinear blow-up of coarse noise) or blocky (flat 10x10
    squares of random colour, like decoded cartoon footage)."""
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        coarse = rng.random((h // 8 + 3, w // 8 + 3, 3)).astype(
            np.float32) * 255
        big = resize_bilinear_np(coarse, (h + 16, w + 16)).astype(np.uint8)
    else:
        coarse = rng.integers(0, 256, (h // 10 + 3, w // 10 + 3, 3),
                              dtype=np.uint8)
        big = np.repeat(np.repeat(coarse, 10, 0), 10, 1)
    return (np.ascontiguousarray(big[4:4 + h, 4:4 + w]),
            np.ascontiguousarray(big[6:6 + h, 1:1 + w]))


def _grays(f1, f2):
    return [np.asarray(jax_flow.pil_gray(jnp.asarray(f))).astype(
        np.float32) / 255.0 for f in (f1, f2)]


def _jax_spread(g1, g2, scale=1, mask=None):
    """(max |d|, 99.9th percentile of |d|) of JAX's ``dense_flow`` when g1
    moves by one ulp up or down at random pixels (two draws)."""
    want = np.asarray(jax_flow.dense_flow(jnp.asarray(g1), jnp.asarray(g2),
                                          scale=scale))
    worst = tail = 0.0
    for seed in (0, 1):
        step = np.random.default_rng(seed).choice([-1, 0, 1], g1.shape)
        moved = (g1 + step.astype(np.float32) * np.spacing(g1)).astype(
            np.float32)
        d = np.abs(np.asarray(jax_flow.dense_flow(
            jnp.asarray(moved), jnp.asarray(g2), scale=scale)) - want)
        if mask is not None:
            d = d * mask[..., None]
        worst, tail = max(worst, d.max()), max(tail, np.quantile(d, 0.999))
    return worst, tail


def _assert_flow_close(got, want, kind, what, spread=(0.0, 0.0)):
    """Within BARS[kind], or twice JAX's own ``spread`` where larger."""
    assert got.shape == want.shape and got.dtype == np.float32
    d = np.abs(got - want)
    worst, tail = (max(b, 2 * s) for b, s in zip(BARS[kind], spread))
    assert d.max() <= worst and np.quantile(d, 0.999) <= tail, (
        what, float(d.max()), float(np.quantile(d, 0.999)))


@pytest.mark.parametrize("case", ["uint8", "signed_unit", "drift"])
def test_pil_gray_is_bitwise_jax_and_pil(case):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    rgb[0, :256 % 53] = 255  # every extreme present
    x = rgb
    if case != "uint8":  # the engine's [-1, 1] floats of those bytes
        x = rgb.astype(np.float32) / np.float32(255) * 2 - 1
    if case == "drift":  # within an ulp either way: round() absorbs it
        x = x + rng.choice([-1, 0, 1], x.shape).astype(np.float32) \
            * np.spacing(x)
    got = port_flow.pil_gray(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_flow.pil_gray(jnp.asarray(x)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(Image.fromarray(rgb).convert("L")))


@pytest.mark.parametrize("hw", SIZES + [(65, 97)])
def test_flow_helpers_are_bitwise_jax(hw):
    rng = np.random.default_rng(hw[0])
    img = rng.random(hw).astype(np.float32)
    np.testing.assert_array_equal(
        port_flow._downsample2(torch.from_numpy(img)).numpy(),
        np.asarray(jax_flow._downsample2(jnp.asarray(img))))
    for got, want in zip(port_flow._gradients(torch.from_numpy(img)),
                         jax_flow._gradients(jnp.asarray(img))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stack = rng.standard_normal(hw + (5,)).astype(np.float32)
    for k in (15, 7):
        np.testing.assert_array_equal(
            port_flow._box_filter(torch.from_numpy(stack), k).numpy(),
            np.asarray(jax.jit(jax_flow._box_filter, static_argnums=1)(
                jnp.asarray(stack), k)))


@pytest.mark.parametrize("src,dst", [((12, 20), (24, 40)),
                                     ((113, 50), (227, 101)),
                                     ((7, 9), (15, 19)),
                                     ((16, 24), (64, 96))])
def test_flow_resize_matches_jax_image_resize(src, dst):
    """Upsampling by 2, by a ratio that is not 2 (a 113-row level under a
    227-row one) and by 4, borders included."""
    rng = np.random.default_rng(sum(src))
    x = rng.standard_normal(src + (2,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst + (2,),
                                       "bilinear"))
    got = port_flow.resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for edge in (got[0], got[-1], got[:, 0], got[:, -1]):
        assert np.isfinite(edge).all()
    # the weights are JAX's, bit for bit
    from jax._src.image import scale as jax_scale

    for n_in, n_out in zip(src, dst):
        mat = np.asarray(jax_scale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, jax_scale._fill_triangle_kernel,
            False))
        lo, hi, wl, wh = port_flow._resize_taps(n_in, n_out)
        ours = np.zeros_like(mat)
        np.add.at(ours, (lo, np.arange(n_out)), wl)
        np.add.at(ours, (hi, np.arange(n_out)), wh)
        np.testing.assert_array_equal(ours, mat)


@pytest.mark.parametrize("kind", ["smooth", "blocky"])
@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("scale", [1, 2, 4])
def test_dense_flow_matches_jax(kind, hw, scale):
    g1, g2 = _grays(*_frames(kind, *hw))
    want = np.asarray(jax_flow.dense_flow(jnp.asarray(g1), jnp.asarray(g2),
                                          scale=scale))
    got = port_flow.dense_flow(torch.from_numpy(g1), torch.from_numpy(g2),
                               scale=scale).numpy()
    _assert_flow_close(got, want, kind, (hw, scale),
                       _jax_spread(g1, g2, scale))
    if scale == 1:  # the motion is found: (3, -2) px
        inner = got[16:-16, 16:-16]
        assert abs(np.median(inner[..., 0]) - 3.0) < 0.5
        assert abs(np.median(inner[..., 1]) + 2.0) < 0.5


@pytest.mark.parametrize("kind", ["smooth", "blocky"])
def test_masked_flow_and_the_device_flow_step_match_jax(kind):
    """``masked_flow`` against JAX's; ``_temporal_device_flow`` (luma of
    the frame, flow, mask) and ``_device_gray`` against JAX's jitted ones
    at scale 1 and 2, masked and not."""
    h, w = SIZES[1]
    f1, f2 = _frames(kind, h, w, seed=4)
    g1, g2 = _grays(f1, f2)
    mask = np.zeros((h, w), np.uint8)
    mask[10:80, 20:130] = 1
    want = np.asarray(jax_flow.masked_flow(jnp.asarray(g1), jnp.asarray(g2),
                                           jnp.asarray(mask > 0)))
    got = port_flow.masked_flow(torch.from_numpy(g1), torch.from_numpy(g2),
                                torch.from_numpy(mask > 0)).numpy()
    _assert_flow_close(got, want, kind, "masked_flow",
                       _jax_spread(g1, g2, 1, mask))
    assert (got[mask == 0] == 0).all() and (got[mask == 1] != 0).any()
    prev_gray = np.array(jax_temporal._device_gray(jnp.asarray(f2)))
    np.testing.assert_array_equal(
        port_temporal._device_gray(torch.from_numpy(f2)).numpy(), prev_gray)
    for scale in (1, 2):
        spread = _jax_spread(g1, prev_gray.astype(np.float32) / 255.0, scale)
        for fmask in (None, mask):
            wf, wg = jax_temporal._temporal_device_flow(
                jnp.asarray(f1), jnp.asarray(prev_gray),
                None if fmask is None else jnp.asarray(fmask), scale)
            gf, gg = port_temporal._temporal_device_flow(
                torch.from_numpy(f1), torch.from_numpy(prev_gray),
                None if fmask is None else torch.from_numpy(fmask), scale)
            np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
            # JAX against itself: the jitted step against dense_flow of the
            # same luma (XLA fuses the step with the luma's division)
            own = np.asarray(wf) - np.asarray(jax_flow.dense_flow(
                jnp.asarray(g1), jnp.asarray(prev_gray / np.float32(255)),
                scale=scale)) * (1 if fmask is None else fmask[..., None])
            own = np.abs(own)
            _assert_flow_close(gf.numpy(), np.asarray(wf), kind,
                               ("device flow", scale, fmask is None),
                               (max(spread[0], own.max()),
                                max(spread[1], np.quantile(own, 0.999))))


def test_flow_tool_matches_the_jax_tool(tmp_path):
    """``tools/optical_flow_torch.py --device cpu`` against
    ``tools/optical_flow.py`` (backend tpu, JAX on the CPU) over a 5-frame
    scene of moving squares with partial masks (.jpg and .png, luma 128
    inside the band that > 127 keeps): the same files, each within the
    blocky bars or twice JAX's spread on its pair; a missing mask stops
    both tools."""
    sys.path.insert(0, str(REPO / "tools"))
    import optical_flow as jax_tool
    import optical_flow_torch as port_tool

    h, w = SIZES[0]
    rng = np.random.default_rng(8)
    coarse = rng.integers(0, 256, (h // 8 + 6, w // 8 + 6, 3),
                          dtype=np.uint8)
    big = np.repeat(np.repeat(coarse, 8, 0), 8, 1)
    for sub in ("input", "mask"):
        (tmp_path / sub).mkdir()
    grays = []
    for i in range(5):
        frame = big[2 * i:2 * i + h, 3 * i:3 * i + w]
        Image.fromarray(frame).save(tmp_path / "input" / f"{i:03d}.png")
        grays.append(np.asarray(Image.fromarray(frame).convert("L")).astype(
            np.float32) / 255.0)
        m = np.zeros((h, w), np.uint8)
        m[8:56, 10:80] = 255
        m[8:56, 80:90] = 128
        ext = "jpg" if i % 2 else "png"
        Image.fromarray(m).save(tmp_path / "mask" / f"{i:03d}.{ext}")
    args = [tmp_path / "input", tmp_path / "mask"]
    jax_tool.OpticalFlowCalculator(
        args[0], tmp_path / "jfwd", tmp_path / "jbwd", args[1],
        backend="tpu").calculate_flows()
    assert port_tool.main([str(a) for a in args] + [
        str(tmp_path / "pfwd"), str(tmp_path / "pbwd"),
        "--device", "cpu"]) == 0
    for j, p, step in (("jfwd", "pfwd", -1), ("jbwd", "pbwd", 1)):
        names = sorted(f.name for f in (tmp_path / j).glob("*.npy"))
        assert names == sorted(f.name for f in (tmp_path / p).glob("*.npy"))
        assert len(names) == 4
        for name in names:
            i = int(name[:3])  # the flow of i to i - step
            want = np.load(tmp_path / j / name)
            got = np.load(tmp_path / p / name)
            src, dst = (i - 1, i) if step == -1 else (i, i - 1)
            _assert_flow_close(got, want, "blocky", (j, name),
                               _jax_spread(grays[src], grays[dst]))
    (tmp_path / "mask" / "002.png").unlink()
    assert port_tool.main([str(a) for a in args] + [
        str(tmp_path / "x"), str(tmp_path / "y"), "--device", "cpu"]) == 1
