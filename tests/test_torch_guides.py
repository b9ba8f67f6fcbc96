"""The port's guide-channel tools against the JAX package, on the CPU.

Inputs from numpy seeds. Tolerances:

- ``poisson_disk_sample``: bit for bit (the same numpy code);
- ``sample_flow_bilinear``: bit for bit with JAX's op-by-op evaluation;
  ``advect_points`` (jitted in JAX, where XLA fuses the bilinear sum and
  the displacement into other roundings) within 2e-6 px absolute plus one
  ulp of the point (measured 3.8e-6 at a point near 58 px: that one ulp);
  validity bit for bit;
- the plain ``splat_points`` against JAX's ``lax.scan``: within 1e-6 (the
  CPU's exp and XLA's differ in the last bits; measured 3.0e-7);
- ``tools/gaussian_filter_torch.py`` and ``tools/temporal_guide_torch.py``
  on the CPU against ``tools/gaussian_filter.py`` and
  ``tools/temporal_guide.py``: every pixel of every PNG within 1 count.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.ops.advect import advect_points as jax_advect
from patch_toon_tpu.ops.advect import sample_flow_bilinear as jax_sample
from patch_toon_tpu.ops.poisson import golden_ratio_color as jax_color
from patch_toon_tpu.ops.poisson import poisson_disk_sample as jax_poisson
from patch_toon_tpu.ops.splat import splat_points as jax_splat

from patch_toon_tpu_torch.ops import splat as tsplat
from patch_toon_tpu_torch.ops.advect import (
    advect_points,
    sample_flow_bilinear,
)
from patch_toon_tpu_torch.ops.poisson import (
    golden_ratio_color,
    poisson_disk_sample,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import gaussian_filter as jax_gf  # noqa: E402
import gaussian_filter_torch as port_gf  # noqa: E402
import temporal_guide as jax_tg  # noqa: E402
import temporal_guide_torch as port_tg  # noqa: E402

H, W = 40, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: a test run shares the
    cores among its worker processes, and torch's thread pool then spends
    most of its time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ellipse(h, w, cy, cx, ry, rx):
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)


@pytest.mark.parametrize("seed,radius", [(0, 3.0), (3, 5.5)])
def test_poisson_disk_sample_bitwise(seed, radius):
    rng = np.random.default_rng(seed)
    mask = (_ellipse(H, W, 20, 30, 15, 25) * rng.integers(
        0, 256, (H, W))).astype(np.uint8)
    got = poisson_disk_sample(mask, radius, seed=seed)
    want = jax_poisson(mask, radius, seed=seed)
    assert len(got) > 10
    np.testing.assert_array_equal(got, want)
    assert golden_ratio_color(seed + 7) == jax_color(seed + 7)
    assert len(poisson_disk_sample(np.zeros((8, 8), np.uint8), 2.0)) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_and_advect_match_jax(seed):
    rng = np.random.default_rng(seed)
    flow = (rng.standard_normal((H, W, 2)) * 3).astype(np.float32)
    # points inside, on the border and outside the frame
    pts = np.stack([rng.uniform(-3, W + 3, 400),
                    rng.uniform(-3, H + 3, 400)], 1).astype(np.float32)
    pts[:4] = [[0, 0], [W - 1, H - 1], [W - 1e-3, 0.5], [-1e-3, 3]]
    valid = rng.random(400) > 0.1
    np.testing.assert_array_equal(
        sample_flow_bilinear(_t(flow), _t(pts)).numpy(),
        np.asarray(jax_sample(jnp.asarray(flow), jnp.asarray(pts))))
    p, v = _t(pts), _t(valid)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    for _ in range(3):  # three steps, invalid points frozen
        p, v = advect_points(_t(flow), p, v)
        jp, jv = jax_advect(jnp.asarray(flow), jp, jv)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        want = np.asarray(jp)
        d = np.abs(p.numpy() - want)
        assert (d <= 2e-6 + np.spacing(np.abs(want))).all(), d.max()
        p = _t(want)  # carry JAX's points so the steps stay comparable
    assert 0 < int(v.sum()) < 400


def _splat_case(seed, n=48):
    rng = np.random.default_rng(seed)
    img = rng.random((H, W, 3)).astype(np.float32)
    pts = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)],
                   1).astype(np.float32)
    # within r of each border and of each corner, and overlapping pairs
    pts[:10] = [[0, 0], [W - 1e-3, H - 1e-3], [0.4, H / 2], [W - 0.6, 7.5],
                [W / 2, 0.2], [11.5, H - 0.3], [20, 20], [20.25, 20.5],
                [20.5, 19.75], [1.9999, 1.0001]]
    cols = rng.random((n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.25
    valid[6:9] = True
    return img, pts, cols, valid


@pytest.mark.parametrize("sigma", [1.0, 2.5, 4.0, 6.7])
@pytest.mark.parametrize("seed", [0, 1])
def test_splat_plain_matches_jax(seed, sigma):
    img, pts, cols, valid = _splat_case(seed)
    want = np.asarray(jax_splat(jnp.asarray(img), jnp.asarray(pts),
                                jnp.asarray(cols), jnp.asarray(valid), sigma))
    got = tsplat.splat_points(_t(img), _t(pts), _t(cols), _t(valid), sigma)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got.numpy() != img).any()
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(got, tsplat.splat_points_plain(
        _t(img), _t(pts), _t(cols), _t(valid), sigma))


def test_invalid_points_leave_the_canvas_bitwise():
    img, pts, cols, _ = _splat_case(4)
    none = np.zeros(len(pts), bool)
    got = tsplat.splat_points(_t(img), _t(pts), _t(cols), _t(none), 3.0)
    np.testing.assert_array_equal(got.numpy(), img)
    want = np.asarray(jax_splat(jnp.asarray(img), jnp.asarray(pts),
                                jnp.asarray(cols), jnp.asarray(none), 3.0))
    np.testing.assert_array_equal(want, img)


@pytest.mark.parametrize("c,r,n,want", [
    (np.float32(0.0), 3, 10, (0, 3)),      # trunc(-3) = -3, cut at 0
    (np.float32(0.3), 3, 10, (0, 3)),      # trunc(-2.7) = -2: toward zero
    (np.float32(9.99), 3, 10, (6, 9)),     # floor 9 - 3; cut at n - 1
    (np.float32(5.5), 2, 20, (3, 7)),      # [3, 8] and [3, 7]
])
def test_splat_window_rule(c, r, n, want):
    assert tsplat._window(c, r, n) == want


# ------------------------------------------------------------ the tools

FRAMES, KEYS = 6, [1, 4, 6]


@pytest.fixture(scope="module")
def guide_scene(tmp_path_factory):
    """6 frames of 40x64: PNG masks (a drifting ellipse), seeded smooth
    flows ``%03d.npy`` forward and backward (backward 004 missing, which
    ends keyframe 4's forward run), RGB inputs and stylized outputs, and
    the temporal guide's backward flows (frame 3's missing)."""
    root = tmp_path_factory.mktemp("guides")
    rng = np.random.default_rng(7)
    for sub in ("mask", "flow_fwd", "flow_bwd", "input", "output"):
        (root / sub).mkdir()
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for f in range(1, FRAMES + 1):
        m = _ellipse(H, W, 18 + f, 24 + 2 * f, 13, 20)
        gray = np.where(m, 255, 0).astype(np.uint8)
        gray[0, :5] = 100  # a few pixels between the thresholds
        Image.fromarray(gray).save(root / "mask" / f"{f:03d}.png")
        for sub, sgn in (("flow_fwd", 1.0), ("flow_bwd", -1.0)):
            if sub == "flow_bwd" and f == 4:
                continue
            a, b = rng.uniform(-1, 1, 4), rng.uniform(0.5, 2.0)
            flow = np.stack([sgn * (2.0 + a[0] * np.sin(yy / 7 + a[1])),
                             sgn * (b * 0.5 + a[2] * np.cos(xx / 9 + a[3]))],
                            -1).astype(np.float32)
            np.save(root / sub / f"{f:03d}.npy", flow)
    for f in range(FRAMES):
        for sub in ("input", "output"):
            u8 = np.repeat(np.repeat(rng.integers(
                0, 256, (H // 4, W // 4, 3), dtype=np.uint8), 4, 0), 4, 1)
            Image.fromarray(u8).save(root / sub / f"{f:03d}.png")
    for i in range(1, FRAMES):  # backward flows of the temporal guide
        np.save(root / f"tg_{i:03d}.npy", (rng.standard_normal(
            (H, W, 2)) * 2).astype(np.float32))
    (root / "tg").mkdir()
    for i in range(1, FRAMES):
        if i != 3:
            (root / f"tg_{i:03d}.npy").rename(root / "tg" / f"{i:03d}.npy")
    return root


def _pngs(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(d.glob("*.png"))}


@pytest.mark.parametrize("sigma", [2.0, 3.5])
def test_gaussian_filter_tool_matches_jax(guide_scene, tmp_path, sigma,
                                          capsys):
    s = guide_scene
    args = dict(mask_dir=s / "mask", flow_fwd_dir=s / "flow_fwd",
                flow_bwd_dir=s / "flow_bwd", frame_first=1,
                frame_last=FRAMES, key_frames=KEYS, radius=4.0, sigma=sigma,
                max_points=40)
    jax_gf.GaussianFilter(output_dir=tmp_path / "jax", **args).process()
    jax_log = capsys.readouterr().out
    tool = port_gf.GaussianFilter(output_dir=tmp_path / "port",
                                  device="cpu", **args)
    tool.process()
    assert capsys.readouterr().out == jax_log  # the same messages
    assert "Warning: no flow data for frame 5" in jax_log
    assert {k: sorted(v) for k, v in tool.pts.items()} == {
        0: [1, 2, 3], 1: [2, 3, 4], 2: [5, 6]}
    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert sorted(got) == sorted(want) == [f"{f:03d}.png"
                                           for f in range(1, FRAMES + 1)]
    for name in want:
        assert got[name].shape == (H, W, 3)
        assert np.abs(got[name] - want[name]).max() <= 1, name
    assert all(v >= 0 for v in tool.seconds.values())


def test_gaussian_filter_cli_names_a_bad_frame(guide_scene, tmp_path,
                                               capsys):
    s = guide_scene
    (tmp_path / "mask").mkdir()
    for p in (s / "mask").iterdir():
        (tmp_path / "mask" / p.name).write_bytes(p.read_bytes())
    (tmp_path / "mask" / "002.png").write_bytes(b"not a png")
    assert port_gf.main([
        "--mask-dir", str(tmp_path / "mask"), "--flow-fwd-dir",
        str(s / "flow_fwd"), "--flow-bwd-dir", str(s / "flow_bwd"),
        "--output-dir", str(tmp_path / "out"), "--frame-first", "1",
        "--frame-last", "3", "--key-frames", "1", "--radius", "5",
        "--sigma", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Error processing frame 2" in out and "Saved frame 3" in out
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "001.png", "003.png"]


def test_temporal_guide_tool_matches_jax(guide_scene, tmp_path, capsys):
    s = guide_scene
    n = jax_tg.build_temporal_guides(s / "input", s / "output", s / "tg",
                                     tmp_path / "jax")
    m = port_tg.main([str(s / "input"), str(s / "output"), str(s / "tg"),
                      str(tmp_path / "port"), "--device", "cpu"])
    assert n == FRAMES and m == 0
    assert "no flow for frame 3; copying previous" in capsys.readouterr().out
    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == FRAMES
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 1, name
    # frame 0 is its input, frame 3 the previous stylized frame as it is
    np.testing.assert_array_equal(got["000.png"], _pngs(s / "input")[
        "000.png"])
    np.testing.assert_array_equal(got["003.png"], _pngs(s / "output")[
        "002.png"])


def test_the_port_tools_never_import_jax_or_the_jax_package():
    """As tests/test_torch_engine.py holds the package: no import of jax
    or of patch_toon_tpu (not followed by "_torch") and no module-level
    import of PIL in the port's guide tools."""
    import re

    anywhere = re.compile(r"^\s*(from|import)\s+(jax|flax|patch_toon_tpu"
                          r"(?!_torch)\b)", re.M)
    top = re.compile(r"^(from|import)\s+PIL\b", re.M)
    for name in ("gaussian_filter_torch.py", "temporal_guide_torch.py",
                 "imageprocessor_torch.py", "process_pipeline_torch.py",
                 "texture_mapper_torch.py"):
        text = (REPO / "tools" / name).read_text()
        assert not anywhere.search(text) and not top.search(text), name
