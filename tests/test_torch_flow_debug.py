"""The port's flow debug overlays and the flow tool's ``--backend`` flag,
on the CPU.

``tools/flow_debug_torch.py`` against ``tools/flow_debug.py`` on frames and
flows made from numpy seeds (small, large and zero flows, arrows that
leave the frame, a JPEG frame, a missing pair): the overlays pixel for
pixel (no tolerance: the same integer arithmetic, and Pillow's width-1
lines), the same console lines and files, through the functions, the
object and the command line's flags. ``tools/optical_flow_torch.py``
takes the JAX tool's ``--backend tpu``, and ``--backend dis`` (OpenCV's
DIS) gives the JAX tool's files bitwise where OpenCV is installed and is
refused by a message naming OpenCV where it is not.
"""

import pathlib
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import flow_debug as jax_fd  # noqa: E402
import flow_debug_torch as port_fd  # noqa: E402
import optical_flow_torch  # noqa: E402

from patch_toon_tpu_torch.native import frameio  # noqa: E402

H, W = 61, 83


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Five frames (the third a JPEG) and flows for pairs 1-3 (pair 4 has
    no flow): a smooth swirl, a large shift, and all zeros."""
    root = tmp_path_factory.mktemp("flow_debug")
    rng = np.random.default_rng(5)
    (root / "in").mkdir()
    (root / "flow").mkdir()
    for i in range(1, 6):
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        if i == 3:
            Image.fromarray(img).save(root / "in" / f"{i:03d}.jpg",
                                      quality=90)
        else:
            Image.fromarray(img).save(root / "in" / f"{i:03d}.png")
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    swirl = np.stack([(yy - H / 2) * 0.2, -(xx - W / 2) * 0.15], -1)
    shift = np.stack([np.full_like(xx, 17.3), np.full_like(yy, -9.6)], -1)
    noisy = swirl + rng.standard_normal(swirl.shape).astype(np.float32)
    for i, f in ((1, noisy), (2, shift), (3, np.zeros_like(swirl))):
        np.save(root / "flow" / f"{i:03d}.npy", f.astype(np.float32))
    return root


def _pngs(d):
    return {p.name: np.asarray(Image.open(p)) for p in sorted(d.glob("*"))}


def test_pillow_lines_and_points_bitwise():
    """draw_line / draw_point against ImageDraw at width 1 on random
    segments (inside, across and outside the frame, axis-aligned,
    diagonal, zero length)."""
    rng = np.random.default_rng(0)
    for t in range(2000):
        img = np.zeros((23, 31, 3), np.uint8)
        pil = Image.fromarray(img.copy())
        draw = ImageDraw.Draw(pil)
        p0 = tuple(rng.uniform(-8, 40, 2))
        p1 = tuple(rng.uniform(-8, 40, 2))
        if t % 5 == 0:
            p1 = (p0[0] + rng.uniform(-1, 1), p0[1])
        if t % 11 == 0:
            p1 = (p0[0] + 5, p0[1] - 5)
        draw.line([p0, p1], fill=(255, 100, 0), width=1)
        draw.point([(int(p1[0]), int(p1[1]))], fill=(9, 8, 7))
        port_fd.draw_line(img, p0, p1, (255, 100, 0))
        port_fd.draw_point(img, int(p1[0]), int(p1[1]), (9, 8, 7))
        np.testing.assert_array_equal(img, np.asarray(pil), str((p0, p1)))


@pytest.mark.parametrize("grid,scale", [(20, 1.0), (7, 2.5), (13, 0.05)])
def test_overlays_equal_the_jax_tools(frames, tmp_path, capsys, grid,
                                      scale):
    n_jax = jax_fd.visualize_pairs(frames / "in", frames / "flow",
                                   tmp_path / "jax", grid_size=grid,
                                   flow_scale=scale)
    want_log = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    frameio.zero_decode_counts()
    n_port = port_fd.visualize_pairs(frames / "in", frames / "flow",
                                     tmp_path / "port", grid_size=grid,
                                     flow_scale=scale)
    assert capsys.readouterr().out.replace(
        str(tmp_path / "port"), "OUT") == want_log
    assert n_port == n_jax == 3
    assert frameio.decode_counts()["pil"] == 0
    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert sorted(got) == sorted(want) == [
        "flow_001.png", "flow_002.png", "flow_003.png"]
    for name in want:
        assert got[name].shape == (H, W, 3)
        np.testing.assert_array_equal(got[name], want[name], name)


def test_flags_object_and_skips(frames, tmp_path, capsys):
    """--start/--end/--skip/--scale/--grid through main(), the object
    form, and a pair with no flow reported and skipped."""
    args = ["--start", "2", "--end", "4", "--skip", "2", "--scale", "1.5",
            "--grid", "9"]
    assert port_fd.main([str(frames / "in"), str(frames / "flow"),
                         str(tmp_path / "port")] + args) == 0
    log = capsys.readouterr().out
    assert "Skipped frame 4 (missing frame or flow)" in log
    assert f"Wrote 1 flow overlays to {tmp_path / 'port'}" in log
    jax_fd.FlowDebugVisualizer(frames / "in", frames / "flow",
                               tmp_path / "jax", frame_start=2, frame_end=4,
                               skip_frames=2, flow_scale=1.5,
                               grid_size=9).visualize_all()
    capsys.readouterr()
    port_fd.FlowDebugVisualizer(frames / "in", frames / "flow",
                                tmp_path / "obj", frame_start=2,
                                frame_end=4, skip_frames=2, flow_scale=1.5,
                                grid_size=9).visualize_all()
    want = _pngs(tmp_path / "jax")
    assert list(want) == ["flow_002.png"]
    for d in ("port", "obj"):
        np.testing.assert_array_equal(_pngs(tmp_path / d)["flow_002.png"],
                                      want["flow_002.png"])
    with pytest.raises(ValueError, match="No flow files"):
        port_fd.visualize_pairs(frames / "in", tmp_path / "none",
                                tmp_path / "x")


def test_optical_flow_tool_backend_flag(frames, tmp_path, capsys,
                                       monkeypatch):
    """Without OpenCV ``--backend dis`` is refused by name before any
    work; ``--scale 2`` with it is refused as the JAX tool refuses it."""
    inp = tmp_path / "in"
    inp.mkdir()
    (tmp_path / "mask").mkdir()
    for i in (1, 2):
        img = np.asarray(Image.open(frames / "in" / f"{i:03d}.png"))
        Image.fromarray(img).save(inp / f"{i:03d}.png")
        Image.fromarray(np.full((H, W), 255, np.uint8)).save(
            tmp_path / "mask" / f"{i:03d}.png")
    base = [str(inp), str(tmp_path / "mask"), str(tmp_path / "fwd"),
            str(tmp_path / "bwd"), "--device", "cpu"]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert optical_flow_torch.main(base + ["--backend", "dis"]) == 1
    assert "needs OpenCV" in capsys.readouterr().out
    assert not (tmp_path / "fwd").exists()
    assert optical_flow_torch.main(
        base + ["--backend", "dis", "--scale", "2"]) == 1
    assert "--scale requires the tpu backend" in capsys.readouterr().out
    assert not (tmp_path / "fwd").exists()
    assert optical_flow_torch.main(base + ["--backend", "tpu"]) == 0
    for d in ("fwd", "bwd"):
        files = sorted((tmp_path / d).glob("*.npy"))
        assert len(files) == 1 and np.load(files[0]).shape == (H, W, 2)


def test_dis_backend_files_are_the_jax_tools(frames, tmp_path):
    """``--backend dis`` against ``tools/optical_flow.py --backend dis`` on
    five frames (one a JPEG) with masks that cut the flow: the same files,
    bitwise."""
    pytest.importorskip("cv2")
    import optical_flow as jax_of

    rng = np.random.default_rng(8)
    (tmp_path / "mask").mkdir()
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(5):
        m = ((yy - H / 2 - 3 * i) ** 2 + (xx - W / 2) ** 2 < 600) * 255
        m = np.clip(m + rng.integers(-40, 40, (H, W)), 0, 255)
        Image.fromarray(m.astype(np.uint8)).save(
            tmp_path / "mask" / f"{i:03d}.png")
    args = [str(frames / "in"), str(tmp_path / "mask")]
    assert optical_flow_torch.main(
        args + [str(tmp_path / "pf"), str(tmp_path / "pb"), "--backend",
                "dis", "--device", "cpu"]) == 0
    jax_of.OpticalFlowCalculator(frames / "in", tmp_path / "jf",
                                 tmp_path / "jb", tmp_path / "mask",
                                 backend="dis").calculate_flows()
    for port, jax in (("pf", "jf"), ("pb", "jb")):
        names = sorted(p.name for p in (tmp_path / jax).glob("*.npy"))
        assert len(names) == 4
        assert sorted(p.name for p in (tmp_path / port).glob("*.npy")) \
            == names
        for name in names:
            got = np.load(tmp_path / port / name)
            want = np.load(tmp_path / jax / name)
            assert got.dtype == want.dtype == np.float32
            assert np.abs(want).max() > 0 and (want == 0).any()
            np.testing.assert_array_equal(got, want, name)
