"""The port's guide pipeline tools against the JAX tools, on the CPU.

``tools/imageprocessor_torch.py``, ``tools/process_pipeline_torch.py`` and
``tools/texture_mapper_torch.py`` against ``tools/imageprocessor.py``,
``tools/process_pipeline.py`` (flow backend ``tpu``, and the ``dis``
backend's flows where OpenCV is installed, bitwise) and
``tools/texture_mapper.py`` on small RGBA scenes made from numpy seeds.
Tolerances:

- the resized scene (``input/``, ``mask/``, ``output/``, ``tracking/``):
  byte for byte, and the same console lines;
- the flows: ``tests/test_torch_flow.py``'s bar, 1e-3 px max and 1e-4 px
  at the 99.9th percentile, or twice JAX's one-ulp spread;
- the guides: within 1 count when the port's guide step reads JAX's flows;
  when each side reads its own flows, within 2 counts. The two flows
  differ by the flow bar's 1e-3 px at most, so an advected point moves by
  at most that a frame, 5e-3 px over the 5 frames of a keyframe's run; a
  splat of sigma 10 or 15 changes by at most exp(-1/2) / sigma of its
  colour a pixel of displacement there, under 1e-3 of a count, which can
  tip one rounding by 1 count on top of the 1 count of the splat's own
  arithmetic;
- the texture map: bitwise.
"""

import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import imageprocessor as jax_ip  # noqa: E402
import imageprocessor_torch as port_ip  # noqa: E402
import process_pipeline as jax_pp  # noqa: E402
import process_pipeline_torch as port_pp  # noqa: E402
import texture_mapper as jax_tm  # noqa: E402
import texture_mapper_torch as port_tm  # noqa: E402
from gaussian_filter_torch import GaussianFilter  # noqa: E402

from patch_toon_tpu_torch.native import frameio  # noqa: E402

H, W, FRAMES = 58, 90, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """``FRAMES`` RGBA frames of H x W (a textured plane panning under a
    moving alpha ellipse, soft-edged), RGB ``output/`` companions (one a
    JPEG named .png, one with no input frame of its stem), gray
    ``tracking/`` PNGs, and a corrupt ``input/zz_bad.png``."""
    root = tmp_path_factory.mktemp("scene") / "src"
    rng = np.random.default_rng(21)
    big = np.repeat(np.repeat(rng.integers(
        0, 256, (H // 3 + 4, W // 3 + 6, 3), dtype=np.uint8), 3, 0), 3, 1)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for sub in ("input", "output", "tracking"):
        (root / sub).mkdir(parents=True)
    for i in range(1, FRAMES + 1):
        rgb = big[FRAMES - i:FRAMES - i + H, 2 * (FRAMES - i):
                  2 * (FRAMES - i) + W]
        r = ((yy - H * 0.5 - i) / (H * 0.35)) ** 2 \
            + ((xx - W * 0.4 - 2 * i) / (W * 0.3)) ** 2
        alpha = np.clip((1.2 - r) * 600, 0, 255).astype(np.uint8)
        Image.fromarray(np.dstack([rgb, alpha]), "RGBA").save(
            root / "input" / f"{i:03d}.png")
        out = np.ascontiguousarray(rgb[::-1])
        if i == 2:
            Image.fromarray(out).save(root / "output" / f"{i:03d}.png",
                                      format="JPEG", quality=90)
        else:
            Image.fromarray(out).save(root / "output" / f"{i:03d}.png")
        Image.fromarray(rgb[..., 1]).save(root / "tracking" / f"{i:03d}.png")
    Image.fromarray(big[:30, :40]).save(root / "output" / "extra.jpg")
    (root / "input" / "zz_bad.png").write_bytes(b"not an image at all")
    return root


def _files(d: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_imageprocessor_writes_the_jax_tools_bytes(scene, tmp_path, capsys):
    jax_ip.ImageProcessor(scene, tmp_path / "jax", size_mode="width",
                          size_value=61).process_directory()
    want_log = capsys.readouterr().out
    frameio.zero_decode_counts()
    tool = port_ip.ImageProcessor(scene, tmp_path / "port",
                                  size_mode="width", size_value=61)
    tool.process_directory()
    assert capsys.readouterr().out == want_log
    assert "Could not read size of zz_bad.png" in want_log
    assert "Failed on zz_bad.png" in want_log
    assert "Scene resized: 16/17 images (1 failed)" in want_log
    for sub in ("input", "mask", "output", "tracking"):
        want, got = _files(tmp_path / "jax" / sub), _files(
            tmp_path / "port" / sub)
        assert sorted(got) == sorted(want) and got, sub
        for name in want:
            assert got[name] == want[name], f"{sub}/{name}"
    with Image.open(tmp_path / "port" / "input" / "001.png") as img:
        assert img.format == "JPEG" and img.size == (61, 39)
    # the two JPEG companions went through the codec; PIL read only the
    # corrupt file (its header, then the job)
    assert frameio.decode_counts() == {"png": 14, "jpeg": 2, "pil": 2}
    assert set(tool.seconds) == {"decode", "resize", "encode"}


def test_imageprocessor_scale_and_nothing_to_do(scene, tmp_path, capsys):
    for mod, name in ((jax_ip, "jax"), (port_ip, "port")):
        mod.ImageProcessor(scene, tmp_path / name, size_mode="scale",
                           size_value=1.5).process_directory()
    for sub in ("input", "mask"):
        assert _files(tmp_path / "jax" / sub) == _files(
            tmp_path / "port" / sub)
    capsys.readouterr()
    empty = tmp_path / "empty"
    (empty / "input").mkdir(parents=True)
    assert port_ip.main([str(empty), str(tmp_path / "o")]) == 0
    assert capsys.readouterr().out.startswith("Nothing to do: no images")


@pytest.mark.parametrize("source", ["jpeg_com", "png_comment"])
def test_imageprocessor_carries_the_source_comment(scene, tmp_path, capsys,
                                                   source):
    """A source's comment (a JPEG's COM segment; a PNG's ``comment`` text
    chunk, tEXt in Latin-1 or iTXt in UTF-8) reaches the resized file and
    its mask in a COM segment after APP0, as Pillow's ``save`` writes
    ``info["comment"]``: byte for byte the JAX tool's files."""
    from PIL import PngImagePlugin

    src = tmp_path / "src"
    for sub in ("input", "output", "tracking"):
        (src / sub).mkdir(parents=True)
    rgba = np.asarray(Image.open(scene / "input" / "001.png"))
    if source == "jpeg_com":
        Image.fromarray(rgba[..., :3]).save(
            src / "input" / "001.png", format="JPEG", quality=90,
            comment=b"first \xff comment")
        Image.fromarray(rgba[::-1, :, :3]).save(
            src / "output" / "001.jpg", quality=90, comment=b"c" * 300)
    else:
        info = PngImagePlugin.PngInfo()
        info.add_text("comment", "h\xe9llo, w\xf6rld")
        Image.fromarray(rgba, "RGBA").save(src / "input" / "001.png",
                                           pnginfo=info)
        info = PngImagePlugin.PngInfo()
        info.add_itxt("comment", "\u00fcnic\u00f8de \u2713", zip=True)
        Image.fromarray(rgba[..., :3]).save(src / "output" / "001.png",
                                            pnginfo=info)
    for name in ("jax", "port"):
        mod = jax_ip if name == "jax" else port_ip
        mod.ImageProcessor(src, tmp_path / name, size_mode="width",
                           size_value=61).process_directory()
    capsys.readouterr()
    subs = ("input", "output") + (("mask",) if source != "jpeg_com" else ())
    for sub in subs:
        want, got = _files(tmp_path / "jax" / sub), _files(
            tmp_path / "port" / sub)
        assert sorted(got) == sorted(want) and got, sub
        for name, data in want.items():
            assert data[20:22] == b"\xff\xfe", f"{sub}/{name}: no COM"
            assert got[name] == data, f"{sub}/{name}"


def _flow_bar(got: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(got - want)
    spread = 2 * np.spacing(np.abs(want).astype(np.float32))
    assert (d <= np.maximum(1e-3, spread)).all(), d.max()
    assert np.quantile(d, 0.999) <= 1e-4 or (d <= spread).mean() >= 0.999


def _pngs(d: pathlib.Path) -> dict:
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(d.glob("*.png"))}


@pytest.fixture(scope="module")
def pipelines(scene, tmp_path_factory):
    """JAX's process_pipeline and the port's at --device cpu, on the scene
    without its corrupt file, resized to width 61."""
    root = tmp_path_factory.mktemp("pipes")
    src = root / "src"
    shutil.copytree(scene, src)
    (src / "input" / "zz_bad.png").unlink()
    jax_pp.process_pipeline(str(src), str(root / "jax"), resize_mode="width",
                            resize_value=61, flow_backend="tpu")
    frameio.zero_decode_counts()
    seconds = port_pp.process_pipeline(str(src), str(root / "port"),
                                       resize_mode="width", resize_value=61,
                                       device="cpu")
    return root, seconds, frameio.decode_counts()


def test_pipeline_matches_jax(pipelines):
    root, seconds, counts = pipelines
    jax, port = root / "jax", root / "port"
    for sub in ("input", "mask", "output", "tracking"):
        assert _files(port / sub) == _files(jax / sub), sub
    for sub in ("flow_fwd", "flow_bwd"):
        names = sorted(p.name for p in (jax / sub).glob("*.npy"))
        assert names == sorted(p.name for p in (port / sub).glob("*.npy"))
        assert len(names) == FRAMES - 1
        for name in names:
            _flow_bar(np.load(port / sub / name), np.load(jax / sub / name))
    for sigma in (10, 15):
        want = _pngs(jax / f"gauss_r10_s{sigma}")
        got = _pngs(port / f"gauss_r10_s{sigma}")
        assert sorted(got) == sorted(want) and len(want) == FRAMES
        for name in want:
            assert got[name].shape == (39, 61, 3)
            assert np.abs(got[name] - want[name]).max() <= 2, name
    assert set(seconds) == {"decode", "resize", "encode", "flow", "guides"}
    # the codec read every JPEG the steps read; PIL read nothing
    assert counts["pil"] == 0 and counts["jpeg"] > 0, counts


@pytest.mark.parametrize("sigma", [10.0, 15.0])
def test_guides_on_jax_flows_within_one_count(pipelines, tmp_path, sigma):
    root, _, _ = pipelines
    jax = root / "jax"
    GaussianFilter(mask_dir=root / "port" / "mask",
                   flow_fwd_dir=jax / "flow_fwd",
                   flow_bwd_dir=jax / "flow_bwd", output_dir=tmp_path,
                   frame_first=1, frame_last=FRAMES, key_frames=[1, FRAMES],
                   radius=10.0, sigma=sigma, device="cpu").process()
    want = _pngs(jax / f"gauss_r10_s{int(sigma)}")
    got = _pngs(tmp_path)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 1, name


def test_pipeline_refusals(scene, tmp_path, capsys, monkeypatch):
    args = [str(scene), str(tmp_path / "o")]
    with monkeypatch.context() as m:  # dis without OpenCV
        m.setitem(sys.modules, "cv2", None)
        assert port_pp.main(args + ["--flow-backend", "dis"]) == 1
    assert "needs OpenCV" in capsys.readouterr().out
    assert not (tmp_path / "o").exists()  # refused before any work
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_pp.process_pipeline(*args, device="cuda")
        assert port_pp.main(args) == 1  # the card by default
        assert "no CUDA device" in capsys.readouterr().out


def test_pipeline_dis_flows_are_the_jax_tools(pipelines, tmp_path):
    """``--flow-backend dis``: the port's pipeline writes the flow files
    that the JAX tool's DIS writes from the same resized scene (which
    ``test_pipeline_matches_jax`` holds byte for byte), bitwise."""
    pytest.importorskip("cv2")
    import optical_flow as jax_of

    root, _, _ = pipelines
    src = tmp_path / "src"
    shutil.copytree(root / "src", src)
    port_pp.process_pipeline(str(src), str(tmp_path / "port"),
                             resize_mode="width", resize_value=61,
                             flow_backend="dis", device="cpu")
    jax = root / "jax"
    jax_of.OpticalFlowCalculator(jax / "input", tmp_path / "jf",
                                 tmp_path / "jb", jax / "mask",
                                 backend="dis").calculate_flows()
    for port, want in (("flow_fwd", "jf"), ("flow_bwd", "jb")):
        names = sorted(p.name for p in (tmp_path / want).glob("*.npy"))
        assert len(names) == FRAMES - 1
        assert names == sorted(
            p.name for p in (tmp_path / "port" / port).glob("*.npy"))
        for name in names:
            np.testing.assert_array_equal(
                np.load(tmp_path / "port" / port / name),
                np.load(tmp_path / want / name), name)
    assert len(list((tmp_path / "port" / "gauss_r10_s15").glob("*.png"))) \
        == FRAMES


def test_texture_mapper_bitwise(scene, tmp_path, capsys, monkeypatch):
    # both tools draw unseeded RandomState colours: seed them alike
    state = np.random.RandomState
    monkeypatch.setattr(np.random, "RandomState",
                        lambda seed=None: state(7 if seed is None else seed))
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        for p in sorted((scene / "input").glob("00[12].png")):
            shutil.copy(p, d / p.name)
        shutil.copy(scene / "tracking" / "001.png", d / "gray.png")
    jax_tm.process_directory(str(tmp_path / "jax"), grid_size=8)
    want_log = capsys.readouterr().out
    assert port_tm.main([str(tmp_path / "port"), "--grid-size", "8"]) == 0
    assert capsys.readouterr().out == want_log.replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "has no alpha channel" in want_log
    maps = sorted(p.name for p in (tmp_path / "jax").glob("*_map.png"))
    assert maps == ["001_map.png", "002_map.png"]
    for name in maps:
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        got = frameio.decode_png(tmp_path / "port" / name)
        assert got.shape == want.shape == (H, W, 4)
        np.testing.assert_array_equal(got, want)
    # a seeded grid too
    port_tm.process_texture(str(tmp_path / "port" / "001.png"),
                            str(tmp_path / "p.png"), 8, seed=3)
    jax_tm.process_texture(str(tmp_path / "jax" / "001.png"),
                           str(tmp_path / "j.png"), 8, seed=3)
    np.testing.assert_array_equal(frameio.decode_png(tmp_path / "p.png"),
                                  np.asarray(Image.open(tmp_path / "j.png")))
