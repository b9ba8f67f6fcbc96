"""The port's LANCZOS resize and baseline JPEG codec against Pillow.

``native/resample.cpp`` and its plain version ``data/resample.py`` against
Pillow's ``resize(size, Image.Resampling.LANCZOS)``; ``native/jpeg.cpp``'s
decoder against PIL's ``convert("RGB")`` / ``convert("L")`` and its
encoder against Pillow's ``save(format="JPEG", quality=q)``. All bitwise
(the encoder byte for byte). Inputs from numpy seeds; the committed
fixtures under ``tests/data/jpeg/`` (read on machines without Pillow by
``chip_smoke.py``) are regenerated here with the installed Pillow and must
not have changed.
"""

import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from patch_toon_tpu_torch.data.resample import resize_lanczos as plain_resize
from patch_toon_tpu_torch.native import frameio

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "jpeg"


def _image(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """A smooth gradient with sharp blocks and noise: every DCT frequency
    and both rounding directions of the resize get exercised."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([(xx * 9 + yy * 3) % 256, (yy * 7 + 40) % 256,
                     128 + 100 * np.sin(xx / 5 + yy / 9)], -1)[..., :channels]
    noise = rng.integers(-20, 21, (h, w, channels))
    img = np.clip(base + noise, 0, 255).astype(np.uint8)
    img[h // 3: h // 3 + 5, w // 4: w // 4 + 7] = rng.integers(0, 256, channels)
    return img if channels == 3 else img[..., 0]


# ------------------------------------------------------------ the resize

@pytest.mark.parametrize("h,w,oh,ow", [
    (54, 96, 29, 51),     # shrink, 16:9 at about 0.53
    (100, 77, 130, 41),   # one axis up, the other down
    (37, 50, 23, 37),     # both down, odd sizes
    (37, 50, 37, 23),     # one axis only (width)
    (37, 50, 61, 50),     # one axis only (height), enlarged
    (16, 16, 45, 38),     # enlarge
    (7, 300, 3, 17),      # extreme ratios
])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_resize_is_pillows_lanczos(h, w, oh, ow, mode):
    src = _image(h, w, seed=h * w, channels=1 if mode == "L" else 3)
    want = np.asarray(Image.fromarray(src, mode).resize(
        (ow, oh), Image.Resampling.LANCZOS))
    np.testing.assert_array_equal(frameio.resize_lanczos(src, ow, oh), want)
    np.testing.assert_array_equal(plain_resize(src, ow, oh), want)


def test_resize_keeps_an_unchanged_size_and_refuses_alpha():
    src = _image(9, 11, seed=1)
    np.testing.assert_array_equal(frameio.resize_lanczos(src, 11, 9), src)
    np.testing.assert_array_equal(plain_resize(src, 11, 9), src)
    with pytest.raises(ValueError, match="resize_lanczos"):
        frameio.resize_lanczos(np.zeros((4, 4, 4), np.uint8), 2, 2)


# ------------------------------------------------------------ the decoder

def _jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _decode_bytes(tmp_path, data: bytes) -> np.ndarray:
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    return frameio.decode_native(path)


def _pil(data: bytes, mode: str) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert(mode))


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "gray"])
@pytest.mark.parametrize("h,w", [(37, 53), (16, 32), (3, 2)])
def test_decoder_is_pil(tmp_path, h, w, sampling, quality):
    gray = sampling == "gray"
    src = _image(h, w, seed=h + w + quality, channels=1 if gray else 3)
    kw = {} if gray else {"subsampling": sampling}
    data = _jpeg(src, quality=quality, **kw)
    got = _decode_bytes(tmp_path, data)
    assert got.shape == (h, w, 1 if gray else 3)
    np.testing.assert_array_equal(got[..., 0] if gray else got,
                                  _pil(data, "L" if gray else "RGB"))


@pytest.mark.parametrize("kw", [{"restart_marker_blocks": 1},
                                {"restart_marker_blocks": 5,
                                 "subsampling": "4:4:4"},
                                {"restart_marker_rows": 1,
                                 "subsampling": "4:2:2"}],
                         ids=["blocks1", "blocks5_444", "rows1_422"])
def test_decoder_restart_intervals(tmp_path, kw):
    src = _image(45, 70, seed=9)
    data = _jpeg(src, quality=85, **kw)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(_decode_bytes(tmp_path, data),
                                  _pil(data, "RGB"))


@pytest.mark.parametrize("kw,code", [
    ({"progressive": True}, -10),
    ({"keep_rgb": True}, -14),    # RGB components, with an Adobe marker
], ids=["progressive", "rgb"])
def test_decoder_refuses_by_format(tmp_path, kw, code):
    path = tmp_path / "r.jpg"
    path.write_bytes(_jpeg(_image(20, 30, seed=2), **kw))
    with pytest.raises(frameio.Refused) as err:
        frameio.decode_native(path)
    assert err.value.code == code
    # the per-file rule: PIL reads it
    np.testing.assert_array_equal(frameio.decode_png(path),
                                  np.asarray(Image.open(path)))


def test_damaged_jpeg_raises_naming_the_file(tmp_path):
    data = _jpeg(_image(40, 40, seed=3), quality=90)
    (tmp_path / "cut.jpg").write_bytes(data[: len(data) * 2 // 3])
    with pytest.raises(ValueError, match="cut.jpg"):
        frameio.decode_native(tmp_path / "cut.jpg")


def test_without_pil_a_refused_jpeg_names_its_format(tmp_path):
    Image.fromarray(_image(8, 8, seed=4)).save(tmp_path / "p.jpg",
                                               progressive=True)
    Image.fromarray(_image(8, 8, seed=4)).save(tmp_path / "b.png",
                                               format="JPEG")
    code = f"""
import sys
sys.modules["PIL"] = None
from patch_toon_tpu_torch.data import io
assert io.decode_rgb_uint8(r"{tmp_path}/b.png").shape == (8, 8, 3)
assert io.image_bands(r"{tmp_path}/b.png") == 3
try:
    io.decode_rgb_uint8(r"{tmp_path}/p.jpg")
except ImportError as e:
    print(e)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    assert "p.jpg is a progressive JPEG" in res.stdout
    assert "PIL cannot be imported" in res.stdout


def test_loader_decodes_jpeg_in_its_threads(tmp_path):
    want, paths = [], []
    for i in range(7):
        src = _image(24 + i, 33, seed=40 + i)
        data = _jpeg(src, quality=80 + i)
        paths.append(tmp_path / f"{i:03d}.png")  # JPEG bytes, PNG names
        paths[-1].write_bytes(data)
        want.append(_pil(data, "RGB"))
    frameio.zero_decode_counts()
    with frameio.FrameLoader(paths, num_threads=3, window=2) as loader:
        for i, w in enumerate(want):
            np.testing.assert_array_equal(loader.get(i), w)
    assert frameio.decode_counts() == {"png": 0, "jpeg": 7, "pil": 0}
    assert frameio.probe(paths[3]) == (33, 27, 3)


# ------------------------------------------------------------ the encoder

@pytest.mark.parametrize("h,w", [(16, 16), (32, 48), (1, 1), (17, 33),
                                 (39, 61), (100, 7)])
@pytest.mark.parametrize("quality", [95, 75])
def test_encoder_writes_pillows_bytes(tmp_path, h, w, quality):
    src = _image(h, w, seed=h * 3 + w)
    frameio.encode_jpeg(tmp_path / "e.png", src, quality)
    assert (tmp_path / "e.png").read_bytes() == _jpeg(src, quality=quality)


# ------------------------------------------------------------ fixtures

# (name, shape, seed, save options): written by Pillow, 4:4:4 / 4:2:2 /
# 4:2:0 / gray at quality 50, 95 and 100, one with restart markers
PILLOW_FIXTURES = [
    ("rgb444_q50", (19, 27), 1, {"quality": 50, "subsampling": "4:4:4"}),
    ("rgb422_q95", (37, 22), 2, {"quality": 95, "subsampling": "4:2:2"}),
    ("rgb420_q100", (19, 27), 3, {"quality": 100, "subsampling": "4:2:0"}),
    ("gray_q95", (37, 22), 4, {"quality": 95}),
    ("rgb420_q95_rst", (37, 22), 5, {"quality": 95,
                                     "restart_marker_blocks": 2}),
]
# written by OpenCV's encoder at 4:4:0 (luma 1x2), which Pillow cannot
# write: kept as committed, and held to Pillow's decode of it
OTHER_FIXTURES = ["rgb440_q90"]


def make_fixtures(out: pathlib.Path) -> None:
    """Write the Pillow fixtures, each with Pillow's decode as PNG, and
    ``src.png`` with Pillow's quality-95 JPEG of it, into ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    for name, (h, w), seed, kw in PILLOW_FIXTURES:
        gray = name.startswith("gray")
        data = _jpeg(_image(h, w, seed, 1 if gray else 3), **kw)
        (out / f"{name}.jpg").write_bytes(data)
        frameio.encode_png(out / f"{name}.png",
                           _pil(data, "L" if gray else "RGB"))
    src = _image(23, 41, seed=6)
    frameio.encode_png(out / "src.png", src)
    (out / "src_q95.jpg").write_bytes(_jpeg(src, quality=95))


def test_fixtures_are_pillows(tmp_path):
    make_fixtures(tmp_path)
    names = sorted(p.name for p in FIXTURES.iterdir())
    assert names == sorted(
        [p.name for p in tmp_path.iterdir()]
        + [f"{n}.{e}" for n in OTHER_FIXTURES for e in ("jpg", "png")])
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 40_000
    for p in tmp_path.iterdir():
        if p.suffix == ".jpg":
            assert (FIXTURES / p.name).read_bytes() == p.read_bytes(), p.name
        else:
            np.testing.assert_array_equal(frameio.decode_png(FIXTURES / p.name),
                                          frameio.decode_png(p))
    for name in OTHER_FIXTURES:
        data = (FIXTURES / f"{name}.jpg").read_bytes()
        np.testing.assert_array_equal(
            frameio.decode_png(FIXTURES / f"{name}.png"), _pil(data, "RGB"))


@pytest.mark.parametrize("name", [f[0] for f in PILLOW_FIXTURES]
                         + OTHER_FIXTURES)
def test_codec_reads_every_fixture(name):
    got = frameio.decode_native(FIXTURES / f"{name}.jpg")
    np.testing.assert_array_equal(got, frameio.decode_png(
        FIXTURES / f"{name}.png"))


def test_codec_writes_the_fixture_jpeg(tmp_path):
    src = frameio.decode_png(FIXTURES / "src.png")
    frameio.encode_jpeg(tmp_path / "o.jpg", src, 95)
    assert (tmp_path / "o.jpg").read_bytes() == (
        FIXTURES / "src_q95.jpg").read_bytes()
