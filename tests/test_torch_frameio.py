"""The port's native PNG codec against the JAX package's codec and PIL.

Frames come from a numpy seed and are written by PIL. Decoding must be
bitwise equal to ``patch_toon_tpu.native.decode_png`` and to PIL; the
port's encoder must round-trip bitwise through PIL; a file the codec
refuses by its format (palette, 16-bit, JPEG) is read by PIL, and only
then; a damaged PNG raises.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from patch_toon_tpu.native import decode_png as jax_decode_png
from patch_toon_tpu.native.frameio import native_available as jax_native

from patch_toon_tpu_torch.data import io as tio
from patch_toon_tpu_torch.native import frameio
from patch_toon_tpu_torch.native import (
    FrameLoader,
    FrameWriter,
    decode_png,
    encode_png,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _frame(mode: str, seed: int, h: int = 37, w: int = 53) -> np.ndarray:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, MODES[mode]), dtype=np.uint8)
    # smooth rows too, so PIL's encoder picks every row filter
    arr[: h // 2] = np.cumsum(arr[: h // 2], axis=1, dtype=np.uint8) // 2
    return arr


def _pil_save(arr: np.ndarray, mode: str, path) -> None:
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path)


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_equals_jax_codec_and_pil(tmp_path, mode):
    want = _frame(mode, seed=len(mode))
    path = tmp_path / f"{mode}.png"
    _pil_save(want, mode, path)
    got = decode_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)).reshape(
        want.shape))
    assert jax_native()
    np.testing.assert_array_equal(got, jax_decode_png(str(path)))
    assert frameio.decode_native(path) is not None  # the codec read it


@pytest.mark.parametrize("mode", list(MODES))
def test_io_conversions_equal_pil(tmp_path, mode):
    """RGB (gray replicated, alpha dropped) and the mask's luma > 128, bit
    for bit as PIL's convert("RGB") and convert("L")."""
    path = tmp_path / f"{mode}.png"
    _pil_save(_frame(mode, seed=7), mode, path)
    with Image.open(path) as img:
        rgb = np.asarray(img.convert("RGB"))
        luma = np.asarray(img.convert("L"))
        bands = len(img.getbands())
    np.testing.assert_array_equal(tio.decode_rgb_uint8(path), rgb)
    np.testing.assert_array_equal(tio.load_mask(path),
                                  (luma > 128).astype(np.float32))
    assert tio.image_bands(path) == bands == MODES[mode]


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encode_roundtrips_through_pil(tmp_path, channels):
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    arr = _frame(mode, seed=20 + channels, h=64, w=48)
    path = tmp_path / "o.png"
    encode_png(path, arr[..., 0] if channels == 1 else arr)
    with Image.open(path) as img:
        assert img.mode == mode
        back = np.asarray(img)
    np.testing.assert_array_equal(back.reshape(arr.shape), arr)
    np.testing.assert_array_equal(decode_png(path), arr)


def _rgb_12x17():
    return np.random.default_rng(3).integers(0, 256, (12, 17, 3),
                                             dtype=np.uint8)


# (file name, how PIL writes it, the codec reads it natively)
FORMATS = [
    ("c.jpg", lambda p: Image.fromarray(_rgb_12x17()).save(p), True),
    ("jpeg_named.png", lambda p: Image.fromarray(_rgb_12x17()).save(
        p, format="JPEG"), True),
    ("gray.jpg", lambda p: Image.fromarray(_rgb_12x17()[..., 0]).save(p),
     True),
    ("p.png", lambda p: Image.fromarray(_rgb_12x17()).convert("P").save(p),
     False),
    ("i16.png", lambda p: Image.fromarray(
        _rgb_12x17()[..., 0].astype(np.uint16) * 257).save(p), False),
    ("prog.jpg", lambda p: Image.fromarray(_rgb_12x17()).save(
        p, progressive=True), False),
    ("cmyk.jpg", lambda p: Image.fromarray(_rgb_12x17()).convert(
        "CMYK").save(p), False),
]


@pytest.mark.parametrize("name,write,native", FORMATS,
                         ids=[f[0] for f in FORMATS])
def test_formats_the_codec_refuses_go_to_pil(tmp_path, name, write, native):
    """The codec decides by the file's signature: baseline JPEG (a .jpg or
    a JPEG named .png) is read natively, bit for bit PIL's; palette and
    16-bit PNG, progressive and CMYK JPEG are refused and read by PIL."""
    path = tmp_path / name
    write(path)
    frameio.zero_decode_counts()
    if native:
        arr = frameio.decode_native(path)
        assert arr.shape[:2] == (12, 17) and arr.shape[-1] in (1, 3)
    else:
        with pytest.raises(frameio.Refused):
            frameio.decode_native(path)
    with Image.open(path) as img:
        want_rgb = np.asarray(img.convert("RGB"))
        want_l = np.asarray(img.convert("L"))
    np.testing.assert_array_equal(tio.decode_rgb_uint8(path), want_rgb)
    np.testing.assert_array_equal(tio.load_mask(path),
                                  (want_l > 128).astype(np.float32))
    got = decode_png(path)
    assert got.shape[:2] == (12, 17) and got.ndim == 3
    if native:
        np.testing.assert_array_equal(tio.to_rgb(got), want_rgb)
    counts = frameio.decode_counts()
    assert counts["pil"] == (0 if native else 3), counts
    assert counts["jpeg"] == (4 if native else 0), counts


def test_damaged_png_raises_naming_the_file(tmp_path):
    arr = _frame("RGB", seed=4)
    encode_png(tmp_path / "ok.png", arr)
    data = (tmp_path / "ok.png").read_bytes()
    (tmp_path / "cut.png").write_bytes(data[: len(data) // 2])
    flipped = bytearray(data)
    flipped[60] ^= 0xFF  # inside the compressed data
    (tmp_path / "flip.png").write_bytes(bytes(flipped))
    for name in ("cut.png", "flip.png"):
        with pytest.raises(ValueError, match=name):
            decode_png(tmp_path / name)
    with pytest.raises(ValueError, match="missing.png"):
        decode_png(tmp_path / "missing.png")


def test_loader_keeps_order(tmp_path):
    arrays = [_frame("RGB", seed=40 + i, h=29, w=31 + i) for i in range(9)]
    paths = []
    for i, arr in enumerate(arrays):
        paths.append(tmp_path / f"{i:03d}.png")
        encode_png(paths[-1], arr)
    with FrameLoader(paths, num_threads=3, window=2) as loader:
        assert loader._handle is not None  # the C++ loader, not per file
        for i, want in enumerate(arrays):
            np.testing.assert_array_equal(loader.get(i), want)


def test_writer_counts_a_failed_write(tmp_path):
    arr = _frame("RGB", seed=5)
    with FrameWriter(num_threads=2) as writer:
        for i in range(4):
            writer.submit(tmp_path / f"w{i}.png", arr)
        writer.submit(tmp_path / "missing_dir" / "x.png", arr)
        assert writer.flush() == 1
        writer.submit(tmp_path / "w4.png", arr)
        assert writer.flush() == 1  # failures so far
    for i in range(5):
        np.testing.assert_array_equal(decode_png(tmp_path / f"w{i}.png"), arr)


def test_library_builds_under_build_dir():
    lib = frameio.library_path()
    assert lib.parent == REPO / "patch_toon_tpu_torch" / "_build"
    assert frameio.build() == lib and lib.exists()
    assert lib.name.startswith("frameio_") and lib.suffix == ".so"
    assert not (REPO / "patch_toon_tpu_torch" / "native" /
                "_frameio.so").exists()


def test_png_io_needs_no_pil(tmp_path):
    """With PIL unimportable, the port writes and reads 8-bit PNG frames
    and masks, and refuses a palette PNG only for want of PIL."""
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(
        tmp_path / "p.png")
    code = f"""
import sys
sys.modules["PIL"] = None
import numpy as np
from patch_toon_tpu_torch.data import io
a = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
io.save_image_uint8(a, r"{tmp_path}/a.png")
assert (io.decode_rgb_uint8(r"{tmp_path}/a.png") == a).all()
assert io.load_mask(r"{tmp_path}/a.png").shape == (5, 7)
assert io.image_bands(r"{tmp_path}/a.png") == 3
try:
    io.decode_rgb_uint8(r"{tmp_path}/p.png")
except ImportError:
    print("OK")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "OK"
