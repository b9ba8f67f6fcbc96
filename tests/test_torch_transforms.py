"""The port's data.transforms against the JAX package's, on the CPU.

The same uint8 inputs (numpy seeds) as arrays, tensors and PIL images go
through ``patch_toon_tpu.data.transforms`` and
``patch_toon_tpu_torch.data.transforms``: every output bitwise equal, as
``tests/test_transforms.py`` holds the JAX callables to ``data.io``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.data import transforms as jt
from patch_toon_tpu_torch.data import transforms as tt
from patch_toon_tpu_torch.data.io import load_image_rgb, load_mask

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _array(mode: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (13, 17, MODES[mode]), np.uint8)
    return arr[..., 0] if mode == "L" else arr


def _chain(mod, gray: bool):
    first = mod.GrayscaleConvert() if gray else mod.RGBConvert()
    return mod.Compose([first, mod.ToTensor(), mod.Normalize(0.5, 0.5)])


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("mode", list(MODES))
def test_compose_matches_jax(mode, gray):
    arr = _array(mode, seed=len(mode) + gray)
    want = _chain(jt, gray)(Image.fromarray(arr, mode))
    for x in (arr, torch.from_numpy(arr), Image.fromarray(arr, mode)):
        got = _chain(tt, gray)(x)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # each step alone, from an array as the JAX callables take it
    np.testing.assert_array_equal(
        (tt.GrayscaleConvert() if gray else tt.RGBConvert())(arr),
        np.asarray((jt.GrayscaleConvert() if gray else jt.RGBConvert())(
            arr)))


def test_to_tensor_and_normalize_match_jax():
    arr = _array("L", seed=9)
    np.testing.assert_array_equal(tt.ToTensor()(arr), jt.ToTensor()(arr))
    np.testing.assert_array_equal(tt.ToTensor()(torch.from_numpy(arr)),
                                  jt.ToTensor()(arr))
    x = tt.ToTensor()(_array("RGB", seed=10))
    norm = ([0.2, 0.4, 0.6], [0.5, 0.25, 0.125])
    np.testing.assert_array_equal(tt.Normalize(*norm)(x),
                                  jt.Normalize(*norm)(x))


def test_the_chain_is_the_loaders_values(tmp_path):
    """RGBConvert -> ToTensor -> Normalize(0.5, 0.5) of a file's pixels is
    data/io.py's [-1, 1] decode, and the mask chain its mask."""
    rgb = _array("RGB", seed=11)
    Image.fromarray(rgb).save(tmp_path / "f.png")
    np.testing.assert_array_equal(_chain(tt, False)(rgb),
                                  load_image_rgb(tmp_path / "f.png"))
    gray = _array("L", seed=12)
    Image.fromarray(gray).save(tmp_path / "m.png")
    binar = np.where(tt.GrayscaleConvert()(gray) > 128, 255, 0).astype(
        np.uint8)
    np.testing.assert_array_equal(tt.ToTensor()(binar)[..., 0],
                                  load_mask(tmp_path / "m.png"))
