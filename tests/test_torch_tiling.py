"""The port's copies of host helpers equal the JAX package's, exactly.

Tiling, mask erosion, bilinear resize, config composition and image IO: the
same numpy inputs must give identical outputs (no tolerance), including
masks that touch or are clipped at the frame border.
"""

import pathlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from patch_toon_tpu.config import compose as jax_compose
from patch_toon_tpu.config import to_container as jax_to_container
from patch_toon_tpu.data import io as jio
from patch_toon_tpu.infer import tiling as jt
from patch_toon_tpu.ops import masks as jm
from patch_toon_tpu.ops import resize as jr

from patch_toon_tpu_torch.config.compose import compose, to_container
from patch_toon_tpu_torch.config.defaults import INFERENCE, inference_config
from patch_toon_tpu_torch.data import io as tio
from patch_toon_tpu_torch.infer import tiling as tt
from patch_toon_tpu_torch.ops import masks as tm
from patch_toon_tpu_torch.ops import resize as tr

REPO = pathlib.Path(__file__).resolve().parents[1]


def _masks():
    rng = np.random.default_rng(11)
    full = np.ones((60, 90), np.float32)
    border = np.zeros((60, 90), np.float32)
    border[:25, :30] = 1          # touches the top-left corner
    border[40:, 70:] = 1          # and the bottom-right one
    speckle = (rng.random((60, 90)) > 0.3).astype(np.float32)
    blob = np.zeros((60, 90), np.float32)
    blob[10:50, 20:85] = 1
    return [full, border, speckle, blob]


@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("ps,overlap", [(16, 30.0), (32, 0.0), (20, 50.0)])
def test_tile_boxes_equal(k, ps, overlap):
    m = tm.erode_full_support_np(_masks()[k])
    assert tt.tile_boxes_from_mask(m, ps, overlap) == \
        jt.tile_boxes_from_mask(m, ps, overlap)


@settings(max_examples=80, deadline=None, database=None)
@given(h=st.integers(1, 70), w=st.integers(1, 90),
       density=st.floats(0.0, 1.0), speckle=st.booleans(),
       ps=st.integers(1, 48), overlap=st.floats(0.0, 100.0),
       seed=st.integers(0, 2 ** 32 - 1))
def test_tile_boxes_equal_on_random_masks(h, w, density, speckle, ps,
                                          overlap, seed):
    """The numpy placement equals the JAX copy's loop on random masks
    (blobs of a random density, or sparse speckle), eroded or not, at any
    stride, touching the border or empty."""
    rng = np.random.default_rng(seed)
    if speckle:
        m = (rng.random((h, w)) < density * 0.05).astype(np.float32)
    else:
        m = (rng.random((h, w)) < density).astype(np.float32)
        m = tm.erode_full_support_np(m) if rng.random() < 0.5 else m
    assert tt.tile_boxes_from_mask(m, ps, overlap) == \
        jt.tile_boxes_from_mask(m, ps, overlap)


@pytest.mark.parametrize("k", range(4))
def test_erosion_equal_to_host_and_device_ops(k):
    m = _masks()[k]
    got = tm.erode_full_support_np(m)
    np.testing.assert_array_equal(got, jm.erode_full_support_np(m))
    np.testing.assert_array_equal(got, np.asarray(jm.erode_full_support(m)))


def test_erosion_rejects_fractional_masks():
    with pytest.raises(ValueError):
        tm.erode_full_support_np(np.full((8, 8), 0.5, np.float32))


@pytest.mark.parametrize("box", [(80, 80), (53, 80), (80, 41), (17, 23),
                                 (16, 16), (9, 16)])
def test_gaussian_weights_equal(box):
    ps = max(box)
    np.testing.assert_array_equal(tt.gaussian_tile_weight(*box, ps),
                                  jt.gaussian_tile_weight(*box, ps))


def test_resize_equal():
    rng = np.random.default_rng(1)
    img = rng.random((13, 21, 3)).astype(np.float32)
    for out_hw in ((26, 42), (7, 9), (13, 30)):
        for ac in (False, True):
            np.testing.assert_array_equal(
                tr.resize_bilinear_np(img, out_hw, ac),
                jr.resize_bilinear_np(img, out_hw, ac))
            np.testing.assert_array_equal(
                tr.bilinear_matrix(21, out_hw[1], ac),
                jr.bilinear_matrix(21, out_hw[1], ac))


def test_bucket_and_dispatch_sizes_equal():
    for n in range(0, 1100):
        assert tt.bucket_size(n) == jt.bucket_size(n)
    for n in (0, 1, 30, 170, 171, 300, 600):
        for target in (128, 512):
            assert tt.frames_per_dispatch(n, target=target) == \
                jt.frames_per_dispatch(n, target=target)


def test_packing_equal():
    m = _masks()[1]
    per_frame = [jt.tile_boxes_from_mask(m, 16, 30.0),
                 jt.tile_boxes_from_mask(_masks()[3], 16, 30.0)]
    bucket = jt.bucket_size(sum(map(len, per_frame)))
    for got, want in zip(tt.pack_boxes_multi(per_frame, 16, bucket),
                         jt.pack_boxes_multi(per_frame, 16, bucket)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tt.pack_boxes(per_frame[0], 16, 64),
                         jt.pack_boxes(per_frame[0], 16, 64)):
        np.testing.assert_array_equal(got, want)


def test_defaults_dict_equals_composed_yaml():
    composed = to_container(compose(REPO / "config", "inference"))
    assert INFERENCE == composed
    assert composed == jax_to_container(jax_compose(REPO / "config",
                                                    "inference"))
    cfg = inference_config(paths={"checkpoint": "c.ckpt"})
    assert cfg.paths.checkpoint == "c.ckpt"
    assert cfg.paths.input_dir == INFERENCE["paths"]["input_dir"]
    assert INFERENCE["paths"]["checkpoint"] != "c.ckpt"  # a fresh copy


@pytest.mark.parametrize("overrides", [
    ["paths.input_dir=/x/in", "inference.precision=32", "data.patch_size=16"],
    ["model.generator.args.filters=[4,8,8,8,8,4]", "+inference.extra=1",
     "~inference.watch", "paths.additional_channels=null"],
])
def test_compose_overrides_equal(overrides):
    got = to_container(compose(REPO / "config", "inference", overrides))
    want = jax_to_container(jax_compose(REPO / "config", "inference",
                                        overrides))
    assert got == want


def test_image_io_equal(tmp_path):
    rng = np.random.default_rng(5)
    rgba = (rng.random((9, 11, 4)) * 255).astype(np.uint8)
    gray = (rng.random((9, 11)) * 255).astype(np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "b.png")
    Image.fromarray(gray, "L").save(tmp_path / "a.PNG")
    Image.fromarray(rgba[..., :3]).save(tmp_path / "c.jpeg")
    (tmp_path / "notes.txt").write_text("x")
    assert tio.list_images(tmp_path) == jio.list_images(tmp_path)
    for name in ("b.png", "a.PNG", "c.jpeg"):
        np.testing.assert_array_equal(tio.decode_rgb_uint8(tmp_path / name),
                                      jio._decode_rgb_uint8(tmp_path / name))
        np.testing.assert_array_equal(tio.load_mask(tmp_path / name),
                                      jio.load_mask(tmp_path / name))
    for name in ("b.jpg", "a.png", "zz.png"):
        assert tio.find_corresponding_image(tmp_path, name) == \
            jio.find_corresponding_image(tmp_path, name)
