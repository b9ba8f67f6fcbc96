"""The port's single-image calls and Orbax directories against the JAX engine.

``process_large_image`` (a frame in memory, an optional mask, fractional
masks compositing in part) and ``process_image`` (files in, a PNG out, the
``ignore`` mask rule, the size-mismatch error, ``debug_mode``'s overlay)
on a ``tools/make_sample_scene.py`` scene, precision 32 on the CPU for both
engines, one torch checkpoint: frames within 1 uint8 count, tiled and
full-frame. (The JAX engine serves a tiled frame through its single-frame
program, the port through the multiframe program at F = 1.) Last, an Orbax
checkpoint directory written by the JAX package: the port serves it within
1 count of the JAX engine serving it, and as the ``.ckpt`` that
``tools/export_checkpoint.py`` exports from it; a directory that is not a
checkpoint is refused.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.infer.tiling import draw_tile_boxes
from patch_toon_tpu_torch.models.generator import GeneratorJ

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

ARCH = ["model.generator.args.filters=[4,8,8,8,8,4]",
        "model.generator.args.resnet_blocks=1", "data.patch_size=16"]
H, W = 48, 72


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_single")
    make_scene(str(root / "scene"), frames=2, height=H, width=W, seed=8)
    torch.manual_seed(7)
    model = GeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}},
               root / "gen.ckpt")
    return root


def _overrides(root, ckpt, *extra):
    s = root / "scene"
    return [f"paths.checkpoint={ckpt}", f"paths.input_dir={s / 'input'}",
            f"paths.mask_dir={s / 'mask'}", f"paths.output_dir={root}",
            f"paths.additional_channels.point_vector.path={s / 'tracking'}",
            "inference.use_gpu=false", "inference.precision=32", *ARCH,
            *extra]


def _engines(root, *extra, ckpt=None, jax_ckpt=None):
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    ckpt = ckpt or root / "gen.ckpt"
    port = StyleTransferInference(compose(REPO / "config", "inference",
                                          overrides=_overrides(root, ckpt,
                                                               *extra)))
    jax_eng = JaxEngine(jax_compose(REPO / "config", "inference",
                                    overrides=_overrides(
                                        root, jax_ckpt or ckpt, *extra)))
    return port, jax_eng


def _frame(root, i=0):
    return sorted((root / "scene" / "input").glob("*.png"))[i]


def _diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b)).max())


@pytest.mark.parametrize("mode", ["tiled", "fullframe"])
def test_single_image_calls_match_jax(scene, tmp_path, mode):
    """``process_image`` writes, and ``process_large_image`` returns for
    the frame normalized to [-1, 1] on the host, what the JAX engine does,
    within 1 count; the tile boxes are JAX's ``patch_positions``; a binary
    mask gives ``stylize_group``'s frame bitwise."""
    port, jax_eng = _engines(scene, f"inference.mode={mode}")
    src = _frame(scene)
    mask_path = scene / "scene" / "mask" / src.name
    port.process_image(src, mask_path, tmp_path / "port.png")
    jax_eng.process_image(str(src), str(mask_path), str(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == (H, W, 3)
    assert _diff(got, Image.open(tmp_path / "jax.png")) <= 1
    assert port.patch_positions == [tuple(b) for b in jax_eng.patch_positions]
    assert (port.patch_positions == []) == (mode == "fullframe")
    frame = port.load_frame(src)
    mask = port.load_eroded_mask(mask_path, (H, W))
    unit = frame.astype(np.float32) / 255.0 * 2.0 - 1.0
    out = port.process_large_image(unit, mask)
    np.testing.assert_array_equal(out, got)
    np.testing.assert_array_equal(
        port.stylize_group(frame[None], [mask])[0], got)
    assert _diff(out, jax_eng.process_large_image(unit, mask)) <= 1


@pytest.mark.parametrize("mode", ["tiled", "fullframe"])
def test_fractional_mask_and_overlap_match_jax(scene, mode):
    """A fractional mask (uploaded as fp32, compositing in part) and a
    tile overlap of the call's own, within 1 count of the JAX engine."""
    port, jax_eng = _engines(scene, f"inference.mode={mode}")
    frame = port.load_frame(_frame(scene, 1)).astype(np.float32) \
        / 255.0 * 2.0 - 1.0
    mask = np.zeros((H, W), np.float32)
    mask[4:44, 6:66] = 1.0
    mask[10:30, 20:50] = 0.5
    got = port.process_large_image(frame, mask, overlap_percent=50.0)
    want = jax_eng.process_large_image(frame, mask, overlap_percent=50.0)
    assert _diff(got, want) <= 1
    assert port.patch_positions == [tuple(b) for b in jax_eng.patch_positions]
    floored = port.process_large_image(frame, np.floor(mask),
                                       overlap_percent=50.0)
    assert (floored != got).any()  # the half-weight region composites


def test_ignore_mask_size_mismatch_and_debug_overlay(scene, tmp_path):
    """A mask missing from a directory ending in ``ignore`` means the whole
    frame (as the JAX engine); a mask of another size raises ValueError as
    there; ``debug_mode`` writes ``debug_<name>`` with the tile boxes
    outlined, within 1 count of JAX's overlay."""
    port, jax_eng = _engines(scene, "inference.debug_mode=true")
    src = _frame(scene)
    ignore = tmp_path / "mask_ignore"
    ignore.mkdir()
    port.process_image(src, ignore / src.name, tmp_path / "p.png")
    jax_eng.process_image(str(src), str(ignore / src.name),
                          str(tmp_path / "j.png"))
    got = np.asarray(Image.open(tmp_path / "p.png"))
    assert _diff(got, Image.open(tmp_path / "j.png")) <= 1
    debug = np.asarray(Image.open(tmp_path / "debug_p.png"))
    np.testing.assert_array_equal(
        debug, draw_tile_boxes(got, port.patch_positions))
    assert _diff(debug, Image.open(tmp_path / "debug_j.png")) <= 1
    small = tmp_path / "small"
    small.mkdir()
    Image.fromarray(np.full((H // 2, W), 255, np.uint8)).save(
        small / src.name)
    with pytest.raises(ValueError, match="resolutions must match"):
        port.process_image(src, small / src.name, tmp_path / "x.png")
    with pytest.raises(ValueError, match="resolutions must match"):
        jax_eng.process_image(str(src), str(small / src.name),
                              str(tmp_path / "x.png"))
    with pytest.raises(ValueError, match="channels"):
        port.process_large_image(np.zeros((H, W, 3), np.float32))


@pytest.fixture(scope="module")
def orbax_ckpt(tmp_path_factory):
    """A JAX Orbax checkpoint directory (6 input channels, seeded
    parameters), as tests/test_checkpoints.py writes one."""
    from patch_toon_tpu.train import StyleTransferModel
    from patch_toon_tpu.train.checkpoints import CheckpointManager

    root = tmp_path_factory.mktemp("orbax")
    g_args = dict(input_channels=6, use_bias=True, tanh=True,
                  append_smoothers=True, resnet_blocks=1,
                  filters=[4, 8, 8, 8, 8, 4], norm_layer="instance_norm")
    model = StyleTransferModel(
        generator_config={"type": "GeneratorJ", "args": dict(g_args)},
        discriminator_config=None,
        training_config=dict(batch_size=4, precision=32),
        optimizer_config=dict(
            generator=dict(lr=4e-4, betas=[0.9, 0.999], weight_decay=1e-5)),
        data_config=dict(patch_size=16, additional_channels={}),
        perception_loss_config=None)
    state = model.init_state(jax.random.PRNGKey(0), patch_size=16)
    draws = np.random.default_rng(21)
    state = state.replace(g_params=jax.tree.map(
        lambda a: np.asarray(a) + draws.standard_normal(a.shape).astype(
            np.float32) * 0.1, state.g_params))
    CheckpointManager(root / "ckpt", meta={
        "input_channels": 6, "generator_args": g_args, "patch_size": 16},
    ).save(state, epoch=0, score=1.0)
    return root / "ckpt" / "last"


def test_orbax_directory_is_refused_and_its_export_serves(scene, tmp_path,
                                                           orbax_ckpt):
    """The port serves an Orbax directory as ``paths.checkpoint`` (read by
    ``utils/orbax.py``, without jax) within 1 count of the JAX engine
    serving it, and writes the same file from the ``.ckpt`` that
    ``tools/export_checkpoint.py`` exports (run as a program, not edited);
    a directory that is not an Orbax checkpoint is refused, by name."""
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="not an Orbax checkpoint"):
        StyleTransferInference(compose(REPO / "config", "inference",
                                       overrides=_overrides(
                                           scene, tmp_path / "empty")))
    out = tmp_path / "exported.ckpt"
    res = subprocess.run(
        [sys.executable, str(REPO / "tools" / "export_checkpoint.py"),
         str(orbax_ckpt), str(out)], capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    port, jax_eng = _engines(scene, ckpt=orbax_ckpt, jax_ckpt=orbax_ckpt)
    exported, _ = _engines(scene, ckpt=out, jax_ckpt=orbax_ckpt)
    src = _frame(scene)
    mask_path = scene / "scene" / "mask" / src.name
    port.process_image(src, mask_path, tmp_path / "port.png")
    exported.process_image(src, mask_path, tmp_path / "exported.png")
    jax_eng.process_image(str(src), str(mask_path), str(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.std() > 1.0
    assert _diff(got, Image.open(tmp_path / "jax.png")) <= 1
    assert _diff(got, Image.open(tmp_path / "exported.png")) == 0
