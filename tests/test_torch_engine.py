"""The port's engine and CLI against the JAX engine on a tiny scene.

A ``tools/make_sample_scene.py`` scene (RGB frames, masks and a 3-band
tracking guide, so the generator takes 6 channels), one torch checkpoint
in the reference layout, precision 32 on the CPU for both. The PNGs the
two engines write must agree within 1 uint8 count (fp32 roundoff).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

from patch_toon_tpu_torch import cli  # noqa: E402
from patch_toon_tpu_torch.config.compose import compose  # noqa: E402
from patch_toon_tpu_torch.infer.engine import (  # noqa: E402
    StyleTransferInference,
)
from patch_toon_tpu_torch.models.generator import GeneratorJ  # noqa: E402

ARCH = ["model.generator.args.filters=[4,8,8,8,8,4]",
        "model.generator.args.resnet_blocks=1", "data.patch_size=16"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine")
    make_scene(str(root / "scene"), frames=4, height=48, width=72, seed=3)
    torch.manual_seed(5)
    model = GeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    sd = {f"generator.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, root / "gen.ckpt")
    return root


def _overrides(root, out, mask_dir):
    s = root / "scene"
    return [f"paths.checkpoint={root / 'gen.ckpt'}",
            f"paths.input_dir={s / 'input'}", f"paths.mask_dir={mask_dir}",
            f"paths.output_dir={out}",
            f"paths.additional_channels.point_vector.path={s / 'tracking'}",
            "inference.use_gpu=false", "inference.precision=32", *ARCH]


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


@pytest.mark.parametrize("masked", [True, False])
def test_cli_matches_jax_engine(scene, masked):
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    # a missing mask directory ending in "ignore" means the full frame
    mask_dir = scene / "scene" / ("mask" if masked else "mask_ignore")
    tag = "masked" if masked else "full"
    jax_out, port_out = scene / f"jax_{tag}", scene / f"port_{tag}"
    JaxEngine(jax_compose(REPO / "config", "inference", overrides=_overrides(
        scene, jax_out, mask_dir))).process_directory(progress=False)
    assert cli.main(_overrides(scene, port_out, mask_dir)) == 0
    want, got = _read(jax_out), _read(port_out)
    assert len(got) == 4 and got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape == (48, 72, 3)
        assert np.abs(got[name] - want[name]).max() <= 1, name


def _engine(scene, out, *extra):
    cfg = compose(REPO / "config", "inference", overrides=_overrides(
        scene, out, scene / "scene" / "mask") + list(extra))
    return StyleTransferInference(cfg)


def test_bad_file_is_named_and_skipped(scene, tmp_path, caplog):
    src = scene / "scene"
    bad = tmp_path / "input"
    bad.mkdir()
    for p in sorted((src / "input").glob("*.png"))[:2]:
        (bad / p.name).write_bytes(p.read_bytes())
    (bad / "000.png").write_bytes(b"not a png")
    eng = _engine(scene, tmp_path / "out")
    eng.cfg["paths"]["input_dir"] = str(bad)
    assert eng.process_directory() == 2
    assert "000.png" in caplog.text
    assert sorted(p.name for p in (tmp_path / "out").glob("*.png")) == \
        ["001.png", "002.png"]


def test_stylize_group_cobatches_frames(scene, tmp_path):
    eng = _engine(scene, tmp_path)
    frames = np.stack([eng.load_frame(p) for p in sorted(
        (scene / "scene" / "input").glob("*.png"))[:3]])
    assert frames.dtype == np.uint8 and frames.shape == (3, 48, 72, 6)
    out = eng.stylize_group(frames, [None, None, None])
    one = eng.stylize_group(frames[1:2], [None])
    assert out.shape == (3, 48, 72, 3) and out.dtype == np.uint8
    # per-tile math does not depend on co-batching (instance norm is per
    # tile), so within 1 count of the frame run alone
    assert np.abs(out[1].astype(int) - one[0].astype(int)).max() <= 1


def test_engine_refusals(scene, tmp_path):
    with pytest.raises(NotImplementedError):
        _engine(scene, tmp_path, "inference.precision=32_fast")
    # fullframe mode is ported; a mode that does not exist is an error
    assert _engine(scene, tmp_path,
                   "inference.mode=fullframe").mode == "fullframe"
    with pytest.raises(ValueError, match="inference.mode"):
        _engine(scene, tmp_path, "inference.mode=tile")
    # the temporal chain with flows from files is ported: 3 RGB channels
    # and the 3 of the warped previous output make the checkpoint's 6
    eng = _engine(scene, tmp_path, "inference.temporal.enabled=true",
                  "paths.additional_channels={}")
    assert eng.temporal_enabled and eng.total_channels == 6
    # and with the flow computed on the device
    assert _engine(scene, tmp_path, "inference.temporal.enabled=true",
                   "paths.additional_channels={}",
                   "inference.temporal.flow_source=device"
                   ).temporal_flow_source == "device"
    # knobs the JAX engine acts on and the port does not yet: each is named
    for override, knob in [
            ("inference.quantize=int8", "quantize"),
            ("inference.file_shard=0/2", "file_shard"),
            ("inference.devices=2", "devices"),
            ("inference.devices=-1", "devices"),
            ("inference.watch.enabled=true", "watch.enabled")]:
        with pytest.raises(NotImplementedError, match=knob):
            _engine(scene, tmp_path, override,
                    "inference.temporal.enabled=true",
                    "paths.additional_channels={}")
    # the multi-stream temporal layout: a subdirectory per video
    streams = tmp_path / "streams"
    (streams / "shot_a").mkdir(parents=True)
    src = sorted((scene / "scene" / "input").glob("*.png"))[0]
    (streams / "shot_a" / src.name).write_bytes(src.read_bytes())
    eng.cfg["paths"]["input_dir"] = str(streams)
    with pytest.raises(NotImplementedError, match="multi-stream"):
        eng.process_directory()
    with pytest.raises(ValueError, match="quantize"):
        _engine(scene, tmp_path, "inference.quantize=int4")
    # debug_mode is ported: the tile-box overlays
    assert _engine(scene, tmp_path, "inference.debug_mode=true").debug_mode
    # the transport knobs change no output in the JAX package: no-ops here
    _engine(scene, tmp_path, "inference.crop_readback=off",
            "inference.upload=f32", "inference.mask_upload=u8")
    with pytest.raises(ValueError, match="Channel count mismatch"):
        _engine(scene, tmp_path, "paths.additional_channels=null")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _engine(scene, tmp_path, "inference.use_gpu=true")


def test_fractional_mask_composites_in_part_as_jax(scene, tmp_path):
    """A mask that is not {0, 1} reaches the program as fp32 (the engine
    casts only binary masks to uint8) and composites in part, as the JAX
    program does with the same mask."""
    import jax.numpy as jnp

    from patch_toon_tpu.infer.engine import make_multiframe_fn
    from patch_toon_tpu.infer.tiling import bucket_size, pack_boxes_multi
    from patch_toon_tpu.models import GeneratorJ as JaxGeneratorJ
    from patch_toon_tpu.utils.torch_compat import generator_params_from_torch

    eng = _engine(scene, tmp_path)
    frames = np.stack([eng.load_frame(p) for p in sorted(
        (scene / "scene" / "input").glob("*.png"))[:2]])
    mask = np.zeros((48, 72), np.float32)
    mask[4:40, 6:60] = 1.0
    mask[10:30, 20:50] = 0.5  # a partial composite
    masks = [mask, mask * 0.25]
    boxes = [eng.boxes_for(m, (48, 72)) for m in masks]
    got = eng.stylize_group(frames, masks, boxes)

    sd = torch.load(scene / "gen.ckpt", weights_only=True)["state_dict"]
    params, stats = generator_params_from_torch(
        {k: v.numpy() for k, v in sd.items()}, resnet_blocks=1,
        prefix="generator.")
    gen = JaxGeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                        use_bias=True, resnet_blocks=1)
    total = sum(map(len, boxes))
    fboxes, weights, _ = pack_boxes_multi(boxes, 16, bucket_size(total))
    fn = make_multiframe_fn(gen, 16, bucket_size(total), 2, 48, 72, 6,
                            jnp.float32)
    want, _ = fn({"params": params, "batch_stats": stats},
                 jnp.asarray(frames), jnp.asarray(fboxes),
                 jnp.asarray(weights), jnp.asarray(np.stack(masks)[..., None]))
    d = np.abs(got.astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1
    floored = eng.stylize_group(frames, [np.floor(m) for m in masks], boxes)
    assert (floored != got).any()  # the old uint8 cast floored 0.5 to 0


def test_to_signed_unit_is_the_ieee_table():
    """uint8 -> [-1, 1] gathers the 256 host values of / 255 * 2 - 1 in
    IEEE fp32 (the card checks its own copy bitwise in chip_smoke.py)."""
    from patch_toon_tpu_torch.infer.common import SIGNED_UNIT, _to_signed_unit

    a = np.arange(256, dtype=np.uint8)
    want = a.astype(np.float32) / np.float32(255.0) * np.float32(2.0) \
        - np.float32(1.0)
    assert SIGNED_UNIT.dtype == np.float32
    np.testing.assert_array_equal(SIGNED_UNIT.view(np.int32),
                                  want.view(np.int32))
    got = _to_signed_unit(torch.from_numpy(a).reshape(2, 8, 16, 1))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 16, 1)
    np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.int32),
                                  want.view(np.int32))
    f = torch.rand(3, 4)
    assert _to_signed_unit(f) is f


def test_port_imports_no_jax_pil_yaml_or_tqdm():
    """Every module of the port, and chip_smoke.py, import with JAX made
    unimportable, and leave no patch_toon_tpu (the JAX package) module
    behind, nor any PIL, yaml or tqdm module that importing torch did not
    already bring."""
    code = r"""
import importlib, pkgutil, re, sys
sys.modules["jax"] = None
import numpy, torch
before = set(sys.modules)  # torch itself may bring tqdm along
import patch_toon_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
jaxpkg = re.compile(r"^patch_toon_tpu(\.|$)")
bad = sorted(n for n in sys.modules
             if jaxpkg.match(n) or n.split(".")[0] in ("jax", "flax")
             or (n.split(".")[0] in ("PIL", "yaml", "tqdm")
                 and n not in before))
bad = [n for n in bad if sys.modules[n] is not None]
print("BAD", bad)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_port_sources_never_import_jax_or_the_jax_package():
    """No import of jax or of patch_toon_tpu (followed by "." or a word
    boundary, not by "_torch") anywhere, and no module-level import of PIL,
    yaml or tqdm."""
    import re

    anywhere = re.compile(r"^\s*(from|import)\s+(jax|flax|patch_toon_tpu"
                          r"(?!_torch)\b)", re.M)
    top = re.compile(r"^(from|import)\s+(PIL|yaml|tqdm)\b", re.M)
    files = sorted((REPO / "patch_toon_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "generator_torch.py",
        REPO / "tools" / "optical_flow_torch.py"]
    offenders = [str(f) for f in files
                 if anywhere.search(f.read_text()) or top.search(f.read_text())]
    assert not offenders, offenders
