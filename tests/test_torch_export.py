"""``tools/export_checkpoint_torch.py`` against ``tools/export_checkpoint.py``.

The JAX tool runs as a program (it is not edited or imported for its
export); its helpers ``_vgg_filler`` and ``VGG19_FEATURE_CONVS`` are read in
memory for the full-reference layout, whose 0.55 GB of zeros is never
written here.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.models.perception import init_vgg_params
from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import export_checkpoint as jax_export  # noqa: E402
import export_checkpoint_torch as export  # noqa: E402
from make_sample_scene import make_scene  # noqa: E402

LAST = REPO / "docs" / "quality_2000" / "ours_ckpt" / "last"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
           "zstandard", "patch_toon_tpu")


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    assert got["epoch"] == want["epoch"]
    assert got["global_step"] == want["global_step"]
    g, w = got["state_dict"], want["state_dict"]
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        assert (g[k].dtype, g[k].shape) == (v.dtype, v.shape), k
        assert torch.equal(g[k], v), k


def _jax_export(ckpt, out):
    return subprocess.run(
        [sys.executable, str(REPO / "tools" / "export_checkpoint.py"),
         str(ckpt), str(out)], capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """JAX's export of the committed checkpoint. Its ``meta.json`` has no
    ``discriminator_args``, so the JAX tool takes its default of 3 layers
    and fails on the 2-layer discriminator; it runs on a copy whose
    ``meta.json`` names the 2 layers, the only difference."""
    root = tmp_path_factory.mktemp("jax_export")
    res = _jax_export(LAST, root / "refused.ckpt")
    assert res.returncode != 0 and "intermediate_1" in res.stderr
    copy = root / "last"
    shutil.copytree(LAST, copy)
    meta = json.loads((copy / "meta.json").read_text())
    assert "discriminator_args" not in meta
    meta["discriminator_args"] = {"n_layers": 2}
    (copy / "meta.json").write_text(json.dumps(meta))
    res = _jax_export(copy, root / "jax.ckpt")
    assert res.returncode == 0, res.stderr[-2000:]
    return root / "jax.ckpt"


def test_default_export_is_jax_s_key_for_key(jax_file):
    """Bitwise JAX's export, key for key, from the committed directory as
    it is (the port counts the discriminator's layers in the tree)."""
    want = torch.load(str(jax_file), map_location="cpu", weights_only=True)
    got = export.export_state(LAST)
    _assert_same(got, want)
    sd = got["state_dict"]
    assert int(sd["generator.smoothers.2.num_batches_tracked"]) == \
        2 * got["global_step"]
    assert any(k.startswith("discriminator.") for k in sd)


def test_exports_with_jax_orbax_tensorstore_and_zstandard_unimportable(
        jax_file, tmp_path):
    """The tool as a program, with the JAX stack and the JAX package made
    unimportable: the same file, and none of them loaded."""
    out = tmp_path / "port.ckpt"
    code = f"""
import runpy, sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
sys.argv = ["export_checkpoint_torch.py", {str(LAST)!r}, {str(out)!r}]
try:
    runpy.run_path({str(REPO / "tools" / "export_checkpoint_torch.py")!r},
                   run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
loaded = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
          and sys.modules[m] is not None]
assert not loaded, loaded
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Exported" in res.stdout
    _assert_same(torch.load(str(out), map_location="cpu", weights_only=True),
                 torch.load(str(jax_file), map_location="cpu",
                            weights_only=True))


@pytest.mark.parametrize("feature_layers,num_classes,npz", [
    ((0, 3, 5), None, False), ((0, 3, 5, 10), 40, False),
    ((0, 3, 5), None, True)])
def test_full_reference_model_layout_and_embedded_convs(
        feature_layers, num_classes, npz, tmp_path):
    """Under ``--full-reference-model``: JAX's key and shape set, the
    convs trained against embedded as ``init_vgg_params`` gives them (the
    seed-42 draw, or an ``--vgg-npz``'s), everything else zero."""
    vgg_npz = None
    if npz:
        rng = np.random.default_rng(5)
        vgg_npz = str(tmp_path / "vgg.npz")
        np.savez(vgg_npz, **{
            f"features.{i}.{k}": rng.standard_normal(
                (o, c, 3, 3) if k == "weight" else (o,)).astype(np.float32)
            for i, (o, c) in jax_export.VGG19_FEATURE_CONVS.items()
            for k in ("weight", "bias")})
    got = export.export_state(LAST, True, num_classes, vgg_npz,
                              feature_layers)["state_dict"]
    base = export.export_state(LAST)["state_dict"]
    filler = jax_export._vgg_filler(num_classes)
    want_keys = {**{f"perception_loss_model.{k}": v.shape
                    for k, v in filler.items()},
                 **{k: tuple(v.shape) for k, v in base.items()}}
    assert {k: tuple(v.shape) for k, v in got.items()} == want_keys
    trained = init_vgg_params(feature_layers,
                              weights_path=vgg_npz)["params"]
    embedded = set()
    for name, p in trained.items():
        pre = f"perception_loss_model.model.features.{name.split('_')[1]}"
        np.testing.assert_array_equal(
            got[pre + ".weight"].numpy(),
            np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(got[pre + ".bias"].numpy(),
                                      np.asarray(p["bias"]))
        embedded |= {pre + ".weight", pre + ".bias"}
    assert len(embedded) == 2 * len(trained)
    for k, v in filler.items():
        k = f"perception_loss_model.{k}"
        if k in embedded:
            continue
        if v.any():  # mean and std
            np.testing.assert_array_equal(got[k].numpy(), v)
        else:
            assert not torch.any(got[k]), k


def test_exported_file_serves_as_the_directory_does(tmp_path):
    """The committed directory and its export, each as
    ``paths.checkpoint`` of a tiled engine: the same frame, bitwise; and a
    ``.ckpt`` of the port's own layout exports to itself."""
    out = tmp_path / "last.ckpt"
    export.save(export.export_state(LAST), out)
    make_scene(str(tmp_path / "s"), frames=1, height=96, width=128, seed=4)
    s = tmp_path / "s"
    src = sorted((s / "input").iterdir())[0]
    frames = []
    for ckpt in (LAST, out):
        eng = StyleTransferInference(compose(
            REPO / "config", "inference", overrides=[
                f"paths.checkpoint={ckpt}", f"paths.input_dir={s / 'input'}",
                f"paths.mask_dir={s / 'mask'}",
                f"paths.output_dir={tmp_path / 'out'}",
                f"paths.additional_channels.point_vector.path="
                f"{s / 'tracking'}",
                "inference.use_gpu=false", "inference.precision=32"]))
        dst = tmp_path / f"{len(frames)}.png"
        eng.process_image(src, s / "mask" / src.name, dst)
        frames.append(np.asarray(Image.open(dst)))
    assert frames[0].std() > 1.0
    np.testing.assert_array_equal(frames[0], frames[1])
    again = export.export_state(out)
    _assert_same(again, torch.load(str(out), map_location="cpu",
                                   weights_only=True))


def test_a_file_without_generator_weights_is_refused(tmp_path):
    bad = tmp_path / "bad.ckpt"
    torch.save({"state_dict": {"x": torch.zeros(1)}}, bad)
    with pytest.raises(ValueError, match="not a training checkpoint"):
        export.export_state(bad)
