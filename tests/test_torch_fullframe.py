"""The port's full-frame serving (``inference.mode: fullframe``) against the
JAX package's, at precision 32 on the CPU.

Same generator weights (numpy, from a seed, carried across by
``utils/weights.py``), same uint8 frames and masks. Tolerances: uint8
outputs within 1 count (fp32 roundoff can move a value across a rounding
boundary, as ``tests/test_torch_programs.py``); the fp32 composite within
1e-5 (two generators' fp32 roundoff, sums taken in other orders).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.infer.programs import make_fullframe_fn as jax_fullframe
from patch_toon_tpu.models import GeneratorJ as JaxGeneratorJ

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

from patch_toon_tpu_torch import cli  # noqa: E402
from patch_toon_tpu_torch.config.compose import compose  # noqa: E402
from patch_toon_tpu_torch.infer.engine import (  # noqa: E402
    StyleTransferInference,
)
from patch_toon_tpu_torch.infer.programs import make_fullframe_fn  # noqa
from patch_toon_tpu_torch.models.generator import GeneratorJ  # noqa: E402
from patch_toon_tpu_torch.utils.weights import (  # noqa: E402
    generator_state_from_jax,
)

H, W, C = 46, 63, 6  # neither a multiple of 4: both get padded
ARCH = dict(filters=(4, 8, 8, 8, 8, 4), use_bias=True, resnet_blocks=1)


@pytest.fixture(scope="module")
def models():
    gen = JaxGeneratorJ(input_channels=C, **ARCH)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, C)))
    rng = np.random.default_rng(21)

    def draw(path, leaf):
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        return np.abs(a) + 0.5 if "var" in name else a * 0.2

    g_vars = jax.tree_util.tree_map_with_path(draw, shapes)
    port = GeneratorJ(input_channels=C, **ARCH).eval()
    port.load_state_dict(generator_state_from_jax(
        g_vars["params"], g_vars["batch_stats"], resnet_blocks=1),
        strict=True)
    return gen, g_vars, port


@pytest.mark.parametrize("fractional", [False, True])
def test_fullframe_program_matches_jax(models, fractional):
    """Padding to 48x64 after the normalization, the crop after the head
    and the composite, with a binary and with a fractional mask."""
    gen, g_vars, port = models
    rng = np.random.default_rng(5)
    frame = (rng.random((H, W, C)) * 256).astype(np.uint8)
    mask = np.zeros((H, W), np.float32)
    mask[3:40, 5:58] = 1.0
    if fractional:
        mask[10:30, 12:50] = 0.35
    want_u8, want_f = jax_fullframe(gen, H, W, C, jnp.float32)(
        g_vars, jnp.asarray(frame), jnp.asarray(mask[..., None]))
    u8, out = make_fullframe_fn(port, H, W, torch.float32)(
        torch.from_numpy(frame)[None], torch.from_numpy(mask)[None, ..., None])
    d = np.abs(u8[0].numpy().astype(int) - np.asarray(want_u8).astype(int))
    assert u8.shape == (1, H, W, 3) and d.max() <= 1, d.max()
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-5)
    # the generator's output reaches the composite inside the mask only
    inside = mask > 0
    assert (u8[0].numpy()[~inside] == frame[..., :3][~inside]).all()
    assert (u8[0].numpy()[inside] != frame[..., :3][inside]).mean() > 0.5


def test_fullframe_pads_after_normalizing(models):
    """The padded pixels are zeros in [-1, 1] space (the value 127.5), not
    the uint8 zero (-1): a frame whose padding were -1 would give other
    InstanceNorm statistics and other outputs."""
    _, _, port = models
    rng = np.random.default_rng(8)
    frame = torch.from_numpy((rng.random((1, H, W, C)) * 256).astype(
        np.uint8))
    mask = torch.ones((1, H, W, 1))
    seen = []
    hook = port.initial_conv[0].register_forward_pre_hook(
        lambda m, args: seen.append(args[0].detach().clone()))
    try:
        make_fullframe_fn(port, H, W, torch.float32)(frame, mask)
    finally:
        hook.remove()
    x = seen[0].permute(0, 2, 3, 1)  # NHWC
    assert x.shape == (1, 48, 64, C)
    assert (x[:, H:] == 0).all() and (x[:, :, W:] == 0).all()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fullframe")
    make_scene(str(root / "scene"), frames=3, height=46, width=70, seed=7)
    torch.manual_seed(11)
    model = GeneratorJ(input_channels=6, **ARCH)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    sd = {f"generator.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, root / "gen.ckpt")
    return root


def _overrides(root, out):
    s = root / "scene"
    return [f"paths.checkpoint={root / 'gen.ckpt'}",
            f"paths.input_dir={s / 'input'}", f"paths.mask_dir={s / 'mask'}",
            f"paths.output_dir={out}",
            f"paths.additional_channels.point_vector.path={s / 'tracking'}",
            "inference.use_gpu=false", "inference.precision=32",
            "inference.mode=fullframe",
            "model.generator.args.filters=[4,8,8,8,8,4]",
            "model.generator.args.resnet_blocks=1", "data.patch_size=16"]


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


def test_fullframe_directory_matches_jax_engine(scene):
    """``generator_torch.py`` in full-frame mode writes the frames of
    ``generator.py`` in full-frame mode, within 1 count; the stream writes
    what ``stylize_group`` gives frame by frame, bit for bit."""
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    jax_out, port_out = scene / "jax", scene / "port"
    JaxEngine(jax_compose(REPO / "config", "inference", overrides=_overrides(
        scene, jax_out))).process_directory(progress=False)
    assert cli.main(_overrides(scene, port_out)) == 0
    want, got = _read(jax_out), _read(port_out)
    assert len(got) == 3 and got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape == (46, 70, 3)
        assert np.abs(got[name] - want[name]).max() <= 1, name

    eng = StyleTransferInference(compose(REPO / "config", "inference",
                                         overrides=_overrides(scene,
                                                              port_out)))
    for name in want:
        frame = eng.load_frame(scene / "scene" / "input" / name)
        mask = eng.load_eroded_mask(scene / "scene" / "mask" / name,
                                    frame.shape[:2])
        one = eng.stylize_group(frame[None], [mask])[0]
        np.testing.assert_array_equal(one, got[name])
