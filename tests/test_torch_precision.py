"""Precision ``32_fast`` in the port against the JAX package, on the CPU.

JAX's ``32_fast`` is ``conv_precision="high"`` (``lax.Precision.HIGH``),
which XLA on the CPU runs as plain fp32; the port's is three TF32 products
of a hi/lo split (``models/layers.py::conv2d_3xtf32``), which on the CPU
are three fp32 convs of the split operands (no TF32 there) and so differ
from one fp32 conv by the dropped lo*lo term and the sums' order.
Tolerances:

- the generator at JAX's test's widths (tests/test_models_parity.py): the
  port's ``32_fast`` within 2e-5 absolute and relative of JAX's ``high``
  generator and of JAX's fp32 one, JAX's own bar;
- the split conv's gradients within 2e-5 of the fp64 conv's largest
  magnitude (the card's cases are in tests/test_torch_cuda.py);
- a ``32_fast`` training step against JAX's ``32_fast`` step within
  tests/test_torch_train.py's tolerances (losses 1e-5 / 1e-4, the
  first-step gradients 5e-5 in relative L2);
- engine frames within 1 uint8 count of the JAX engine's.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from patch_toon_tpu.models import GeneratorJ as JaxGeneratorJ

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import (
    StyleTransferInference,
    _resolve_dtype,
)
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.models.layers import (
    conv2d_3xtf32,
    resolve_conv_precision,
)
from patch_toon_tpu_torch.train.model import resolve_dtype
from patch_toon_tpu_torch.train.parity import (
    assert_first_step_close,
    first_step_agreement,
)
from patch_toon_tpu_torch.utils.weights import generator_state_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "tests"))

from make_sample_scene import make_scene  # noqa: E402
from test_torch_train import (  # noqa: E402,F401
    _assert_bn_close,
    _port_pairs,
    _steps_from_one_start,
    jax_steps,
)


def test_32_fast_generator_matches_jax_high_and_fp32():
    """JAX's test's generator (6 channels, full width, 7 blocks, two 80x80
    inputs, seed 0): the port at ``32_fast`` within 2e-5 of JAX's
    ``conv_precision="high"`` generator and of its fp32 one."""
    gen32 = JaxGeneratorJ(input_channels=6, use_bias=True, tanh=True,
                          append_smoothers=True, resnet_blocks=7,
                          filters=(32, 64, 128, 128, 128, 64))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 80, 80, 6)).astype(
        np.float32)
    variables = gen32.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    want32 = np.asarray(gen32.apply(variables, jnp.asarray(x), train=False))
    want_high = np.asarray(gen32.clone(conv_precision="high").apply(
        variables, jnp.asarray(x), train=False))
    sd = generator_state_from_jax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]))
    port = GeneratorJ(input_channels=6, use_bias=True,
                      conv_precision="high").eval()
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    for want in (want_high, want32):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert not np.array_equal(got, want32)  # the split ran


@pytest.mark.parametrize("cin,cout,k,stride,pad", [
    (6, 8, 7, 1, 3), (8, 16, 3, 2, 1), (16, 16, 3, 1, 1), (12, 1, 4, 1, 1)])
def test_split_conv_gradients_match_the_fp64_conv(cin, cout, k, stride, pad):
    """The forward and both gradients of ``conv2d_3xtf32`` (a custom
    autograd function: rounding carries no gradient, so the backward takes
    the same split) against the fp64 conv's, within 2e-5 of each one's
    largest magnitude; the bias gradient is the plain sum."""
    rng = np.random.default_rng(cin * k)
    x = rng.uniform(-1, 1, (3, cin, 17, 19))
    w = rng.standard_normal((cout, cin, k, k)) / (cin * k * k)
    b = rng.standard_normal(cout) * 0.1
    gy_shape = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), None,
                        stride, pad).shape
    gy = rng.standard_normal(tuple(gy_shape))
    x32, w32, b32 = (torch.tensor(a, dtype=torch.float32,
                                  requires_grad=True) for a in (x, w, b))
    y = conv2d_3xtf32(x32.contiguous(memory_format=torch.channels_last),
                      w32, b32, (stride, stride), (pad, pad))
    got = torch.autograd.grad(y, (x32, w32, b32),
                              torch.tensor(gy, dtype=torch.float32))
    x64, w64, b64 = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y64 = F.conv2d(x64, w64, b64, stride, pad)
    want = torch.autograd.grad(y64, (x64, w64, b64), torch.from_numpy(gy))
    for g, r in ((y, y64), *zip(got, want)):
        err = float((g.detach().double() - r.detach()).abs().max())
        assert err <= 2e-5 * float(r.detach().abs().max()), err


@pytest.mark.parametrize("precision", ["32_fast", "tf32", "fp32_fast", "32",
                                       "bf16", "16"])
def test_precision_names_resolve_as_jax(precision):
    """Each name's tensor type and conv precision are JAX's
    (``train/model.py::_resolve_dtype``, ``_resolve_conv_precision``), in
    serving and in training alike."""
    from patch_toon_tpu.train.model import (
        _resolve_conv_precision,
        _resolve_dtype as jax_dtype,
    )

    want = torch.bfloat16 if jax_dtype(precision) == jnp.bfloat16 \
        else torch.float32
    assert _resolve_dtype(precision) == resolve_dtype(precision) == want
    assert resolve_conv_precision(precision) == \
        _resolve_conv_precision(precision)


ARCH = ["model.generator.args.filters=[4,8,8,8,8,4]",
        "model.generator.args.resnet_blocks=1", "data.patch_size=16"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_precision")
    make_scene(str(root / "scene"), frames=3, height=48, width=72, seed=4)
    torch.manual_seed(6)
    model = GeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}},
               root / "gen.ckpt")
    return root


def _overrides(root, out, *extra):
    s = root / "scene"
    return [f"paths.checkpoint={root / 'gen.ckpt'}",
            f"paths.input_dir={s / 'input'}", f"paths.mask_dir={s / 'mask'}",
            f"paths.output_dir={out}",
            f"paths.additional_channels.point_vector.path={s / 'tracking'}",
            "inference.use_gpu=false", *ARCH, *extra]


def _port(root, out, *extra):
    return StyleTransferInference(compose(REPO / "config", "inference",
                                          overrides=_overrides(root, out,
                                                               *extra)))


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


def test_strict_flags_survive_a_32_fast_engine(scene, tmp_path):
    """A ``32_fast`` engine that has run its split convs leaves cuDNN's
    TF32 flag as it found it, and a precision-32 engine built after it
    finds the strict flags (TF32 off in convs and matmuls, fp32 matmuls at
    "highest"); the split's own scope restores a flag that was on."""
    torch.backends.cudnn.allow_tf32 = True
    fast = _port(scene, tmp_path, "inference.precision=32_fast")
    assert fast.conv_precision == "high" and fast.dtype == torch.float32
    frame = fast.load_frame(sorted((scene / "scene" / "input").glob(
        "*.png"))[0])
    fast.process_large_image(frame)
    assert torch.backends.cudnn.allow_tf32 is False
    strict = _port(scene, tmp_path, "inference.precision=32")
    strict.process_large_image(frame)
    assert strict.conv_precision is None
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    torch.backends.cudnn.allow_tf32 = True
    x = torch.rand(1, 4, 8, 8).contiguous(memory_format=torch.channels_last)
    conv2d_3xtf32(x, torch.rand(2, 4, 3, 3), None, (1, 1), (1, 1))
    assert torch.backends.cudnn.allow_tf32 is True
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("mode", ["tiled", "fullframe"])
def test_32_fast_engine_frames_match_jax(scene, tmp_path, mode):
    """The directory at ``32_fast`` (upload auto: u8, as JAX) within 1
    count of the JAX engine at ``32_fast``, and of the port at 32."""
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    over = ["inference.precision=32_fast", f"inference.mode={mode}"]
    jax_eng = JaxEngine(jax_compose(REPO / "config", "inference",
                                    overrides=_overrides(
                                        scene, tmp_path / "jax", *over)))
    jax_eng.process_directory(progress=False)
    eng = _port(scene, tmp_path / "port", *over)
    assert eng.temporal_flow_f16 == jax_eng.temporal_flow_f16 is True
    assert eng.process_directory() == 3
    _port(scene, tmp_path / "p32", "inference.precision=32",
          f"inference.mode={mode}").process_directory()
    want, got, strict = (_read(tmp_path / d) for d in ("jax", "port", "p32"))
    assert len(got) == 3 and got.keys() == want.keys() == strict.keys()
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 1, name
        assert np.abs(got[name] - strict[name]).max() <= 1, name


def test_32_fast_training_step_matches_jax(jax_steps):
    """One GAN step at ``32_fast`` (generator and discriminator convs
    split, the VGG strict) against JAX's ``32_fast`` step from the same
    parameters and batch, at tests/test_torch_train.py's tolerances."""
    new, jmet, ps, met = _steps_from_one_start(jax_steps, "one_forward",
                                               "32_fast")
    assert ps.generator.initial_conv[0].conv_precision == "high"
    assert ps.discriminator.initial[0].conv_precision == "high"
    for k in jmet:
        tol = 1e-5 if k.startswith("d_") else 1e-4
        assert abs(float(met[k]) - float(jmet[k])) <= tol, k
    pairs, stats_after = _port_pairs(new, ps)
    for tag, p in pairs.items():
        assert_first_step_close(first_step_agreement(p), 5e-5, tag)
    _assert_bn_close(stats_after, new)
