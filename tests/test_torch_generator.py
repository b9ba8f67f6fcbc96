"""GeneratorJ of the port against the JAX GeneratorJ, and weight loading.

Weights made with numpy from a seed go into the flax tree and cross to the
port through ``generator_state_from_jax``. At fp32 (TF32 plays no part on
the CPU) the outputs agree within 2e-5 absolute: fp32 roundoff of convs and
InstanceNorm sums taken in other orders, on tanh outputs in [-1, 1].
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patch_toon_tpu.models import GeneratorJ as JaxGeneratorJ
from patch_toon_tpu.models.layers import upsample2x_bilinear_align_corners
from patch_toon_tpu.utils.torch_compat import (
    generator_params_from_torch,
    generator_params_to_torch,
)

from patch_toon_tpu_torch.models.generator import GeneratorJ, input_channels_of
from patch_toon_tpu_torch.models.layers import upsample2x
from patch_toon_tpu_torch.utils.weights import (
    generator_state_from_jax,
    load_generator_state,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(filters=(4, 8, 8, 8, 8, 4), use_bias=True, resnet_blocks=2)


def _jax_vars(c, seed, **kw):
    """flax variables with every leaf drawn from a numpy seed (running
    variances kept positive)."""
    gen = JaxGeneratorJ(input_channels=c, **kw)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, c)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return np.abs(a) + 0.5
        return a * (0.2 if "kernel" in name else 0.1)

    return gen, jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(gen, g_vars, x):
    return jax.jit(lambda v, a: gen.apply(v, a, train=False))(
        g_vars, jnp.asarray(x))


def _port(g_vars, c, **kw):
    model = GeneratorJ(input_channels=c, **kw).eval()
    sd = generator_state_from_jax(
        g_vars["params"], g_vars.get("batch_stats", {}),
        resnet_blocks=kw.get("resnet_blocks", 7),
        append_smoothers=kw.get("append_smoothers", True))
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("smoothers_tanh", [True, False])
def test_generator_matches_jax_fp32(smoothers_tanh):
    kw = dict(SMALL, append_smoothers=smoothers_tanh, tanh=smoothers_tanh)
    gen, g_vars = _jax_vars(6, seed=1, **kw)
    x = np.random.default_rng(2).uniform(-1, 1, (3, 24, 40, 6)).astype(
        np.float32)  # guide channels, non-square
    want = np.asarray(_apply(gen, g_vars, x))
    model = _port(g_vars, 6, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (3, 24, 40, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_generator_bf16_runs_with_fp32_norm_statistics():
    gen, g_vars = _jax_vars(6, seed=4, **SMALL)
    model = _port(g_vars, 6, **SMALL)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (2, 16, 16, 6)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.to(torch.bfloat16)
        got = model(x.bfloat16())
    assert got.dtype == torch.bfloat16
    assert model.smoothers[2].running_var.dtype == torch.float32
    # bf16 convs keep about 3 significant digits through 10 layers
    assert (got.float() - ref).abs().max() < 0.1


def test_upsample_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    want = np.asarray(upsample2x_bilinear_align_corners(jnp.asarray(x)))
    got = upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 20, 20, 256), (2, 40, 40, 192)])
def test_upsample_matches_jax_bitwise_at_bf16(shape):
    """At bf16 both packages interpolate with bf16 matrices (weights such
    as 1/3 rounded) and accumulate each two-term sum in fp32 with one
    rounding to bf16, so the results are bit for bit equal. With fp32
    weights, as F.interpolate has, about 46 % of the elements differ."""
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        shape).astype(np.float32)).bfloat16()
    want = upsample2x_bilinear_align_corners(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    got = upsample2x(x.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want.astype(jnp.float32)))


def test_generator_matches_jax_bf16():
    """The whole generator at bf16, port against JAX with the same weights.
    bf16 keeps about 3 significant digits: convolutions accumulated in other
    orders, and the port's activation applied before the rounding to bf16
    where the JAX plain path rounds first, leave up to 0.0056 on these tanh
    outputs (5.2e-4 mean); the bound is 0.02 (about 5 bf16 ulps at 1)."""
    kw = dict(SMALL)
    _, g_vars = _jax_vars(6, seed=1, **kw)
    gen = JaxGeneratorJ(input_channels=6, dtype=jnp.bfloat16, **kw)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (3, 24, 40, 6)).astype(np.float32)).bfloat16()
    want = np.asarray(jax.jit(lambda v, a: gen.apply(v, a, train=False))(
        g_vars, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ).astype(jnp.float32))
    model = _port(g_vars, 6, **kw)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(torch.bfloat16)  # as the engine does; BN stays fp32
    with torch.no_grad():
        got = model(x)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 24, 40, 3)
    d = np.abs(got.float().numpy() - want)
    assert d.max() < 0.02 and d.mean() < 2e-3, (d.max(), d.mean())


def test_state_from_jax_copies_and_matches_reference_mapping():
    _, g_vars = _jax_vars(3, seed=3, **SMALL)
    params = jax.tree_util.tree_map(np.array, g_vars["params"])
    stats = jax.tree_util.tree_map(np.array, g_vars["batch_stats"])
    sd = generator_state_from_jax(params, stats, resnet_blocks=2)
    ref = generator_params_to_torch(params, stats, resnet_blocks=2)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    before = sd["initial_conv.0.weight"].clone()
    params["initial_conv"]["conv"]["kernel"][...] += 1.0
    assert torch.equal(sd["initial_conv.0.weight"], before)  # no aliasing


def test_load_reference_and_gen_layouts(tmp_path):
    torch.manual_seed(0)
    model = GeneratorJ(input_channels=6, **SMALL)
    sd = model.state_dict()
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}
                | {"discriminator.x": torch.zeros(1)}},
               tmp_path / "ref.ckpt")
    torch.save({"gen": sd, "step": 3}, tmp_path / "gen.ckpt")
    for name in ("ref.ckpt", "gen.ckpt"):
        got = load_generator_state(tmp_path / name)
        assert input_channels_of(got) == 6
        GeneratorJ(input_channels=6, **SMALL).load_state_dict(got,
                                                              strict=True)
    torch.save({"other": 1}, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError):
        load_generator_state(tmp_path / "bad.ckpt")


def test_trained_checkpoint_matches_jax_at_full_width():
    """The repo's trained 6-channel checkpoint loads strictly at the shipped
    width and agrees with the JAX generator given the same weights."""
    ckpt = REPO / "docs" / "quality_2000" / "torch_train.ckpt"
    sd = load_generator_state(ckpt)
    model = GeneratorJ(input_channels=input_channels_of(sd), use_bias=True)
    model.load_state_dict(sd, strict=True)
    params, stats = generator_params_from_torch(
        {k: v.numpy() for k, v in sd.items()})
    gen = JaxGeneratorJ(input_channels=6, use_bias=True)
    x = np.random.default_rng(7).uniform(-1, 1, (1, 16, 24, 6)).astype(
        np.float32)
    want = np.asarray(_apply(gen, {"params": params, "batch_stats": stats},
                             x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_unported_norm_layer_raises():
    with pytest.raises(NotImplementedError):
        GeneratorJ(input_channels=3, norm_layer="batch_norm")
