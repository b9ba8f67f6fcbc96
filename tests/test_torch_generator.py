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
        append_smoothers=kw.get("append_smoothers", True),
        norm_layer=kw.get("norm_layer", "instance_norm"))
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


NO_NORM = [None, "none"]


@pytest.mark.parametrize("norm_layer", ["instance_norm", None, "none",
                                        "batch_norm", "group_norm"])
def test_norm_layer_accept_and_refuse_rules_match_jax(norm_layer):
    """The generator refuses what JAX's ``ConvBlock`` refuses (BatchNorm
    inside a conv block) and builds no norm for every value but
    "instance_norm"; the discriminator takes every value, normalizing only
    for "instance_norm" (JAX ``discriminator.py:54``)."""
    from patch_toon_tpu.models import DiscriminatorN_IN as JaxD

    from patch_toon_tpu_torch.models.discriminator import DiscriminatorN_IN

    gen = JaxGeneratorJ(input_channels=3, norm_layer=norm_layer, **SMALL)
    try:
        jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 16, 16, 3)))
        jax_refuses = False
    except NotImplementedError:
        jax_refuses = True
    assert jax_refuses == (norm_layer == "batch_norm")
    if jax_refuses:
        with pytest.raises(NotImplementedError, match="batch_norm"):
            GeneratorJ(input_channels=3, norm_layer=norm_layer, **SMALL)
    else:
        port = GeneratorJ(input_channels=3, norm_layer=norm_layer, **SMALL)
        assert port.norm == (norm_layer == "instance_norm")
    jd = JaxD(num_filters=8, n_layers=2, norm_layer=norm_layer)
    jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    disc = DiscriminatorN_IN(num_filters=8, n_layers=2,
                             norm_layer=norm_layer)
    assert disc.norm == (norm_layer == "instance_norm")


@pytest.mark.parametrize("norm_layer", NO_NORM)
def test_no_norm_networks_match_jax(norm_layer):
    """``norm_layer`` null / "none": the generator (forward and the
    gradient of its inputs and weights) and the discriminator against
    JAX's on the same converted weights, fp32 roundoff; the weights cross
    both ways (the residual blocks' second conv is ``block.3``)."""
    from patch_toon_tpu.models import DiscriminatorN_IN as JaxD

    from patch_toon_tpu_torch.models.discriminator import DiscriminatorN_IN
    from patch_toon_tpu_torch.utils.weights import (
        discriminator_state_from_jax,
        generator_state_to_jax,
    )

    kw = dict(SMALL, norm_layer=norm_layer)
    gen, g_vars = _jax_vars(6, seed=11, **kw)
    x = np.random.default_rng(12).uniform(-1, 1, (2, 24, 32, 6)).astype(
        np.float32)
    want = np.asarray(_apply(gen, g_vars, x))
    model = _port(g_vars, 6, **kw)
    assert "resnet_blocks.0.block.3.weight" in model.state_dict()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = model(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-5)
    # the gradient of sum(out) by the input and by the stem's kernel
    got.sum().backward()
    gx, gp = jax.jit(jax.grad(lambda a, v: gen.apply(v, a, train=False).sum(),
                              argnums=(0, 1)))(jnp.asarray(x), g_vars)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=2e-4)
    stem = np.asarray(gp["params"]["initial_conv"]["conv"]["kernel"])
    np.testing.assert_allclose(
        model.initial_conv[0].weight.grad.numpy().transpose(2, 3, 1, 0),
        stem, rtol=1e-4, atol=1e-4 * np.abs(stem).max())
    params, stats = generator_state_to_jax(model.state_dict(), 2,
                                           norm_layer=norm_layer)
    ref = generator_params_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()},
        resnet_blocks=2, norm_layer=norm_layer)
    jax.tree.map(np.testing.assert_array_equal, (params, stats), ref)

    jd = JaxD(num_filters=8, n_layers=2, norm_layer=norm_layer)
    xd = np.random.default_rng(13).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    rng = np.random.default_rng(14)
    d_params = jax.tree.map(
        lambda a: (rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32),
        jd.init(jax.random.PRNGKey(0), jnp.asarray(xd))["params"])
    want = np.asarray(jd.apply({"params": d_params}, jnp.asarray(xd),
                               train=True))
    disc = DiscriminatorN_IN(num_filters=8, n_layers=2,
                             norm_layer=norm_layer).train()
    disc.load_state_dict(discriminator_state_from_jax(d_params, 2),
                         strict=True)
    with torch.no_grad():
        got = disc(torch.from_numpy(xd)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm_layer", NO_NORM)
def test_no_norm_int8_generator_matches_jax(norm_layer):
    """The w8a8 sites of a generator without norms take a conv's or an
    activation's output: the port calibrates JAX's scales (within 1e-5
    relative) and its int8 forward on JAX's scales is JAX's int8 generator
    within fp32 roundoff, while int8 moves the output visibly from the fp
    one."""
    from patch_toon_tpu_torch.utils.weights import (
        generator_scales_from_jax,
        load_quant_scales,
    )

    kw = dict(SMALL, norm_layer=norm_layer)
    gen, g_vars = _jax_vars(6, seed=15, **kw)
    x = np.random.default_rng(16).uniform(-1, 1, (2, 24, 32, 6)).astype(
        np.float32)
    _, mut = jax.jit(lambda a: gen.clone(quant_mode="calib").apply(
        g_vars, a, train=False, mutable=["quant"]))(x)
    want = np.asarray(jax.jit(lambda a: gen.clone(quant_mode="int8").apply(
        {**g_vars, "quant": mut["quant"]}, a, train=False))(x))
    model = _port(g_vars, 6, **kw).to(memory_format=torch.channels_last)
    with torch.no_grad():
        model.quant_mode = "calib"
        model(torch.from_numpy(x))
    scales = generator_scales_from_jax(
        jax.tree_util.tree_map(np.asarray, mut["quant"]))
    for path, layer in model.quant_layers().items():
        np.testing.assert_allclose(float(layer.a_scale), float(scales[path]),
                                   rtol=1e-5)
        layer.quantize_weights()
    load_quant_scales(model, scales)
    model.quant_mode = "int8"
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    fp = np.asarray(_apply(gen, g_vars, x))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert np.abs(fp - want).max() > 1e-3


@pytest.mark.parametrize("norm_layer", NO_NORM)
def test_no_norm_trains_through_fit_and_serves(norm_layer, tmp_path):
    """One training step through ``fit`` with neither network normalizing,
    then its checkpoint served full-frame by the engine: the frame the
    trained generator gives, within 1 count."""
    from patch_toon_tpu_torch.config.compose import compose
    from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
    from patch_toon_tpu_torch.infer.common import _composite_u8
    from patch_toon_tpu_torch.infer.engine import StyleTransferInference
    from patch_toon_tpu_torch.train import loop
    from patch_toon_tpu_torch.train.model import StyleTransferModel

    rng = np.random.default_rng(8)
    frames = [rng.uniform(-1, 1, (24, 24, 3)).astype(np.float32)
              for _ in range(4)]
    mask = np.zeros((24, 24), np.float32)
    mask[12, 12] = 1
    data = StyleTransferDataset(frames[:2], frames[2:], [mask, mask],
                                [f[..., :3] for f in frames[:2]], [3],
                                patch_size=32, device="cpu")
    opt = dict(lr=4e-4, betas=[0.9, 0.999], weight_decay=1e-5)
    model = StyleTransferModel(
        generator_config={"type": "GeneratorJ", "args": dict(
            use_bias=True, resnet_blocks=1, filters=[4, 8, 8, 8, 8, 4],
            norm_layer=norm_layer, input_channels="auto")},
        discriminator_config={"type": "DiscriminatorN_IN", "args": dict(
            num_filters=8, n_layers=2, norm_layer=norm_layer,
            use_bias=True, input_channels=3)},
        training_config=dict(
            batch_size=4, reconstruction_weight=4.0, adversarial_weight=0.5,
            use_image_loss=True, reconstruction_criterion="MSELoss",
            adversarial_criterion="MSELoss", precision="32", max_steps=1,
            log_every_n_steps=1),
        optimizer_config=dict(generator=opt, discriminator=opt),
        data_config=dict(patch_size=32, additional_channels={
            "guide": {"path": "unused", "depth": 3}}))
    seen = []
    state = loop.fit(model, data, str(tmp_path / "run"), seed=0,
                     progress=False, on_step=lambda s, m: seen.append(
                         {k: float(v) for k, v in m.items()}))
    assert state.step == 1 and len(seen) == 1
    assert all(np.isfinite(v) for v in seen[0].values())
    assert not state.generator.norm and not state.discriminator.norm
    ckpt = tmp_path / "run" / "checkpoints" / "last.ckpt"
    over = [f"paths.checkpoint={ckpt}", "inference.use_gpu=false",
            "inference.precision=32", "inference.mode=fullframe",
            "paths.additional_channels.point_vector.path=unused",
            "model.generator.args.filters=[4,8,8,8,8,4]",
            "model.generator.args.resnet_blocks=1",
            f"model.generator.args.norm_layer={norm_layer or 'null'}"]
    eng = StyleTransferInference(compose(REPO / "config", "inference",
                                         overrides=over))
    frame = (rng.random((20, 28, 6)) * 255).astype(np.uint8)
    got = eng.process_large_image(frame)
    x = torch.from_numpy(frame.astype(np.float32) / 255 * 2 - 1)[None]
    with torch.no_grad():
        out = state.generator.eval()(x)
    want = _composite_u8(x[..., :3], out, torch.ones(1, 20, 28, 1))[0][0]
    d = np.abs(got.astype(int) - want.numpy().astype(int))
    assert got.shape == (20, 28, 3) and d.max() <= 1
