"""The port's training slice against the JAX package, on the CPU.

Small widths (2 residual blocks, filters 8/16/32/32/32/16, a discriminator
of 8 filters, 32x32 patches, batch 4), inputs from a numpy seed, weights
carried across from the JAX side. Tolerances:

- InstanceNorm backward (plain) against ``jax.grad``: 1e-5 (fp32 sums in
  other orders);
- discriminator and VGG-prefix forwards: 1e-5 absolute (fp32 roundoff);
  losses and ``perceptual_mse``: 1e-6;
- masks, patches and the dataset tables: bit for bit;
- one GAN step against ``make_train_step(model, sampler=None)``: those of
  tests/test_train_step.py::test_full_gan_step_parity_vs_torch (losses
  1e-5 for D and 1e-4 for G; parameters 1.5e-4 for kernels and 9e-4
  otherwise; BatchNorm mean 1e-5, variance 1e-3) through
  ``patch_toon_tpu_torch/train/parity.py::first_step_agreement``: Adam's
  first step moves a parameter by lr * g / (|g| + 1e-8), so the
  parameters are held where both first-step gradients reach 1e-7 (below
  it the update is set by roundoff; the elements there are the biases
  that feed an InstanceNorm, whose gradient is 0 but for roundoff, and a
  few others), with no opposite signs there; the gradients within 5e-5
  in relative L2 norm, over each network and each conv kernel (measured
  6.0e-6 and 6.6e-6 at most);
- one bf16 GAN step against JAX's bf16 policy: losses within 2e-3
  (measured 5.9e-4), BatchNorm as at fp32 (measured 4.9e-6), and each
  network's first-step gradient no further from JAX's fp32 step than 1.25
  times JAX's own bf16 step is (measured 0.300 against 0.291 for G,
  0.090 against 0.123 for D: bf16 moves a step's gradient by a third);
- a served checkpoint: within 1 uint8 count of the JAX engine.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.models import DiscriminatorN_IN as JaxD
from patch_toon_tpu.models.layers import instance_norm, leaky_relu
from patch_toon_tpu.models.perception import (
    PerceptualVGG19 as JaxVGG,
    flatten_features as jax_flatten,
    init_vgg_params,
    perceptual_mse as jax_perceptual_mse,
)
from patch_toon_tpu.ops.masks import dilate_valid_centers as jax_dilate
from patch_toon_tpu.ops.patches import cut_patches as jax_cut
from patch_toon_tpu.ops.patches import pad_images_for_gather as jax_pad
from patch_toon_tpu.train import StyleTransferModel as JaxModel
from patch_toon_tpu.train import losses as jax_losses
from patch_toon_tpu.train import make_train_step as jax_make_train_step
from patch_toon_tpu.utils.torch_compat import (
    discriminator_params_from_torch,
    generator_params_from_torch,
)

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.config.defaults import training_config
from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
from patch_toon_tpu_torch.models.discriminator import DiscriminatorN_IN
from patch_toon_tpu_torch.models.perception import (
    FALLBACK_NPZ,
    PerceptualVGG19,
    flatten_features,
    perceptual_mse,
)
from patch_toon_tpu_torch.ops.instance_norm import (
    InstanceNormAct,
    instance_norm_act_backward,
    instance_norm_act_backward_plain,
    instance_norm_act_plain,
)
from patch_toon_tpu_torch.ops.masks import dilate_valid_centers
from patch_toon_tpu_torch.ops.patches import cut_patches, pad_images_for_gather
from patch_toon_tpu_torch.train import losses
from patch_toon_tpu_torch.train.checkpoints import CheckpointManager
from patch_toon_tpu_torch.train.model import StyleTransferModel
from patch_toon_tpu_torch.train.optim import Adam
from patch_toon_tpu_torch.train.parity import (
    assert_device_step_parity,
    assert_first_step_close,
    device_step_parity,
    first_step_agreement,
)
from patch_toon_tpu_torch.train.step import make_train_step
from patch_toon_tpu_torch.utils.weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
    load_generator_state,
    vgg_state_from_jax,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

ACTS = [None, "relu", "leaky_relu"]
PS, B = 32, 4
GEN_ARGS = dict(use_bias=True, tanh=True, append_smoothers=True,
                resnet_blocks=2, filters=[8, 16, 32, 32, 32, 16],
                norm_layer="instance_norm", input_size=256,
                input_channels="auto")
DISC_ARGS = dict(num_filters=8, n_layers=2, use_noise=False, noise_sigma=0.2,
                 norm_layer="instance_norm", use_bias=True, input_channels=3)
SMALL_ARCH = ["model.generator.args.filters=[8,16,32,32,32,16]",
              "model.generator.args.resnet_blocks=2",
              "model.discriminator.args.num_filters=8",
              f"data.patch_size={PS}"]


def _configs(two_forward=False, guide_dropout_p=0.0, precision="32"):
    """The model's config dicts, one guide channel of depth 3 (so the
    generator takes 6 channels), as tests/test_train_step.py builds them."""
    return dict(
        generator_config={"type": "GeneratorJ", "args": dict(GEN_ARGS)},
        discriminator_config={"type": "DiscriminatorN_IN",
                              "args": dict(DISC_ARGS)},
        training_config=dict(
            batch_size=B, reconstruction_weight=4.0, adversarial_weight=0.5,
            use_image_loss=True, reconstruction_criterion="MSELoss",
            adversarial_criterion="MSELoss", use_gradient_clipping=True,
            gradient_clip_val=0.5, precision=precision,
            two_forward=two_forward,
            guide_dropout_p=guide_dropout_p, guide_dropout_depth=3),
        optimizer_config=dict(
            generator=dict(lr=4e-4, betas=[0.9, 0.999], weight_decay=1e-5),
            discriminator=dict(lr=4e-4, betas=[0.9, 0.999],
                               weight_decay=1e-5)),
        data_config=dict(patch_size=PS, additional_channels={
            "guide": {"path": "unused", "depth": 3}}),
        perception_loss_config={"weight": 6.0, "perception_model": {
            "type": "PerceptualVGG19", "args": {
                "feature_layers": [0, 3, 5], "use_normalization": False,
                "path": None}}})


def _jax_act(y, act):
    if act == "leaky_relu":
        return leaky_relu(y, 0.2)
    if act == "relu":
        return jax.nn.relu(y)
    return y


# ---------------------------------------------------------------- B1 grad

@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(3, 12, 10, 40), (2, 19, 19, 48)])
def test_instance_norm_backward_plain_matches_jax_grad(act, shape):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(_jax_act(instance_norm(a), act) * dy))(
        jnp.asarray(x))
    xt = torch.from_numpy(x)
    mean, rstd = _stats(xt)
    got = instance_norm_act_backward_plain(xt, torch.from_numpy(dy), mean,
                                           rstd, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the wrapper takes the plain version on the CPU
    torch.testing.assert_close(instance_norm_act_backward(
        xt, torch.from_numpy(dy), mean, rstd, act), got, rtol=0, atol=0)


def _stats(x):
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = torch.square(x32 - mean[:, None, None]).mean(dim=(1, 2))
    return mean, torch.rsqrt(var + 1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_instance_norm_function_gives_the_plain_gradient(act):
    """Through autograd, InstanceNormAct's output is the plain forward and
    its input gradient the plain backward; the derivative at exactly 0
    follows JAX (LeakyReLU passes 1, ReLU 0)."""
    rng = np.random.default_rng(12)
    a = rng.integers(-3, 4, (2, 4, 8, 8)).astype(np.float32)
    a[:, 0, 0, :] = 0
    a[:, -1, -1, :] = 0
    a[:, -1, -1, :] = -a.sum(axis=(1, 2))  # mean exactly 0: x^ = 0 at (0, 0)
    x = torch.from_numpy(a)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    xg = x.clone().requires_grad_(True)
    y = InstanceNormAct.apply(xg, act, 0.2, 1e-5)
    (dx,) = torch.autograd.grad(y, xg, dy)
    torch.testing.assert_close(y.detach(), instance_norm_act_plain(x, act),
                               rtol=0, atol=0)
    mean, rstd = _stats(x)
    torch.testing.assert_close(dx, instance_norm_act_backward_plain(
        x, dy, mean, rstd, act), rtol=0, atol=0)
    want = jax.grad(lambda a: jnp.sum(_jax_act(instance_norm(a), act)
                                      * dy.numpy()))(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ networks and losses

def _draw(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(np.shape(a))
                                   * scale).astype(np.float32), tree)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_discriminator_matches_jax(n_layers):
    args = dict(DISC_ARGS, n_layers=n_layers)
    jd = JaxD(**args)
    x = np.random.default_rng(1).uniform(-1, 1, (B, PS, PS, 3)).astype(
        np.float32)
    params = _draw(jd.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                   2)
    want = jd.apply({"params": params}, jnp.asarray(x), train=True)
    port = DiscriminatorN_IN(**args).train()
    port.load_state_dict(discriminator_state_from_jax(params, n_layers),
                         strict=True)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    # its state dict reads through the JAX package's converter
    back = discriminator_params_from_torch(
        {k: v.numpy() for k, v in port.state_dict().items()}, n_layers)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_vgg_fallback_npz_equals_jax_init():
    params = init_vgg_params([0, 3, 5])["params"]
    with np.load(FALLBACK_NPZ) as arrays:
        assert sorted(arrays) == sorted(
            f"features.{i}.{k}" for i in (0, 2, 5) for k in ("weight", "bias"))
        for name, p in params.items():
            i = int(name.split("_")[1])
            np.testing.assert_array_equal(
                arrays[f"features.{i}.weight"],
                np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
            np.testing.assert_array_equal(arrays[f"features.{i}.bias"],
                                          np.asarray(p["bias"]))
    port = PerceptualVGG19((0, 3, 5))
    for k, v in vgg_state_from_jax(params).items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=0)
    assert not any(p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("normalize", [False, True])
def test_vgg_prefix_and_perceptual_mse_match_jax(normalize):
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (B, PS, PS, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (B, PS, PS, 3)).astype(np.float32)
    jv = JaxVGG(feature_layers=(0, 3, 5), use_normalization=normalize)
    params = init_vgg_params([0, 3, 5])["params"]
    fa = jv.apply({"params": params}, jnp.asarray(a))
    fb = jv.apply({"params": params}, jnp.asarray(b))
    port = PerceptualVGG19((0, 3, 5), use_normalization=normalize)
    ga, gb = port(torch.from_numpy(a)), port(torch.from_numpy(b))
    for g, w in zip(ga, fa):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(flatten_features(ga).numpy(),
                               np.asarray(jax_flatten(fa)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(perceptual_mse(ga, gb)),
                               float(jax_perceptual_mse(fa, fb)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(losses.CRITERIA))
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    p = (rng.standard_normal((B, 8, 8, 3)) * 2).astype(np.float32)
    t = rng.uniform(-1, 1, p.shape).astype(np.float32)
    want = jax_losses.get_criterion(name)(jnp.asarray(p), jnp.asarray(t))
    got = losses.get_criterion(name)(torch.from_numpy(p), torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


def test_adam_matches_the_optax_chain():
    """Clip by global norm (both when it triggers and when it does not),
    coupled weight decay, Adam, two steps."""
    from patch_toon_tpu.train.optim import torch_adam

    rng = np.random.default_rng(5)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in
          ((4, 3, 3, 3), (4,), (2, 4, 1, 1))]
    tx = torch_adam(4e-4, weight_decay=1e-5, clip_norm=0.5)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = Adam(tp, 4e-4, weight_decay=1e-5, clip_norm=0.5)
    for scale in (1.0, 1e-3):  # global norm above, then below the limit
        g = [(rng.standard_normal(a.shape) * scale).astype(np.float32)
             for a in p0]
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = [a + u for a, u in zip(jp, upd)]
        opt.step([torch.from_numpy(a) for a in g])
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=0, atol=1e-7)


# ------------------------------------------------- masks, patches, dataset

@pytest.mark.parametrize("seed", [0, 1])
def test_dilate_valid_centers_equal_bitwise(seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((37, 53)) > 0.97).astype(np.float32)
    mask[0, 0] = mask[-1, -1] = 1  # reaching the borders
    frac = mask * rng.uniform(0.1, 1.0, mask.shape).astype(np.float32)
    for m in (mask, frac, np.zeros_like(mask)):
        np.testing.assert_array_equal(dilate_valid_centers(m),
                                      np.asarray(jax_dilate(jnp.asarray(m))))


def test_cut_patches_equal_bitwise():
    rng = np.random.default_rng(6)
    stack = rng.uniform(-1, 1, (3, 40, 50, 5)).astype(np.float32)
    sizes = np.array([[40, 50], [33, 50], [40, 21]], np.int32)
    for i, (h, w) in enumerate(sizes):
        stack[i, h:], stack[i, :, w:] = 0, 0
    img = np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int32)
    ctrs = np.array([[0, 0], [32, 49], [39, 20], [20, 25], [5, 48],
                     [17, 3], [39, 49], [16, 0]], np.int32)
    want = jax_cut(jax_pad(jnp.asarray(stack), 16), jnp.asarray(sizes),
                   jnp.asarray(img), jnp.asarray(ctrs), 16)
    got = cut_patches(pad_images_for_gather(torch.from_numpy(stack), 16),
                      torch.from_numpy(sizes), torch.from_numpy(img),
                      torch.from_numpy(ctrs), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    make_scene(str(root / "scene"), frames=3, height=48, width=72, seed=3)
    return root


def test_dataset_tables_and_batches_equal_jax(scene):
    from patch_toon_tpu.data import StyleTransferDataset as JaxDataset

    s = scene / "scene"
    args = (str(s / "input"), str(s / "output"), str(s / "mask"), PS, 2,
            {"point_vector": {"path": str(s / "tracking"), "depth": 3}})
    want = JaxDataset(*args)
    got = StyleTransferDataset.from_directories(*args, device="cpu")
    np.testing.assert_array_equal(got.stack.numpy(), np.asarray(want.stack))
    np.testing.assert_array_equal(got.centers_np, want.centers_np)
    np.testing.assert_array_equal(got.counts_np, want.counts_np)
    np.testing.assert_array_equal(got.sizes_np, want.sizes_np)
    assert len(got) == len(want) and got.image_names == want.image_names
    assert got.steps_per_epoch(80) == want.steps_per_epoch(80)
    assert got.total_input_channels == want.total_input_channels == 6
    img, ctrs = got.sample_centers(torch.Generator().manual_seed(0), 8)
    _, aug = got.sample_centers(torch.Generator().manual_seed(1), 8)
    assert (ctrs >= 0).all() and (img < got.num_images).all()
    mine = got.gather_batch(img, ctrs, aug)
    theirs = want.gather_batch(jnp.asarray(img.numpy()),
                               jnp.asarray(ctrs.numpy()),
                               jnp.asarray(aug.numpy()))
    assert sorted(mine) == sorted(theirs) == [
        "already", "channels", "channels_aug", "post", "pre"]
    for k in mine:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k]))
    batch = got.sample_batch(torch.Generator().manual_seed(2), 8)
    assert batch["pre"].shape == (8, PS, PS, 3) and "already" in batch
    with pytest.raises(NotImplementedError, match="permutation"):
        StyleTransferDataset.from_directories(*args[:5], sampling="permutation",
                                              device="cpu")


# ------------------------------------------------------------ the GAN step

@pytest.fixture(scope="module")
def jax_steps():
    """One JAX model, state and jitted step per mode, built once."""
    cache = {}

    def get(mode, precision="32"):
        if (mode, precision) not in cache:
            jm = JaxModel(**_configs(mode == "two_forward",
                                     0.5 if mode == "guide_dropout" else 0.0,
                                     precision))
            state = jm.init_state(jax.random.PRNGKey(0), patch_size=PS)
            cache[mode, precision] = (jm, state, jax_make_train_step(
                jm, donate=False, two_forward=mode == "two_forward"))
        return cache[mode, precision]

    return get


def _step_pairs(new_params, opt_state, port_tree, port_mu):
    """``first_step_agreement``'s pairs, JAX's step the reference (the
    first-step gradient is Adam's mu / (1 - 0.9) on both sides)."""
    jax_mu = [s for s in opt_state if hasattr(s, "mu")][0].mu
    theirs = dict(jax.tree_util.tree_leaves_with_path(jax_mu))
    ours = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    mine = dict(jax.tree_util.tree_leaves_with_path(port_mu))
    return [(jax.tree_util.keystr(path), "kernel" in jax.tree_util.keystr(
        path), np.asarray(want), np.asarray(ours[path]),
        np.asarray(theirs[path]) / 0.1, np.asarray(mine[path]) / 0.1)
        for path, want in jax.tree_util.tree_leaves_with_path(new_params)]


def _port_tree(module, opt, to_jax):
    """The port's parameters and its Adam first moments as JAX trees."""
    names = [n for n, _ in module.named_parameters()]
    extra = {k: v.numpy() for k, v in module.state_dict().items()
             if k not in names}
    params = to_jax({**{n: p.detach().numpy() for n, p in
                        module.named_parameters()}, **extra})
    mu = to_jax({**dict(zip(names, (m.numpy() for m in opt.mu))), **extra})
    return params, mu


def _steps_from_one_start(jax_steps, mode, precision="32"):
    """One JAX step and one port step from the same parameters and batch.
    -> (JAX's new state, JAX's metrics, the port's state, its metrics)."""
    jm, state, jstep = jax_steps(mode, precision)
    rng = np.random.default_rng(0)
    pre = rng.standard_normal((B, PS, PS, 3)).astype(np.float32)
    chans = rng.standard_normal((B, PS, PS, 3)).astype(np.float32)
    post = (rng.random((B, PS, PS, 3)) * 2 - 1).astype(np.float32)
    key = jax.random.PRNGKey(1)
    new, jmet = jstep(state, {"pre": jnp.asarray(pre),
                              "post": jnp.asarray(post),
                              "channels": jnp.asarray(chans)}, key)
    drop = None
    if mode == "guide_dropout":  # the JAX step's own draw, injected
        drop = torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(key, 0x6D), 0.5, (B, 1, 1, 1))).reshape(B))
        assert 0 < int(drop.sum()) < B

    pm = StyleTransferModel(**_configs(mode == "two_forward",
                                       0.5 if mode == "guide_dropout"
                                       else 0.0, precision))
    ps = pm.init_state(0, "cpu")
    params = jax.tree.map(np.asarray, (state.g_params, state.g_batch_stats,
                                       state.d_params))
    ps.generator.load_state_dict(generator_state_from_jax(
        params[0], params[1], resnet_blocks=2), strict=True)
    ps.discriminator.load_state_dict(discriminator_state_from_jax(
        params[2], n_layers=2), strict=True)
    met = make_train_step(pm, mode == "two_forward")(
        ps, {"pre": torch.from_numpy(pre), "post": torch.from_numpy(post),
             "channels": torch.from_numpy(chans)},
        torch.Generator().manual_seed(0), guide_drop=drop)
    assert sorted(met) == sorted(jmet) and ps.step == 1
    return new, jmet, ps, met


def _port_pairs(new, ps):
    """-> ({"G": pairs, "D": pairs}, the port's BatchNorm statistics)."""
    (g_after, stats_after), (g_mu, _) = _port_tree(
        ps.generator, ps.g_opt,
        lambda sd: generator_params_from_torch(sd, resnet_blocks=2))
    d_after, d_mu = _port_tree(
        ps.discriminator, ps.d_opt,
        lambda sd: discriminator_params_from_torch(sd, n_layers=2))
    return {"G": _step_pairs(new.g_params, new.g_opt, g_after, g_mu),
            "D": _step_pairs(new.d_params, new.d_opt, d_after, d_mu)}, \
        stats_after


def _assert_bn_close(stats_after, new):
    """BatchNorm statistics advanced twice, as the reference's two
    forwards."""
    for stat, tol in (("mean", 1e-5), ("var", 1e-3)):
        np.testing.assert_allclose(
            stats_after["smoother_bn"][stat],
            np.asarray(new.g_batch_stats["smoother_bn"][stat]), rtol=0,
            atol=tol)


@pytest.mark.parametrize("mode", ["one_forward", "two_forward",
                                  "guide_dropout"])
def test_gan_step_matches_jax(jax_steps, mode):
    new, jmet, ps, met = _steps_from_one_start(jax_steps, mode)
    for k in jmet:
        tol = 1e-5 if k.startswith("d_") else 1e-4
        assert abs(float(met[k]) - float(jmet[k])) <= tol, k
    pairs, stats_after = _port_pairs(new, ps)
    for tag, p in pairs.items():
        assert_first_step_close(first_step_agreement(p), 5e-5, tag)
    _assert_bn_close(stats_after, new)


def test_gan_step_matches_jax_bf16(jax_steps):
    """Precision bf16 (the networks in bf16; statistics, losses and Adam in
    fp32) against JAX's bf16 policy, with JAX's fp32 step as the
    yardstick for the gradients; see the module note."""
    new, jmet, ps, met = _steps_from_one_start(jax_steps, "one_forward",
                                               "bf16")
    for k in jmet:
        assert abs(float(met[k]) - float(jmet[k])) <= 2e-3, k
    ref, _, _, _ = _steps_from_one_start(jax_steps, "one_forward")
    pairs, stats_after = _port_pairs(new, ps)
    ref_pairs, _ = _port_pairs(ref, ps)
    for tag in ("G", "D"):  # the port's and JAX's bf16, against JAX fp32
        port = first_step_agreement(ref_pairs[tag])["grad_rel_l2"]
        own = first_step_agreement(
            (n, k, r[2], b[2], r[4], b[4])
            for r, b in zip(ref_pairs[tag], pairs[tag])
            for n, k in [r[:2]])["grad_rel_l2"]
        assert 0 < port <= 1.25 * own, (tag, port, own)
    _assert_bn_close(stats_after, new)


@pytest.mark.parametrize("case", ["equal", "dropped_gradient",
                                  "held_parameter_off", "tiny_gradient"])
def test_first_step_agreement_rule(case):
    """The step rule of train/parity.py: a dropped gradient or a parameter
    off by a sign flip's 2 * lr where both gradients reach 1e-7 fails;
    the same offset where a gradient is below 1e-7 passes."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 4, 3, 3)) * 1e-3
    p0 = rng.standard_normal(g.shape)
    p, g2 = p0.copy(), g.copy()
    if case == "dropped_gradient":
        g2[:] = 0.0
    elif case in ("held_parameter_off", "tiny_gradient"):
        p[0, 0, 0, 0] += 8e-4
        if case == "tiny_gradient":
            g[0, 0, 0, 0] = g2[0, 0, 0, 0] = 1e-9
    summary = first_step_agreement([("w", True, p0, p, g, g2)])
    if case in ("equal", "tiny_gradient"):
        assert_first_step_close(summary, 5e-5)
    else:
        with pytest.raises(AssertionError):
            assert_first_step_close(summary, 5e-5)


def test_step_witness_on_the_cpu():
    """train/parity.py's witness with the CPU in the card's place: no
    branch flips, the two runs equal, each within roundoff of the fp64
    step that takes its branches, and the bf16 steps equal."""
    rng = np.random.default_rng(1)
    batch = {"pre": rng.standard_normal((B, PS, PS, 3)),
             "channels": rng.standard_normal((B, PS, PS, 3)),
             "post": rng.random((B, PS, PS, 3)) * 2 - 1}
    r = device_step_parity(StyleTransferModel(**_configs()),
                           StyleTransferModel(**_configs(precision="bf16")),
                           batch, "cpu")
    assert r["kinks"] == 25 and r["flips"] == {}
    assert r["card_vs_cpu"]["grad_rel_l2"] == 0.0
    assert all(v["card"] == v["cpu"] > 0 for v in r["bf16"].values())
    assert_device_step_parity(r)


# ---------------------------------- the CLI, checkpoints, train then serve

def _scene_overrides(scene):
    s = scene / "scene"
    return [f"data.dir_pre={s / 'input'}", f"data.dir_post={s / 'output'}",
            f"data.dir_mask={s / 'mask'}",
            f"data.additional_channels.point_vector.path={s / 'tracking'}"]


@pytest.fixture(scope="module")
def trained(scene):
    """``train_torch.py`` for 2 steps on the CPU, small widths."""
    from patch_toon_tpu_torch import train_cli

    run = scene / "run"
    assert train_cli.main(_scene_overrides(scene) + SMALL_ARCH + [
        "training.accelerator=cpu", "training.max_steps=2",
        "training.batch_size=4", "training.log_every_n_steps=1",
        f"run.dir={run}"]) == 0
    return run


def test_train_cli_writes_the_run_directory(trained):
    assert (trained / "config.yaml").is_file()
    ckpts = trained / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == [
        "epoch_0000.ckpt", "last.ckpt"]
    meta = CheckpointManager.read_meta(ckpts / "last.ckpt")
    assert meta["epoch"] == 0 and meta["global_step"] == 2
    assert meta["hyper_parameters"]["input_channels"] == 6
    assert np.isfinite(meta["g_total_loss"])
    sd = load_generator_state(ckpts / "last.ckpt")  # the engine's reader
    assert sd["initial_conv.0.weight"].shape == (8, 6, 7, 7)


def test_checkpoint_loads_in_jax_and_serves_within_one_count(trained, scene,
                                                             tmp_path):
    """JAX ``load_torch_checkpoint`` reads the port's file unchanged, and
    the JAX engine (which loads it that way) serves it within 1 uint8
    count of the port's CLI, both at precision 32 on the CPU."""
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    from patch_toon_tpu_torch import cli

    ckpt = trained / "checkpoints" / "last.ckpt"
    raw = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]
    jm = JaxModel(**{**_configs(), "data_config": dict(
        patch_size=PS, additional_channels={
            "point_vector": {"path": "unused", "depth": 3}})})
    jstate = jm.load_torch_checkpoint(
        jm.init_state(jax.random.PRNGKey(0), patch_size=PS), str(ckpt))
    g_want, _ = generator_params_from_torch(
        {k: v.numpy() for k, v in raw.items()}, resnet_blocks=2,
        prefix="generator.")
    jax.tree.map(np.testing.assert_array_equal, g_want,
                 jax.tree.map(np.asarray, jstate.g_params))
    d_want = discriminator_params_from_torch(
        {k: v.numpy() for k, v in raw.items()}, n_layers=2,
        prefix="discriminator.")
    jax.tree.map(np.testing.assert_array_equal, d_want,
                 jax.tree.map(np.asarray, jstate.d_params))

    s = scene / "scene"
    overrides = [f"paths.checkpoint={ckpt}", f"paths.input_dir={s / 'input'}",
                 f"paths.mask_dir={s / 'mask'}",
                 f"paths.additional_channels.point_vector.path="
                 f"{s / 'tracking'}", "inference.use_gpu=false",
                 "inference.precision=32", *SMALL_ARCH]
    JaxEngine(jax_compose(REPO / "config", "inference", overrides=overrides + [
        f"paths.output_dir={tmp_path / 'jax'}"])).process_directory(
        progress=False)
    assert cli.main(overrides + [f"paths.output_dir={tmp_path / 'port'}"]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert len(names) == 3
    for name in names:
        a = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        b = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
        assert a.shape == b.shape == (48, 72, 3)
        assert np.abs(a - b).max() <= 1, name


def test_resume_continues_epochs_and_keeps_the_top_three(tmp_path):
    """Four one-step epochs with ``epoch_mean`` scores, then a resumed
    epoch: numbering continues from the checkpoint's epoch, the optimizer
    state comes back, and retention keeps the best three epochs plus
    ``last`` across the resume."""
    from patch_toon_tpu_torch.train.loop import fit

    rng = np.random.default_rng(8)
    frames = [rng.uniform(-1, 1, (24, 24, 3)).astype(np.float32)
              for _ in range(4)]
    mask = np.zeros((24, 24), np.float32)
    mask[12, 12] = 1  # 49 valid centres an image
    data = StyleTransferDataset(frames[:2], frames[2:], [mask, mask],
                                [f[..., :3] for f in frames[:2]], [3],
                                patch_size=PS, device="cpu")
    assert len(data) == 98
    cfg = _configs()
    cfg["training_config"].update(max_steps=4, checkpoint_score="epoch_mean",
                                  batch_size=50)  # 1 step an epoch
    cfg["data_config"]["additional_channels"] = {
        "point_vector": {"path": "unused", "depth": 3}}
    state = fit(StyleTransferModel(**cfg), data, str(tmp_path), seed=0,
                max_epochs=10, progress=False)
    assert state.step == 4
    ckdir = tmp_path / "checkpoints"
    kept = sorted(p.name for p in ckdir.glob("epoch_*.ckpt"))
    assert len(kept) == 3 and (ckdir / "last.ckpt").is_file()
    scores = {n: CheckpointManager.read_meta(ckdir / n)["g_total_loss"]
              for n in kept}
    assert CheckpointManager.read_meta(ckdir / "last.ckpt")["epoch"] == 3

    cfg["training_config"]["max_steps"] = 5
    resumed = fit(StyleTransferModel(**cfg), data, str(tmp_path), seed=0,
                  max_epochs=10, resume_from=str(ckdir / "last.ckpt"),
                  progress=False)
    assert resumed.step == 5 and resumed.g_opt.count == 5
    meta = CheckpointManager.read_meta(ckdir / "last.ckpt")
    assert meta["epoch"] == 4 and meta["global_step"] == 5
    scores[f"epoch_{4:04d}.ckpt"] = meta["g_total_loss"]
    best3 = sorted(scores, key=scores.get)[:3]
    assert sorted(p.name for p in ckdir.glob("epoch_*.ckpt")) == sorted(best3)


def test_serving_the_trained_checkpoint_with_generator_torch(trained, scene,
                                                            tmp_path):
    """``generator_torch.py`` on the run's ``last`` checkpoint."""
    import subprocess

    s = scene / "scene"
    res = subprocess.run(
        [sys.executable, str(REPO / "generator_torch.py"),
         f"paths.checkpoint={trained / 'checkpoints' / 'last.ckpt'}",
         f"paths.input_dir={s / 'input'}", f"paths.mask_dir={s / 'mask'}",
         f"paths.output_dir={tmp_path}",
         f"paths.additional_channels.point_vector.path={s / 'tracking'}",
         "inference.use_gpu=false", *SMALL_ARCH],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert len(list(tmp_path.glob("*.png"))) == 3


def test_training_defaults_equal_composed_yaml():
    want = compose(REPO / "config", "config")
    want.pop("run")
    assert training_config() == want


@pytest.mark.parametrize("override,knob", [
    ("training.precision=32_fast", "precision"),
    ("training.accumulate_grad_batches=2", "accumulate_grad_batches"),
    ("training.devices=2", "devices"),
    ("parallel.dcn.enabled=true", "parallel.dcn"),
    ("+training.profile_dir=trace", "profile_dir"),
    ("+data.sampling=permutation", "permutation"),
])
def test_unported_training_knobs_are_refused(scene, tmp_path, override, knob):
    from patch_toon_tpu_torch import train_cli

    cfg = compose(REPO / "config", "config", overrides=_scene_overrides(
        scene) + ["training.accelerator=cpu", f"run.dir={tmp_path}",
                  override])
    with pytest.raises(NotImplementedError, match=knob):
        train_cli.train(cfg)
