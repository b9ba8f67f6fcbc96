"""The rest of the port's training against the JAX package, on the CPU:
permutation sampling, gradient accumulation, the comparison grid, the
profiler trace and the refusal of a directory that is no Orbax checkpoint.

Small widths, as tests/test_torch_train.py (2 residual blocks, filters
8/16/32/32/32/16, a discriminator of 8 filters, 32x32 patches, batch 4),
inputs from numpy seeds, weights carried across from the JAX side.
Tolerances:

- permutation draws (the state and the batch) against JAX's
  ``sample_batch_permutation`` fed JAX's own image indices, fresh
  permutations and augmentation uniforms: bit for bit;
- accumulated micro-steps against JAX's ``make_train_step`` over
  ``optax.MultiSteps``: the losses of each micro-step within 1e-5 (D) and
  1e-4 (G), the update at the k-th through ``first_step_agreement`` as
  tests/test_torch_train.py holds one step, BatchNorm within 1e-5 / 1e-3;
  the parameters bit for bit unchanged between updates;
- a resume in the middle of an accumulation against the unbroken run, and
  the comparison grid against JAX's ``build_comparison_grid``: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.data import StyleTransferDataset as JaxDataset
from patch_toon_tpu.train import StyleTransferModel as JaxModel
from patch_toon_tpu.train import make_train_step as jax_make_train_step
from patch_toon_tpu.train.logging import (
    build_comparison_grid as jax_build_grid,
)
from patch_toon_tpu.utils.torch_compat import (
    discriminator_params_from_torch,
    generator_params_from_torch,
)

from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
from patch_toon_tpu_torch.train import loop
from patch_toon_tpu_torch.train.checkpoints import (
    CheckpointManager,
    whole_state,
)
from patch_toon_tpu_torch.train.logging import build_comparison_grid
from patch_toon_tpu_torch.train.model import StyleTransferModel
from patch_toon_tpu_torch.train.optim import Adam, MultiSteps
from patch_toon_tpu_torch.train.parity import (
    assert_first_step_close,
    first_step_agreement,
)
from patch_toon_tpu_torch.train.step import make_train_step
from patch_toon_tpu_torch.utils.weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
)

PS, B = 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: a test run shares the
    cores among its worker processes, and torch's thread pool then spends
    most of its time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
GEN_ARGS = dict(use_bias=True, tanh=True, append_smoothers=True,
                resnet_blocks=2, filters=[8, 16, 32, 32, 32, 16],
                norm_layer="instance_norm", input_size=256,
                input_channels="auto")
DISC_ARGS = dict(num_filters=8, n_layers=2, use_noise=False, noise_sigma=0.2,
                 norm_layer="instance_norm", use_bias=True, input_channels=3)


def _configs(accumulate=1, **training):
    """tests/test_torch_train.py's configs (one guide of depth 3)."""
    return dict(
        generator_config={"type": "GeneratorJ", "args": dict(GEN_ARGS)},
        discriminator_config={"type": "DiscriminatorN_IN",
                              "args": dict(DISC_ARGS)},
        training_config=dict(
            batch_size=B, reconstruction_weight=4.0, adversarial_weight=0.5,
            use_image_loss=True, reconstruction_criterion="MSELoss",
            adversarial_criterion="MSELoss", use_gradient_clipping=True,
            gradient_clip_val=0.5, precision="32",
            accumulate_grad_batches=accumulate, **training),
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


# ------------------------------------------------- permutation sampling

@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """Three 24x28 keyframes whose masks hold 1, 2 and 4 pixels, so an
    image has 49-80 valid centres and a batch of 16 wraps them often."""
    root = tmp_path_factory.mktemp("perm")
    rng = np.random.default_rng(2)
    for sub in ("input", "output", "mask", "tracking"):
        (root / sub).mkdir()
    for i, pix in enumerate([[(12, 14)], [(5, 5), (18, 20)],
                             [(3, 3), (3, 4), (20, 9), (11, 25)]]):
        mask = np.zeros((24, 28), np.uint8)
        for y, x in pix:
            mask[y, x] = 255
        Image.fromarray(mask).save(root / "mask" / f"{i:03d}.png")
        for sub in ("input", "output", "tracking"):
            Image.fromarray(rng.integers(0, 256, (24, 28, 3), dtype=np.uint8)
                            ).save(root / sub / f"{i:03d}.png")
    return root


def _dataset_args(root, aug=2):
    return (str(root / "input"), str(root / "output"), str(root / "mask"),
            PS, aug, {"point_vector": {"path": str(root / "tracking"),
                                       "depth": 3}})


def test_permutation_draws_equal_jax_bitwise(small_scene):
    """50 draws of 16 with wraps: the port's draw fed JAX's own random
    inputs gives JAX's state and batch, bit for bit."""
    want = JaxDataset(*_dataset_args(small_scene), sampling="permutation")
    got = StyleTransferDataset.from_directories(
        *_dataset_args(small_scene), sampling="permutation", device="cpu")
    np.testing.assert_array_equal(got.centers_np, want.centers_np)
    jstate = want.init_perm_state(jax.random.PRNGKey(11))
    state = {k: torch.from_numpy(np.array(v)).long()
             for k, v in jstate.items()}
    draw = jax.jit(lambda st, r: want.sample_batch_permutation(st, r, 16))
    resets = straddles = 0
    for i in range(50):
        rng = jax.random.PRNGKey(100 + i)
        k_img, k_perm, k_aug = jax.random.split(rng, 3)
        imgs = np.array(jax.random.randint(k_img, (16,), 0, 3))
        fresh = np.array(want._fresh_perms(k_perm))
        aug_u = np.array(jax.random.uniform(k_aug, (16,)))
        before = state["cursor"].numpy().copy()
        jstate, jbatch = draw(jstate, rng)
        state, batch = got.sample_batch_permutation(
            state, torch.from_numpy(imgs), torch.from_numpy(fresh).long(),
            torch.from_numpy(aug_u))
        for k in ("perm", "cursor"):
            np.testing.assert_array_equal(state[k].numpy(),
                                          np.asarray(jstate[k]))
        assert sorted(batch) == sorted(jbatch)
        for k in batch:
            np.testing.assert_array_equal(batch[k].numpy(),
                                          np.asarray(jbatch[k]))
        draws = np.bincount(imgs, minlength=3)
        wrapped = before + draws >= got.counts_np
        resets += int(wrapped.sum())
        straddles += int(np.maximum(before + draws - got.counts_np,
                                    0)[wrapped].sum())
    assert resets >= 5 and straddles > 0


def test_permutation_sampler_covers_every_centre_a_cycle(small_scene):
    """The stateful sampler: the slots an image's cursor passes over from
    one reset to the next are each of its centres once (the straddling
    draws at a reset re-read the old permutation and are not counted)."""
    ds = StyleTransferDataset.from_directories(
        *_dataset_args(small_scene, aug=1), sampling="permutation",
        device="cpu")
    sample = ds.make_sampler(16)
    gen = torch.Generator().manual_seed(0)
    seen = [[] for _ in range(ds.num_images)]
    full_cycles = 0
    for _ in range(40):
        cursor = sample.state["cursor"].tolist()
        perm = sample.state["perm"].clone()
        batch = sample(gen)
        assert batch["pre"].shape == (16, PS, PS, 3)
        for i, (c, new) in enumerate(zip(cursor,
                                         sample.state["cursor"].tolist())):
            n = int(ds.counts_np[i])
            wrapped = c > 0 and new == 0  # a batch of 16 < n never laps
            seen[i] += perm[i, c:n if wrapped else new].tolist()
            if wrapped:
                assert sorted(seen[i]) == list(range(n))
                assert not torch.equal(sample.state["perm"][i, :n],
                                       perm[i, :n])
                full_cycles += 1
                seen[i] = []
    assert full_cycles >= 6
    with pytest.raises(ValueError, match="sampling"):
        StyleTransferDataset.from_directories(
            *_dataset_args(small_scene), sampling="bogus", device="cpu")


# ------------------------------------------------ gradient accumulation

def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"pre": rng.standard_normal((B, PS, PS, 3)).astype(np.float32),
             "channels": rng.standard_normal((B, PS, PS, 3)).astype(
                 np.float32),
             "post": (rng.random((B, PS, PS, 3)) * 2 - 1).astype(np.float32)}
            for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _params(state):
    return [p.detach().clone() for p in
            list(state.generator.parameters())
            + list(state.discriminator.parameters())]


def _pairs(new_params, inner_opt, module, adam, to_jax):
    """first_step_agreement's pairs after one update: JAX's step the
    reference, each side's gradient Adam's mu / (1 - 0.9)."""
    names = [n for n, _ in module.named_parameters()]
    extra = {k: v.numpy() for k, v in module.state_dict().items()
             if k not in names}
    ours = to_jax({**{n: p.detach().numpy() for n, p in
                      module.named_parameters()}, **extra})
    mine = to_jax({**dict(zip(names, (m.numpy() for m in adam.mu))),
                   **extra})
    theirs = [s for s in inner_opt if hasattr(s, "mu")][0].mu
    leaves = jax.tree_util.tree_leaves_with_path
    o, m, t = dict(leaves(ours)), dict(leaves(mine)), dict(leaves(theirs))
    return [(jax.tree_util.keystr(p), "kernel" in jax.tree_util.keystr(p),
             np.asarray(w), np.asarray(o[p]), np.asarray(t[p]) / 0.1,
             np.asarray(m[p]) / 0.1) for p, w in leaves(new_params)]


@pytest.mark.parametrize("k", [2, 3])
def test_accumulated_micro_steps_match_jax_multisteps(k):
    jm = JaxModel(**_configs(k))
    jstate = jm.init_state(jax.random.PRNGKey(0), patch_size=PS)
    jstep = jax_make_train_step(jm, donate=False)
    pm = StyleTransferModel(**_configs(k))
    ps = pm.init_state(0, "cpu")
    assert isinstance(ps.g_opt, MultiSteps) and ps.g_opt.every_k == k
    start = jax.tree.map(np.asarray, (jstate.g_params, jstate.g_batch_stats,
                                      jstate.d_params))
    ps.generator.load_state_dict(generator_state_from_jax(
        start[0], start[1], resnet_blocks=2), strict=True)
    ps.discriminator.load_state_dict(discriminator_state_from_jax(
        start[2], n_layers=2), strict=True)
    step = make_train_step(pm)
    gen = torch.Generator().manual_seed(0)
    for i, b in enumerate(_batches(k)):
        before = _params(ps)
        jstate, jmet = jstep(jstate, {n: jnp.asarray(v) for n, v in b.items()},
                             jax.random.PRNGKey(i))
        met = step(ps, _torch_batch(b), gen)
        for name in jmet:
            tol = 1e-5 if name.startswith("d_") else 1e-4
            assert abs(float(met[name]) - float(jmet[name])) <= tol, name
        assert ps.step == int(jstate.step) == i + 1
        assert ps.g_opt.mini_step == int(jstate.g_opt.mini_step)
        if i < k - 1:  # no update: bit for bit as before
            assert all(torch.equal(a, b) for a, b in zip(before,
                                                         _params(ps)))
            assert ps.g_opt.inner.count == ps.d_opt.inner.count == 0
    assert ps.g_opt.inner.count == ps.d_opt.inner.count == 1
    assert ps.g_opt.gradient_step == int(jstate.g_opt.gradient_step) == 1
    assert all(float(a.abs().max()) == 0 for a in ps.g_opt.acc)
    for tag, module, opt, new, jopt, to_jax in (
            ("G", ps.generator, ps.g_opt, jstate.g_params, jstate.g_opt,
             lambda sd: generator_params_from_torch(sd, resnet_blocks=2)[0]),
            ("D", ps.discriminator, ps.d_opt, jstate.d_params, jstate.d_opt,
             lambda sd: discriminator_params_from_torch(sd, n_layers=2))):
        pairs = _pairs(new, jopt.inner_opt_state, module, opt.inner, to_jax)
        assert_first_step_close(first_step_agreement(pairs), 5e-5, tag)
    stats = {k: v.numpy() for k, v in ps.generator.state_dict().items()}
    for stat, tol in (("mean", 1e-5), ("var", 1e-3)):
        key = [n for n in stats if n.endswith(f"running_{stat}")][0]
        np.testing.assert_allclose(
            stats[key], np.asarray(jstate.g_batch_stats["smoother_bn"][stat]),
            rtol=0, atol=tol)


def test_multisteps_is_optax_arithmetic():
    """The running mean and the update at the k-th micro-step against
    optax.MultiSteps over the same chain (k = 3, two updates)."""
    from patch_toon_tpu.train.optim import torch_adam

    rng = np.random.default_rng(5)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in
          ((4, 3, 3, 3), (4,))]
    tx = torch_adam(4e-4, weight_decay=1e-5, clip_norm=0.5,
                    accumulate_steps=3)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = MultiSteps(Adam(tp, 4e-4, weight_decay=1e-5, clip_norm=0.5), 3)
    for _ in range(6):
        g = [rng.standard_normal(a.shape).astype(np.float32) for a in p0]
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = [a + u for a, u in zip(jp, upd)]
        opt.step([torch.from_numpy(a) for a in g])
        for a, b in zip(state.acc_grads, opt.acc):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=0, atol=1e-7)
    assert opt.inner.count == 2 and opt.gradient_step == 2


def test_resume_in_the_middle_of_an_accumulation(tmp_path):
    """Three micro-steps of k = 2, a checkpoint, a fresh state restored
    from it and a fourth micro-step: bit for bit the unbroken four (the
    first run goes on after its checkpoint)."""
    model = StyleTransferModel(**_configs(2))
    batches = [_torch_batch(b) for b in _batches(4, seed=3)]
    step = make_train_step(model)

    def run(state, bs):
        for b in bs:
            step(state, b, torch.Generator().manual_seed(0))
        return state

    part = run(model.init_state(0, "cpu"), batches[:3])
    assert part.g_opt.mini_step == 1 and part.g_opt.gradient_step == 1
    ckpt = CheckpointManager(tmp_path, keep_top_k=3)
    ckpt.save(part, 0, 1.0, whole_state(part))
    whole = run(part, batches[3:])
    raw = torch.load(tmp_path / "last.ckpt", weights_only=True)
    assert raw["optimizer_states"][0]["mini_step"] == 1
    resumed = CheckpointManager.restore(tmp_path / "last.ckpt",
                                        model.init_state(7, "cpu"))
    assert resumed.step == 3 and resumed.g_opt.mini_step == 1
    run(resumed, batches[3:])
    for a, b in zip(_params(whole) + [t for o in (whole.g_opt, whole.d_opt)
                                      for t in o.acc + o.inner.mu],
                    _params(resumed) + [t for o in (resumed.g_opt,
                                                    resumed.d_opt)
                                        for t in o.acc + o.inner.mu]):
        assert torch.equal(a, b)
    # a run with another accumulation refuses the optimizer state
    for k in (1, 3):
        with pytest.raises(ValueError, match="accumulate_grad_batches"):
            CheckpointManager.restore(tmp_path / "last.ckpt",
                                      StyleTransferModel(**_configs(
                                          k)).init_state(0, "cpu"))


# -------------------------------------------- grid, profiler, refusals

@pytest.mark.parametrize("depths", [[1], [3], [2], [1, 3, 2]])
def test_comparison_grid_equals_jax_bitwise(depths):
    rng = np.random.default_rng(sum(depths))
    n = 10 if depths == [3] else 5  # more than 8 rows are cut to 8
    pre, gen, post = (rng.uniform(-1.3, 1.3, (n, 12, 12, 3)).astype(
        np.float32) for _ in range(3))
    chans = rng.uniform(-1.2, 1.2, (n, 12, 12, sum(depths))).astype(
        np.float32)
    got = build_comparison_grid(pre, gen, post, chans, depths)
    want = jax_build_grid(pre, gen, post, chans, depths)
    assert got.dtype == want.dtype and got.shape == (
        min(n, 8) * 16, (3 + len(depths)) * 16, 3)
    np.testing.assert_array_equal(got, want)


class _SpyLogger:
    images, texts = [], []

    def __init__(self, log_dir):
        type(self).images = []

    def log_scalars(self, metrics, step):
        pass

    def log_image(self, tag, image, step):
        type(self).images.append((tag, image, step))

    def close(self):
        pass


def _fit_data():
    rng = np.random.default_rng(8)
    frames = [rng.uniform(-1, 1, (24, 24, 3)).astype(np.float32)
              for _ in range(4)]
    mask = np.zeros((24, 24), np.float32)
    mask[12, 12] = 1  # 49 valid centres an image
    return StyleTransferDataset(frames[:2], frames[2:], [mask, mask],
                                [f[..., :3] for f in frames[:2]], [3],
                                patch_size=PS, device="cpu")


def test_fit_logs_the_grid_every_image_log_freq_steps(tmp_path,
                                                      monkeypatch):
    """The grid of steps 2 and 4 is JAX's ``build_comparison_grid`` of the
    step's batch and an eval-mode forward; the generator is back in train
    mode and its BatchNorm statistics are the step's own."""
    data = _fit_data()
    cfg = _configs(1, max_steps=4, image_log_freq=2)
    cfg["data_config"]["additional_channels"] = {
        "point_vector": {"path": "unused", "depth": 3}}
    model = StyleTransferModel(**cfg)
    monkeypatch.setattr(loop, "MetricsLogger", _SpyLogger)
    seen = {}

    def on_step(step, metrics):
        seen[step] = {k: v.clone() for k, v in
                      state_box["state"].generator.state_dict().items()}

    state_box = {}
    real_step = loop.make_train_step

    def keep_state(model_, two_forward=False):
        inner = real_step(model_, two_forward)

        def step(state, batch, generator):
            state_box["state"], state_box["batch"] = state, batch
            return inner(state, batch, generator)
        return step

    monkeypatch.setattr(loop, "make_train_step", keep_state)
    state = loop.fit(model, data, str(tmp_path), seed=0, progress=False,
                     on_step=on_step)
    assert [s for _, _, s in _SpyLogger.images] == [2, 4]
    tag, grid, _ = _SpyLogger.images[-1]
    assert tag == "training/comparison_grid"
    assert state.generator.training
    assert grid.shape == (B * (PS + 4), 4 * (PS + 4), 3)
    batch = state_box["batch"]
    with torch.no_grad():
        gen = state.generator.eval()(data.model_input(batch))
    state.generator.train()
    want = jax_build_grid(batch["pre"].numpy(), gen.numpy(),
                          batch["post"].numpy(), batch["channels"].numpy(),
                          [3])
    np.testing.assert_array_equal(grid, want)
    # the eval forward left the statistics as the step left them
    after = state.generator.state_dict()
    assert all(torch.equal(after[k], v) for k, v in seen[4].items())


def test_fit_writes_a_profiler_trace(tmp_path, capsys):
    """Two one-step epochs: the trace of epoch 0 only, and JAX's message."""
    rng = np.random.default_rng(9)
    frame = rng.uniform(-1, 1, (24, 24, 3)).astype(np.float32)
    mask = np.zeros((24, 24), np.float32)
    mask[12, 12] = 1  # 49 valid centres
    data = StyleTransferDataset([frame], [frame], [mask], [frame], [3],
                                patch_size=PS, device="cpu")
    cfg = _configs(1, max_steps=2, profile_dir=str(tmp_path / "trace"))
    cfg["data_config"]["additional_channels"] = {
        "point_vector": {"path": "unused", "depth": 3}}
    cfg["training_config"]["batch_size"] = 25  # one step an epoch
    loop.fit(StyleTransferModel(**cfg), data, str(tmp_path / "run"),
             seed=0, progress=False)
    traces = list((tmp_path / "trace").glob("*.json"))
    assert [p.name for p in traces] == ["epoch_0.pt.trace.json"]
    assert traces[0].stat().st_size > 1000
    assert "aten::convolution" in traces[0].read_text()
    out = capsys.readouterr().out
    assert out.count(f"Profiler trace of epoch 0 written to "
                     f"{tmp_path / 'trace'}") == 1
    assert "Reached training.max_steps=2" in out


def test_resume_from_an_orbax_directory_is_refused(tmp_path):
    """A directory that is not an Orbax checkpoint (no ``_METADATA``) is
    refused by name; Orbax checkpoints resume (tests/test_torch_orbax.py)."""
    (tmp_path / "orbax_ckpt").mkdir()
    with pytest.raises(ValueError, match="not an Orbax checkpoint"):
        loop.fit(StyleTransferModel(**_configs(1, max_steps=1)), _fit_data(),
                 str(tmp_path / "run"), resume_from=str(tmp_path
                                                        / "orbax_ckpt"))
