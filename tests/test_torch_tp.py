"""Tensor parallelism in the port (``patch_toon_tpu_torch/parallel/tp.py``)
against the JAX package's (``patch_toon_tpu/parallel/tp.py``), on the CPU.

The port's ranks are gloo processes that import no jax
(``tests/torch_tp_worker.py``); the JAX side runs on the 8 virtual CPU
devices of ``tests/conftest.py``. Widths, configs and batch are those of
``tests/test_torch_train.py`` (batch 4, 32x32 patches, a 6-channel
generator with the smoothers' BatchNorm, gradient clipping at 0.5).
Tolerances:

- the sharding rule: the same parameters sharded as JAX shards, on the
  full-width trees (``jax.eval_shape``: nothing full-width is computed);
- the sharded eval-mode forward of G and D on 2 and 4 ranks against
  ``apply`` with JAX's ``shard_params_tp`` parameters on
  ``make_mesh(data=2, model=4)``, and on 3 ranks (where the rule shards
  G's 3-channel head) against ``make_mesh(data=2, model=3)``: 1e-5, the
  bar of ``tests/test_multichip.py::test_tensor_parallel_generator_forward``;
- one GAN step on data 2 x model 2 ranks against JAX's step on
  ``make_mesh(data=2, model=2)``: the tolerances of
  ``tests/test_torch_parallel_train.py`` (losses 1e-5 for D and 1e-4 for
  G, ``first_step_agreement`` within 5e-5, BatchNorm 1e-5 and 1e-3), the 4
  ranks' whole parameters and moments bitwise equal, and the clip active
  (every first-step update's norm the clip value, to 1e-3);
- ``unshard`` of ``shard_params_tp`` bitwise the state dict; the turn-taking
  group (one process, every rank in turn) bitwise the gloo ranks;
- a data 1 x model 2 ``fit`` through ``train_cli``: its ``.ckpt`` whole (it
  loads ``strict=True`` into the whole networks) and a resume from it.
"""

import copy
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patch_toon_tpu.parallel import make_mesh, replicate, shard_batch
from patch_toon_tpu.parallel.tp import shard_params_tp as jax_shard_params_tp
from patch_toon_tpu.parallel.tp import (
    tp_param_sharding as jax_tp_param_sharding,
)
from patch_toon_tpu.train import StyleTransferModel as JaxModel
from patch_toon_tpu.train import make_train_step as jax_make_train_step
from patch_toon_tpu_torch.config.defaults import training_config
from patch_toon_tpu_torch.models.discriminator import DiscriminatorN_IN
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.parallel.tp import (
    ModelShard,
    TurnGroup,
    shard_module_,
    shard_params_tp,
    tp_param_sharding,
    unshard,
)
from patch_toon_tpu_torch.train.model import StyleTransferModel
from patch_toon_tpu_torch.train.parity import (
    assert_first_step_close,
    first_step_agreement,
)
from patch_toon_tpu_torch.utils.weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
)

from test_torch_parallel_train import (  # noqa: E402  (tests/ is on the path)
    _as_state,
    _batches,
)
from test_torch_train import (  # noqa: E402
    B,
    PS,
    _assert_bn_close,
    _configs,
    _port_pairs,
    _scene_overrides,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

WORKER = REPO / "tests" / "torch_tp_worker.py"
ENV = {**os.environ, "PYTHONPATH": str(REPO)}


def _full_width():
    """The shipped configuration's model (config/model/default.yaml) on
    both sides: JAX's parameter trees by ``jax.eval_shape``, the port's
    networks built on the CPU."""
    cfg = training_config()
    configs = dict(generator_config=cfg.model.generator,
                   discriminator_config=cfg.model.discriminator,
                   training_config=cfg.training,
                   optimizer_config=cfg.optimizer, data_config=cfg.data)
    jm, pm = JaxModel(**configs), StyleTransferModel(**configs)
    x = jnp.zeros((1, 80, 80, jm.input_channels))
    trees = {
        "G": jax.eval_shape(lambda: jm.generator.init(
            jax.random.PRNGKey(0), x, train=True)),
        "D": jax.eval_shape(lambda: jm.discriminator.init(
            jax.random.PRNGKey(0), x[..., :3], train=True))}
    nets = {"G": GeneratorJ(**pm.generator_args),
            "D": DiscriminatorN_IN(**pm.discriminator_args)}
    return trees, nets, pm


@pytest.mark.parametrize("size", [2, 3, 4])
def test_sharding_rule_is_jaxs_on_the_full_width_trees(size):
    """(a) The port's rule shards exactly the parameters JAX's rule shards
    (each JAX leaf's flag carried to the port's name by the weight
    converters), and on the output-channel dim. At size 3 both shard the
    3-channel head and none of G's other convs."""
    trees, nets, pm = _full_width()
    mesh = make_mesh(data=8 // size, model=size)
    got_sharded = {}
    for tag, tree in trees.items():
        specs = jax_tp_param_sharding(tree["params"], mesh)
        flags = jax.tree.map(
            lambda leaf, spec: np.full(leaf.shape, float(
                not spec.is_fully_replicated), np.float32),
            tree["params"], specs)
        if tag == "G":
            stats = jax.tree.map(lambda leaf: np.zeros(leaf.shape,
                                                       np.float32),
                                 tree["batch_stats"])
            sd = generator_state_from_jax(flags, stats, resnet_blocks=7)
        else:
            sd = discriminator_state_from_jax(flags, n_layers=2)
        want = {k for k, v in sd.items() if v.dtype == torch.float32
                and v.numel() and bool(v.flatten()[0] == 1)}
        rule = tp_param_sharding(nets[tag], size)
        got = {k for k, d in rule.items() if d == 0}
        assert got == want, (tag, sorted(got ^ want))
        assert set(rule) == {k for k, _ in nets[tag].named_parameters()}
        got_sharded[tag] = got
    # the replicated ones are JAX's: the 3-channel head (but at size 3),
    # D's 1-channel out
    assert ("output.0.weight" in got_sharded["G"]) == (size == 3)
    assert "output.0.weight" not in got_sharded["D"]
    assert ("smoothers.2.weight" in got_sharded["G"]) == (size != 3)
    assert pm.generator_args["resnet_blocks"] == 7


@pytest.mark.parametrize("size", [1, 2, 4])
def test_unshard_of_the_shards_is_the_state_dict(size):
    """(e) ``unshard`` of every rank's ``shard_params_tp`` is the whole
    state dict, bitwise; the shards are copies, the buffers whole."""
    _, nets, _ = _full_width()
    for net in nets.values():
        sd = net.state_dict()
        rule = tp_param_sharding(net, size)
        shards = [shard_params_tp(net, r, size) for r in range(size)]
        whole = unshard(shards, rule)
        assert list(whole) == list(sd)
        assert all(torch.equal(whole[k], sd[k]) for k in sd)
        for k, d in rule.items():
            if d == 0:
                assert shards[0][k].shape[0] * size == sd[k].shape[0]
                assert shards[0][k].data_ptr() != sd[k].data_ptr()
        for k in ("smoothers.2.running_mean", "smoothers.2.running_var"):
            if k in sd:
                assert shards[-1][k].shape == sd[k].shape


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """JAX's step on ``make_mesh(data=2, model=2)`` and its forward on
    ``make_mesh(data=2, model=4)`` and ``make_mesh(data=2, model=3)`` with
    ``shard_params_tp`` parameters (the weights after the step); the port's
    ranks in one worker: 2 ranks at model 2 (the forward), 4 ranks at data
    2 x model 2 (the step) and model 4 (the forward), 3 ranks at model 3
    (the forward)."""
    tmp = tmp_path_factory.mktemp("tp_runs")
    configs = _configs()
    jm = JaxModel(**configs)
    state = jm.init_state(jax.random.PRNGKey(0), patch_size=PS)
    batch = _batches(1)
    with make_mesh(data=2, model=2) as mesh:
        new, jmet = jax_make_train_step(jm, donate=False)(
            replicate(state, mesh), shard_batch(
                {k: jnp.asarray(v) for k, v in batch[0].items()}, mesh),
            jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    xg = (rng.random((B, PS, PS, jm.input_channels)) * 2 - 1).astype(
        np.float32)
    xd = (rng.random((B, PS, PS, 3)) * 2 - 1).astype(np.float32)
    params = jax.tree.map(np.asarray, (new.g_params, new.g_batch_stats,
                                       new.d_params))
    ref = {}
    for size, layer in ((4, "downsample1"), (3, "output")):
        with make_mesh(data=2, model=size) as mesh:
            gp = jax_shard_params_tp(new.g_params, mesh)
            dp = jax_shard_params_tp(new.d_params, mesh)
            kernel = gp[layer]["kernel"] if layer == "output" \
                else gp[layer]["conv"]["kernel"]
            assert not kernel.sharding.is_fully_replicated
            ref[size] = {
                "xg": np.asarray(jax.jit(lambda p, x: jm.generator.apply(
                    {"params": p, "batch_stats": new.g_batch_stats}, x))(
                    gp, xg)),
                "xd": np.asarray(jax.jit(lambda p, x: jm.discriminator.apply(
                    {"params": p}, x))(dp, xd))}
    start = jax.tree.map(np.asarray, (state.g_params, state.g_batch_stats,
                                      state.d_params))
    torch.save({
        "configs": configs,
        "g": generator_state_from_jax(start[0], start[1], resnet_blocks=2),
        "d": discriminator_state_from_jax(start[2], n_layers=2),
        "fwd_g": {m: [generator_state_from_jax(
            params[0], params[1], resnet_blocks=2, shard=(r, m))
            for r in range(m)] for m in (2, 3, 4)},
        "fwd_d": {m: [discriminator_state_from_jax(
            params[2], n_layers=2, shard=(r, m)) for r in range(m)]
            for m in (2, 3, 4)},
        "xg": torch.from_numpy(xg), "xd": torch.from_numpy(xd),
        "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                    for b in batch]}, tmp / "case.pt")
    proc = subprocess.run(
        [sys.executable, str(WORKER), str(tmp / "case.pt"), str(tmp),
         "2:fwd2", "3:fwd3", "4:step2,fwd4"], env=ENV, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    res = {p.stem: torch.load(p, weights_only=False)
           for p in tmp.glob("*.pt") if p.stem != "case"}
    return {"configs": configs, "new": new, "jmet": jmet, "ref": ref,
            "xg": xg, "res": res}


@pytest.mark.parametrize("net", ["xg", "xd"])
@pytest.mark.parametrize("m", [2, 3, 4])
def test_sharded_forward_matches_jax_shard_params_tp(tp_runs, net, m):
    """(b) G's and D's sharded forward on m gloo ranks, fed the weights
    that ``utils/weights.py`` converts from JAX and shards, against JAX's
    forward with ``shard_params_tp`` parameters (on a model axis of 4, or
    of 3 at m 3, where both shard G's 3-channel head), within 1e-5; every
    rank holds the whole output."""
    ref = tp_runs["ref"][3 if m == 3 else 4][net]
    for r in range(m):
        got = tp_runs["res"][f"fwd{m}_rank{r}"][net].numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        assert tp_runs["res"][f"fwd{m}_rank{r}"]["dy_copies"] == 0


def test_tp_step_matches_the_jax_data2_model2_step(tp_runs):
    """(c) One GAN step on data 2 x model 2 gloo ranks against JAX's step
    on ``make_mesh(data=2, model=2)`` (which replicates the state and
    shards the batch over ``data``: the 2-way data-parallel step). The 4
    ranks' whole parameters and Adam moments are bitwise equal; the clip
    is active (the update's gradient has the clip's norm, 0.5), so the
    norm of the sharded gradients summed over the model group is the one
    JAX clips by; the gather's backward made B1 copy a strided dy."""
    res, configs = tp_runs["res"], tp_runs["configs"]
    ranks = [res[f"step2_rank{r}"] for r in range(4)]
    assert [(r["data_index"], r["model_index"]) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        for key in ("G", "D"):
            assert all(torch.equal(r[key][k], ranks[0][key][k])
                       for k in ranks[0][key]), key
        for key in ("g_mu", "d_mu"):
            assert all(torch.equal(a, b) for a, b in zip(r[key],
                                                         ranks[0][key]))
        assert r["metrics"] == ranks[0]["metrics"]
    got = ranks[0]
    for key in ("g_mu", "d_mu"):  # first step: mu = 0.1 (clipped g + wd p)
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t) for t in got[key]]))) / 0.1
        assert abs(norm - 0.5) < 1e-3, (key, norm)
    assert got["dy_copies"] > 0
    jmet = tp_runs["jmet"]
    for k in jmet:
        tol = 1e-5 if k.startswith("d_") else 1e-4
        assert abs(got["metrics"][0][k] - float(jmet[k])) <= tol, k
    pairs, stats_after = _port_pairs(tp_runs["new"], _as_state(configs, got))
    for tag, p in pairs.items():
        assert_first_step_close(first_step_agreement(p), 5e-5, tag)
    _assert_bn_close(stats_after, tp_runs["new"])


@pytest.mark.parametrize("m", [2, 3, 4])
def test_turn_group_forward_is_the_gloo_ranks_forward(tp_runs, m):
    """Every rank's share of the sharded forward in turn in one process
    (``TurnGroup``, what the card's one-device check runs) gives what the
    gloo ranks give, bitwise, and so JAX's forward within 1e-5."""
    pm = StyleTransferModel(**tp_runs["configs"])
    group = TurnGroup(m)
    nets = []
    for r in range(m):
        st = pm.init_state(0, "cpu")
        net = st.generator
        shard_module_(net, ModelShard(r, m, group.member(r)))
        net.load_state_dict(generator_state_from_jax(*jax.tree.map(
            np.asarray, (tp_runs["new"].g_params,
                         tp_runs["new"].g_batch_stats)),
            resnet_blocks=2, shard=(r, m)), strict=True)
        net.eval()
        nets.append(net)
    x = torch.from_numpy(tp_runs["xg"])

    def forward(net):
        def run():
            with torch.no_grad():
                return net(x)
        return run

    # one thread, as the workers: a CPU conv's bits can depend on the
    # thread count (a 1-channel conv does, the head's slice at m 3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        outs = group.run([forward(n) for n in nets])
    finally:
        torch.set_num_threads(threads)
    gloo = tp_runs["res"][f"fwd{m}_rank0"]["xg"]
    for out in outs:
        assert torch.equal(out, gloo)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_sharded_forward_without_norms_is_the_one_device_forward(m):
    """``norm_layer: null`` builds no norm at any site, sharded too: each
    sharded site is the conv slice and its activation alone. G and D in
    train mode (the smoothers' BatchNorm on its channel slice, its
    running statistics advanced whole) against the one-device forward
    within 1e-5, the statistics within 1e-6."""
    torch.manual_seed(3)
    g = GeneratorJ(input_channels=6, filters=[8, 16, 32, 32, 32, 16],
                   resnet_blocks=2, use_bias=True, norm_layer=None)
    d = DiscriminatorN_IN(input_channels=3, num_filters=8, n_layers=2,
                          norm_layer=None)
    x = torch.rand(2, 32, 32, 6) * 2 - 1
    for net, xin in ((g, x), (d, x[..., :3])):
        group = TurnGroup(m)
        ranks = [copy.deepcopy(net) for _ in range(m)]
        for r, shard_net in enumerate(ranks):
            shard_module_(shard_net, ModelShard(r, m, group.member(r)))

        def forward(n):
            def run():
                with torch.no_grad():
                    return n(xin)
            return run

        outs = group.run([forward(n) for n in ranks])
        with torch.no_grad():
            want = net(xin)
        for out in outs:
            np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                                       rtol=0)
        for name, buf in net.named_buffers():
            for shard_net in ranks:
                got = dict(shard_net.named_buffers())[name]
                np.testing.assert_allclose(got.numpy(), buf.numpy(),
                                           atol=1e-6, rtol=0)


def test_tp_fit_through_train_cli_writes_a_whole_checkpoint(tmp_path):
    """(d) ``train_torch.py``'s CLI at ``training.devices=-1
    parallel.mesh.model=2`` in a process that owns 2 devices (the CPU
    given 2 entries): 2 gloo ranks, data 1 x model 2. Its ``last.ckpt`` is
    whole: the networks load ``strict=True`` into the whole modules and
    the Adam moments have the whole shapes; a resume from it continues
    at its step on both ranks."""
    root = tmp_path / "s"
    make_scene(str(root / "scene"), frames=3, height=48, width=72, seed=3)
    run = tmp_path / "run"
    script = (
        "import sys, torch; from patch_toon_tpu_torch import parallel, "
        "train_cli; real = parallel.local_devices; "
        "parallel.local_devices = lambda n=-1, cpu=False: "
        "[torch.device('cpu')] * 2 if cpu and n == -1 else real(n, cpu); "
        "sys.exit(train_cli.main(sys.argv[1:]))")
    args = [*_scene_overrides(root), "model.generator.args.filters="
            "[8,16,32,32,32,16]", "model.generator.args.resnet_blocks=2",
            "model.discriminator.args.num_filters=8",
            f"data.patch_size={PS}", "training.accelerator=cpu",
            "training.batch_size=4", "training.log_every_n_steps=1",
            "training.devices=-1", "parallel.mesh.model=2",
            f"run.dir={run}"]

    def train(*extra):
        proc = subprocess.run([sys.executable, "-c", script, *args, *extra],
                              cwd=str(root), env=ENV, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc.stdout

    out = train("training.max_steps=2")
    assert "Training on 2 ranks: data 1 x model 2" in out
    assert "(data 1 x model 2)" in out
    ckpt = torch.load(run / "checkpoints" / "last.ckpt", weights_only=True)
    assert ckpt["global_step"] == 2
    sd = ckpt["state_dict"]
    for pre, net in (("generator.", GeneratorJ(
            input_channels=6, filters=[8, 16, 32, 32, 32, 16],
            resnet_blocks=2, use_bias=True)),
            ("discriminator.", DiscriminatorN_IN(
                input_channels=3, num_filters=8, n_layers=2))):
        net.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                             if k.startswith(pre)}, strict=True)
        opt = ckpt["optimizer_states"][0 if pre == "generator." else 1]
        assert [tuple(t.shape) for t in opt["mu"]] == \
            [tuple(p.shape) for p in net.parameters()]
    out = train("training.max_steps=4",
                f"training.resume_from={run / 'checkpoints' / 'last.ckpt'}")
    assert out.count("Resumed from") == 1
    again = torch.load(run / "checkpoints" / "last.ckpt", weights_only=True)
    assert again["global_step"] == 4
    assert json.dumps(sorted(again["state_dict"])) == json.dumps(sorted(sd))
