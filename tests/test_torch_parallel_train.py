"""Data-parallel training in the port against the JAX package's mesh step,
and through the entry points, on the CPU.

The port's ranks are gloo processes that import no jax
(``tests/torch_dist_worker.py``, ``train_torch.py``); the JAX side runs on
2 of the 8 virtual CPU devices of ``tests/conftest.py``. Widths, configs
and batch are those of ``tests/test_torch_train.py`` (batch 4, 32x32
patches, a 6-channel generator) with the smoothers' BatchNorm, so the
cross-rank BatchNorm is exercised. Tolerances:

- the 2-rank step against JAX's ``make_mesh(data=2)`` step: those of
  ``tests/test_torch_train.py`` (losses 1e-5 for D and 1e-4 for G;
  ``train/parity.py::first_step_agreement`` within 5e-5; BatchNorm mean
  1e-5, variance 1e-3);
- the 2-rank step (and under ``accumulate_grad_batches=2`` the update
  after two micro-steps) against the port's one-process step: the same
  rule and loss limits; the ranks' parameters, statistics and Adam moments
  bitwise equal to each other, and a world of one rank bitwise the plain
  step;
- the samplers: the ranks' rows bitwise the one-device batch, uniform and
  permutation;
- ``train_torch.py`` at ``training.devices=2`` and in the two
  ``parallel.dcn`` forms (2 processes x 1 rank, an explicit coordinator or
  torchrun's environment): the three runs' checkpoints bitwise equal.
"""

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
from patch_toon_tpu.train import StyleTransferModel as JaxModel
from patch_toon_tpu.train import make_train_step as jax_make_train_step
from patch_toon_tpu_torch import parallel, train_cli
from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
from patch_toon_tpu_torch.train.model import StyleTransferModel
from patch_toon_tpu_torch.train.parity import (
    assert_first_step_close,
    first_step_agreement,
    state_pairs,
)
from patch_toon_tpu_torch.utils.weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
)

from test_torch_train import (  # noqa: E402  (tests/ is on the path)
    B,
    PS,
    SMALL_ARCH,
    _assert_bn_close,
    _configs,
    _port_pairs,
    _scene_overrides,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

WORKER = REPO / "tests" / "torch_dist_worker.py"
ENV = {**os.environ, "PYTHONPATH": str(REPO)}


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"pre": rng.standard_normal((B, PS, PS, 3)).astype(np.float32),
             "channels": rng.standard_normal((B, PS, PS, 3)).astype(
                 np.float32),
             "post": (rng.random((B, PS, PS, 3)) * 2 - 1).astype(np.float32)}
            for _ in range(n)]


def _run_worker(tmp, configs, state, batches, *worlds):
    """The port's steps from JAX's start ``state`` in the worker: ->
    {"plain" / "w<N>_rank<r>": result}."""
    params = jax.tree.map(np.asarray, (state.g_params, state.g_batch_stats,
                                       state.d_params))
    torch.save({"configs": configs,
                "g": generator_state_from_jax(params[0], params[1],
                                              resnet_blocks=2),
                "d": discriminator_state_from_jax(params[2], n_layers=2),
                "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                            for b in batches]}, tmp / "case.pt")
    proc = subprocess.run(
        [sys.executable, str(WORKER), str(tmp / "case.pt"), str(tmp),
         *map(str, worlds)], env=ENV, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return {p.stem: torch.load(p, weights_only=False)
            for p in tmp.glob("*.pt") if p.stem != "case"}


def _as_state(configs, res):
    """A port state holding a worker's result (networks, Adam's mu), its
    optimizers plain Adam (the moments are those of the inner Adam under
    accumulation)."""
    configs = {**configs, "training_config": {
        **configs["training_config"], "accumulate_grad_batches": 1}}
    ps = StyleTransferModel(**configs).init_state(0, "cpu")
    ps.generator.load_state_dict(res["G"])
    ps.discriminator.load_state_dict(res["D"])
    for opt, mu in ((ps.g_opt, res["g_mu"]), (ps.d_opt, res["d_mu"])):
        for dst, src in zip(getattr(opt, "inner", opt).mu, mu):
            dst.copy_(src)
    return ps


def _assert_bitwise(a, b, what):
    for key in ("G", "D"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (what, key, k)
    for key in ("g_mu", "d_mu"):
        assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), \
            (what, key)
    assert a["metrics"] == b["metrics"], what


def _assert_step_close(ref_m, ref_state, m, state, tag):
    for k in ref_m:
        tol = 1e-5 if k.startswith("d_") else 1e-4
        assert abs(float(m[k]) - float(ref_m[k])) <= tol, (tag, k)
    assert_first_step_close(first_step_agreement(
        state_pairs(ref_state, state)), 5e-5, tag)


def test_two_rank_step_matches_the_jax_mesh_step(tmp_path):
    """One GAN step on 2 gloo ranks (2 rows each) against JAX's step on a
    2-device data mesh, the plain step in one process, and a world of one
    rank."""
    configs = _configs()
    jm = JaxModel(**configs)
    state = jm.init_state(jax.random.PRNGKey(0), patch_size=PS)
    batch = _batches(1)
    mesh = make_mesh(data=2, model=1)
    with mesh:
        new, jmet = jax_make_train_step(jm, donate=False)(
            replicate(state, mesh), shard_batch(
                {k: jnp.asarray(v) for k, v in batch[0].items()}, mesh),
            jax.random.PRNGKey(1))
    res = _run_worker(tmp_path, configs, state, batch, 0, 1, 2)
    _assert_bitwise(res["w2_rank0"], res["w2_rank1"], "ranks")
    _assert_bitwise(res["w1_rank0"], res["plain"], "world 1 against plain")

    got = res["w2_rank0"]
    for k in jmet:
        tol = 1e-5 if k.startswith("d_") else 1e-4
        assert abs(got["metrics"][0][k] - float(jmet[k])) <= tol, k
    pairs, stats_after = _port_pairs(new, _as_state(configs, got))
    for tag, p in pairs.items():
        assert_first_step_close(first_step_agreement(p), 5e-5, tag)
    _assert_bn_close(stats_after, new)
    _assert_step_close(res["plain"]["metrics"][0],
                       _as_state(configs, res["plain"]),
                       got["metrics"][0], _as_state(configs, got),
                       "2 ranks against plain")


def test_two_rank_accumulation_matches_one_process(tmp_path):
    """``accumulate_grad_batches=2``: the gradients are averaged over the
    ranks at each micro-step, before the Welford mean; the update after
    two micro-steps against the one-process update."""
    configs = _configs()
    configs["training_config"]["accumulate_grad_batches"] = 2
    state = JaxModel(**_configs()).init_state(jax.random.PRNGKey(0),
                                              patch_size=PS)
    res = _run_worker(tmp_path, configs, state, _batches(2), 0, 1, 2)
    _assert_bitwise(res["w2_rank0"], res["w2_rank1"], "ranks")
    _assert_bitwise(res["w1_rank0"], res["plain"], "world 1 against plain")
    for i in range(2):
        _assert_step_close(res["plain"]["metrics"][i],
                           _as_state(configs, res["plain"]),
                           res["w2_rank0"]["metrics"][i],
                           _as_state(configs, res["w2_rank0"]),
                           f"micro-step {i}")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel_train")
    make_scene(str(root / "scene"), frames=3, height=48, width=72, seed=3)
    return root


@pytest.mark.parametrize("sampling", ["uniform", "permutation"])
def test_rank_samplers_take_the_one_device_rows(scene, sampling):
    s = scene / "scene"
    data = StyleTransferDataset.from_directories(
        str(s / "input"), str(s / "output"), str(s / "mask"), PS, 2,
        {"point_vector": {"path": str(s / "tracking"), "depth": 3}},
        sampling, "cpu")
    n = 6
    one = data.make_sampler(n)
    ranks = [data.make_sampler(n, parallel.shard_rows(n, r, 3))
             for r in range(3)]
    gens = [torch.Generator().manual_seed(4) for _ in range(4)]
    for _ in range(40):  # the permutation cursors wrap
        want = one(gens[0])
        got = [sample(g) for sample, g in zip(ranks, gens[1:])]
        assert sorted(want) == sorted(got[0])
        for k in want:
            assert torch.equal(torch.cat([g[k] for g in got]), want[k]), k
    if sampling == "permutation":
        for sample in ranks:
            for k in one.state:
                assert torch.equal(sample.state[k], one.state[k])


def _train(scene, run, *extra, wait=True, env=None):
    cmd = [sys.executable, str(REPO / "train_torch.py"),
           *_scene_overrides(scene), *SMALL_ARCH,
           "training.accelerator=cpu", "training.batch_size=4",
           "training.max_steps=3", "training.log_every_n_steps=1",
           "+data.sampling=permutation", f"run.dir={run}", *extra]
    proc = subprocess.Popen(cmd, cwd=str(scene), env={**ENV, **(env or {})},
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    if not wait:
        return proc
    out = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, out[-4000:]
    return out


def _checkpoint_tensors(path):
    ck = torch.load(path, map_location="cpu", weights_only=True)
    return ck["state_dict"], ck["global_step"]


def test_fit_on_two_ranks_through_train_torch(scene, tmp_path):
    """``training.devices=2 training.accelerator=cpu``: rank 0 alone
    prints and writes the run directory; a resume continues on both
    ranks; the last checkpoint serves; the ``parallel.dcn`` forms (two
    processes of one rank, with an explicit coordinator or with the
    environment torchrun sets) train the same bits."""
    run = tmp_path / "run"
    out = _train(scene, run, "training.devices=2")
    assert "Training on 2 ranks" in out
    assert out.count("epoch 0: g_total_loss=") == 1
    assert out.count("=== Resolved config ===") == 1
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "epoch_0000.ckpt", "last.ckpt"]
    assert len(list((run / "tb").glob("events*"))) == 1
    sd2, step = _checkpoint_tensors(run / "checkpoints" / "last.ckpt")
    assert step == 3

    port, port_env = parallel.free_port(), parallel.free_port()
    explicit, env_form = tmp_path / "dcn", tmp_path / "torchrun"
    procs = [_train(scene, explicit, "parallel.dcn.enabled=true",
                    f"parallel.dcn.coordinator_address=localhost:{port}",
                    "parallel.dcn.num_processes=2",
                    f"parallel.dcn.process_id={i}", wait=False)
             for i in range(2)]
    procs += [_train(scene, env_form, "parallel.dcn.enabled=true",
                     wait=False, env={
                         "MASTER_ADDR": "localhost",
                         "MASTER_PORT": str(port_env), "RANK": str(i),
                         "WORLD_SIZE": "2", "LOCAL_RANK": str(i),
                         "LOCAL_WORLD_SIZE": "2"})
              for i in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    for first, second in (logs[:2], logs[2:]):
        assert "epoch 0:" in first and "epoch 0:" not in second
    for run_dir in (explicit, env_form):
        sd_dcn, _ = _checkpoint_tensors(run_dir / "checkpoints" /
                                        "last.ckpt")
        for k in sd2:
            assert torch.equal(sd2[k], sd_dcn[k]), (run_dir.name, k)

    out = _train(scene, run, "training.devices=2", "training.max_steps=5",
                 f"training.resume_from={run / 'checkpoints' / 'last.ckpt'}")
    assert "Resumed from" in out and out.count("Resumed from") == 1
    _, step = _checkpoint_tensors(run / "checkpoints" / "last.ckpt")
    assert step == 5

    styl = tmp_path / "styl"
    s = scene / "scene"
    proc = subprocess.run(
        [sys.executable, str(REPO / "generator_torch.py"),
         f"paths.checkpoint={run / 'checkpoints' / 'last.ckpt'}",
         f"paths.input_dir={s / 'input'}", f"paths.mask_dir={s / 'mask'}",
         f"paths.output_dir={styl}",
         f"paths.additional_channels.point_vector.path={s / 'tracking'}",
         "inference.use_gpu=false", "inference.precision=32",
         *SMALL_ARCH], env=ENV, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(list(styl.glob("*.png"))) == 3


def test_refusals_by_name(scene, tmp_path):
    """The launcher's refusals, before any rank starts; the data x model
    layout of ``parallel.mesh.model`` as JAX's ``train.py`` and
    ``mesh.py::make_mesh`` resolve it (``devices=1`` ignores it; JAX's
    wording for a model size that does not divide the cards and for too
    few cards)."""
    base = _scene_overrides(scene) + SMALL_ARCH + [
        "training.accelerator=cpu", f"run.dir={tmp_path}"]
    cfg = compose(REPO / "config", "config", overrides=base + [
        "training.devices=-1", "parallel.mesh.model=2"])
    with pytest.raises(ValueError, match="1 devices not divisible by "
                       "model=2"):
        train_cli.train(cfg)
    assert parallel.check_mesh(1, 2, 1) == (1, 1)
    assert parallel.check_mesh(-1, 2, 4) == (2, 2)
    assert parallel.check_mesh(2, 2, 4) == (2, 2)
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 3"):
        parallel.check_mesh(2, 2, 3)
    with pytest.raises(ValueError, match="3 devices not divisible by "
                       "model=2"):
        parallel.check_mesh(-1, 2, 3)
    cfg = compose(REPO / "config", "config", overrides=base + [
        "parallel.mesh.model=2", "parallel.dcn.enabled=true",
        "parallel.dcn.coordinator_address=localhost:1",
        "parallel.dcn.num_processes=2", "parallel.dcn.process_id=0"])
    with pytest.raises(ValueError, match="model=2 does not divide the 1 "
                       "card.*process 0.*never spans processes"):
        train_cli.train(cfg)
    cfg = compose(REPO / "config", "config", overrides=base + [
        "training.devices=3", "training.batch_size=4"])
    with pytest.raises(ValueError, match="batch_size=4.*world size 3"):
        train_cli.train(cfg)
    with pytest.raises(ValueError, match="batch_size=80.*world size 3"):
        parallel.shard_rows(80, 0, 3)
    assert parallel.shard_rows(80, 3, 4) == slice(60, 80)
    assert not (tmp_path / "config.yaml").exists()
    assert parallel.local_devices(3, cpu=True) == [torch.device("cpu")] * 3
    assert parallel.rank() == 0 and parallel.world() == 1
