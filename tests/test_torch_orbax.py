"""The port's Orbax reader (``utils/ocdbt.py``, ``utils/orbax.py``) against
the JAX package and tensorstore, on the CPU.

- ``utils/ocdbt.py``: every key and raw value equal to tensorstore's
  ``ocdbt`` kvstore on the same database (the committed checkpoint's
  top-level and per-process databases, and one tensorstore writes here
  with interior nodes);
- each of the 6 committed checkpoint directories read bit for bit as
  JAX's restore, and ``docs/quality_2000/ours_ckpt/last`` held to the
  committed digest ``tests/data/orbax/quality_2000_last.json`` (which is
  regenerated here from JAX's restore and compared);
- small directories written by JAX's ``CheckpointManager`` after one JAX
  step from seeded parameters (with and without D, weight decay on and
  off, ``accumulate_grad_batches`` 1 and 2): read bit for bit, the
  engine's weights equal to JAX's restore, one directory served within 1
  uint8 count of the JAX engine, and one step resumed against JAX's
  resume within tests/test_torch_train.py's tolerances (losses 1e-5 for D and
  1e-4 for G; parameters 1.5e-4 for kernels and 9e-4 otherwise where both
  gradients reach 1e-7, gradients within 5e-5 in relative L2 norm; the
  step's gradient is Adam's ``(mu - b1 * mu_before) / (1 - b1)`` on both
  sides), the loaded moments and step counts bit for bit;
- the port imports none of jax, orbax, tensorstore or zstandard.
"""

import hashlib
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
from PIL import Image

from patch_toon_tpu.config import compose as jax_compose
from patch_toon_tpu.infer import StyleTransferInference as JaxInference
from patch_toon_tpu.train import StyleTransferModel as JaxModel
from patch_toon_tpu.train import make_train_step as jax_make_train_step
from patch_toon_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager,
)
from patch_toon_tpu.train.state import GANTrainState

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.train.checkpoints import CheckpointManager
from patch_toon_tpu_torch.train.model import StyleTransferModel
from patch_toon_tpu_torch.train.optim import MultiSteps
from patch_toon_tpu_torch.train.parity import (
    assert_first_step_close,
    first_step_agreement,
)
from patch_toon_tpu_torch.train.step import make_train_step
from patch_toon_tpu_torch.utils import ocdbt, orbax
from patch_toon_tpu_torch.utils.weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
    load_generator_state,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

COMMITTED = sorted(str(p.relative_to(REPO)) for p in
                   REPO.glob("docs/quality_*/ours_ckpt/*") if p.is_dir())
DIGEST = REPO / "tests" / "data" / "orbax" / "quality_2000_last.json"
LAST = REPO / "docs" / "quality_2000" / "ours_ckpt" / "last"
PS, B = 16, 4
G_ARGS = dict(input_channels=6, use_bias=True, tanh=True,
              append_smoothers=True, resnet_blocks=1,
              filters=[4, 8, 8, 8, 8, 4], norm_layer="instance_norm")
D_ARGS = dict(num_filters=4, n_layers=2, use_noise=False, noise_sigma=0.2,
              norm_layer="instance_norm", use_bias=True, input_channels=3)
CASES = {"base": dict(disc=True, wd=1e-5, acc=1),
         "no_d": dict(disc=False, wd=1e-5, acc=1),
         "no_wd": dict(disc=True, wd=0.0, acc=1),
         "acc2": dict(disc=True, wd=1e-5, acc=2)}


def _jax_restore(path):
    """JAX's raw restore of a directory, onto this process's first device
    (the committed directories name the TPU that wrote them), as
    ``restore_generator`` does in a multi-process run."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    p = pathlib.Path(path).absolute()
    sharding = jax.sharding.SingleDeviceSharding(jax.local_devices()[0])
    abstract = jax.tree.map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=sharding),
        dict(ckptr.metadata(p).item_metadata))
    return ckptr.restore(p, abstract)


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)[0]
    return {jax.tree_util.keystr(k): v for k, v in flat}


def _assert_tree_bitwise(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        w = np.asarray(w)
        assert isinstance(g, np.ndarray) and g.flags.owndata, k
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


def make_digest() -> None:
    """Write the digest of JAX's restore of ``docs/quality_2000/ours_ckpt/
    last``: ``JAX_PLATFORMS=cpu python tests/test_torch_orbax.py``."""
    DIGEST.parent.mkdir(parents=True, exist_ok=True)
    DIGEST.write_text(json.dumps({
        "source": str(LAST.relative_to(REPO)),
        "made_by": "tests/test_torch_orbax.py::make_digest (JAX's restore)",
        "leaves": _digest(_jax_restore(LAST))}, indent=1) + "\n")


def _digest(tree):
    return [{"path": k, "shape": list(np.shape(v)),
             "dtype": str(np.asarray(v).dtype),
             "sha256": hashlib.sha256(np.ascontiguousarray(
                 np.asarray(v)).tobytes()).hexdigest()}
            for k, v in sorted(_leaves(tree).items()) if v is not None]


# ------------------------------------------------------------- the key layer

@pytest.fixture(scope="module")
def deep_db(tmp_path_factory):
    """An OCDBT database tensorstore writes with small nodes: a b-tree of
    interior nodes, inline and indirect values."""
    ts = pytest.importorskip("tensorstore")
    root = tmp_path_factory.mktemp("ocdbt") / "db"
    spec = ts.KvStore.Spec(f"file://{root}/|ocdbt:").to_json()
    spec["config"] = {"max_decoded_node_bytes": 300,
                      "max_inline_value_bytes": 16}
    kv = ts.KvStore.open(ts.KvStore.Spec(spec)).result()
    txn = ts.Transaction()
    for i in range(200):
        kv.with_transaction(txn)[f"key/{i:05d}/x"] = \
            b"v%d" % i * (1 + i % 10)
    txn.commit_async().result()
    return root


@pytest.mark.parametrize("which", ["top", "process_0", "deep"])
def test_ocdbt_keys_and_values_equal_tensorstore(which, deep_db):
    ts = pytest.importorskip("tensorstore")
    root = {"top": LAST, "process_0": LAST / "ocdbt.process_0",
            "deep": deep_db}[which]
    db = ocdbt.Database(root)
    if which == "deep":
        assert db.version.height > 0
    kv = ts.KvStore.open(f"file://{root}/|ocdbt:").result()
    keys = db.list()
    assert keys == sorted(kv.list().result()) and len(keys) > 100
    for k in keys:
        assert db.read(k) == bytes(kv.read(k).result().value), k
    assert db.read(b"absent") is None
    sub = keys[len(keys) // 2][:9]
    assert db.list(sub) == [k for k in keys if k.startswith(sub)]


def test_ocdbt_refuses_damage_by_name(tmp_path):
    raw = bytearray((LAST / "manifest.ocdbt").read_bytes())
    (tmp_path / "a").mkdir()
    bad = bytearray(raw)
    bad[20] ^= 1
    (tmp_path / "a" / "manifest.ocdbt").write_bytes(bytes(bad))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.Database(tmp_path / "a")
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "manifest.ocdbt").write_bytes(bytes(raw[:60]))
    with pytest.raises(ocdbt.OcdbtError, match="says 119 bytes"):
        ocdbt.Database(tmp_path / "b")


# ------------------------------------------------ the committed checkpoints

@pytest.mark.parametrize("rel", COMMITTED)
def test_committed_checkpoint_reads_as_jax_restores(rel):
    assert len(COMMITTED) == 6
    stats = orbax.ReadStats()
    got = orbax.read_tree(REPO / rel, stats=stats)
    _assert_tree_bitwise(got, _jax_restore(REPO / rel))
    assert stats.chunks == 173 and stats.decoded_bytes > 30e6


def test_digest_file_is_jax_restores():
    """The committed digest regenerated from JAX's restore, and the
    port's read held to it (as chip_smoke.py's orbax phase holds it)."""
    want = json.loads(DIGEST.read_text())
    assert _digest(_jax_restore(LAST)) == want["leaves"]
    assert _digest(orbax.read_tree(LAST)) == want["leaves"]
    assert want["source"] == str(LAST.relative_to(REPO))


def test_sniff_reads_meta_then_the_kernel_zarray(tmp_path):
    assert orbax.sniff_input_channels(LAST) == 6
    d = tmp_path / "ckpt"
    d.mkdir()
    for f in ("_METADATA", "manifest.ocdbt"):
        (d / f).write_bytes((LAST / f).read_bytes())
    (d / "d").symlink_to(LAST / "d")
    (d / "ocdbt.process_0").symlink_to(LAST / "ocdbt.process_0")
    (d / "meta.json").write_text("{}")
    assert orbax.sniff_input_channels(d) == 6
    (d / "meta.json").write_text('{"input_channels": 9}')
    assert orbax.sniff_input_channels(d) == 9


# ------------------------------------------- small directories JAX writes

def _configs(case):
    c = CASES[case]
    opt = dict(lr=4e-4, betas=[0.9, 0.999], weight_decay=c["wd"])
    return dict(
        generator_config={"type": "GeneratorJ", "args": dict(G_ARGS)},
        discriminator_config={"type": "DiscriminatorN_IN",
                              "args": dict(D_ARGS)} if c["disc"] else None,
        training_config=dict(
            batch_size=B, reconstruction_weight=4.0, adversarial_weight=0.5,
            use_image_loss=True, reconstruction_criterion="MSELoss",
            adversarial_criterion="MSELoss", use_gradient_clipping=True,
            gradient_clip_val=0.5, precision="32",
            accumulate_grad_batches=c["acc"]),
        optimizer_config=dict(generator=dict(opt), discriminator=dict(opt)),
        data_config=dict(patch_size=PS, additional_channels={
            "guide": {"path": "unused", "depth": 3}}),
        perception_loss_config=None)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"pre": rng.standard_normal((B, PS, PS, 3)).astype(np.float32),
            "channels": rng.standard_normal((B, PS, PS, 3)).astype(
                np.float32),
            "post": (rng.random((B, PS, PS, 3)) * 2 - 1).astype(np.float32)}


def _seeded(shapes, rng):
    """numpy arrays of the pytree of ``jax.ShapeDtypeStruct`` ``shapes``:
    kernels scaled by their fan-in, BatchNorm variances positive."""
    def one(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            scale = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        elif "var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        elif "scale" in name:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        else:
            scale = 0.1
        return (scale * rng.standard_normal(s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _jax_state(jm):
    """A JAX ``GANTrainState`` of ``jm`` from seeded numpy parameters in
    the structure flax's ``init`` gives (its shapes alone are traced: a
    real ``init`` runs the networks op by op, the slowest step here)."""
    rng = np.random.default_rng(0)
    g = _seeded(jax.eval_shape(lambda: jm.generator.init(
        jax.random.PRNGKey(0), jnp.zeros((1, PS, PS, 6)), train=True)), rng)
    g_params = jax.tree.map(jnp.asarray, g["params"])
    d_params = d_opt = None
    if jm.discriminator is not None:
        d = _seeded(jax.eval_shape(lambda: jm.discriminator.init(
            jax.random.PRNGKey(1), jnp.zeros((1, PS, PS, 3)))), rng)
        d_params = jax.tree.map(jnp.asarray, d["params"])
        d_opt = jm.tx_d.init(d_params)
    return GANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params,
        g_batch_stats=jax.tree.map(jnp.asarray, g["batch_stats"]),
        g_opt=jm.tx_g.init(g_params), d_params=d_params, d_opt=d_opt)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """case -> (its ``last`` directory, the JAX model and jitted step, the
    JAX state it holds): one JAX step from seeded parameters, then
    JAX's ``CheckpointManager.save``."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    cache = {}

    def get(case):
        if case not in cache:
            jm = JaxModel(**_configs(case))
            state = _jax_state(jm)
            step = jax_make_train_step(jm, donate=False)
            new, _ = step(state, jax.tree.map(jnp.asarray, _batch(0)),
                          jax.random.PRNGKey(1))
            JaxCheckpointManager(root / case, meta={
                "input_channels": 6, "generator_args": G_ARGS,
                "patch_size": PS}).save(new, epoch=0, score=1.0)
            cache[case] = (root / case / "last", jm, step, state)
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_small_checkpoint_reads_and_loads_as_jax(case, written):
    """Bit for bit JAX's restore; the engine's generator is the restored
    generator mapped (so it serves as JAX's weights do)."""
    path, _, _, _ = written(case)
    tree = orbax.read_tree(path)
    _assert_tree_bitwise(tree, _jax_restore(path))
    assert ("d_params" in tree) == CASES[case]["disc"]
    g = jax.tree.map(np.asarray, _jax_restore(path))
    want = generator_state_from_jax(g["g_params"], g["g_batch_stats"],
                                    resnet_blocks=1)
    eng = StyleTransferInference(compose(REPO / "config", "inference",
                                         overrides=_serve_overrides(
                                             path, pathlib.Path("/unused"))))
    got = eng.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].float(), v.float()), k
    # the reader under the engine takes the generator's norm_layer
    sd = load_generator_state(path, norm_layer="instance_norm")
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="needs the generator's norm_layer"):
        load_generator_state(path)


def _serve_overrides(ckpt, scene):
    s = scene / "scene"
    return [f"paths.checkpoint={ckpt}", f"paths.input_dir={s / 'input'}",
            f"paths.mask_dir={s / 'mask'}",
            f"paths.output_dir={scene / 'out'}",
            f"paths.additional_channels.point_vector.path={s / 'tracking'}",
            "inference.use_gpu=false", "inference.precision=32",
            f"data.patch_size={PS}"]


def test_directory_serves_within_one_count_of_jax(written, tmp_path):
    """The base directory through both engines (the generator args from
    its meta.json on both sides), one frame of a sample scene."""
    path, _, _, _ = written("base")
    make_scene(str(tmp_path / "scene"), frames=1, height=40, width=56,
               seed=3)
    over = _serve_overrides(path, tmp_path)
    src = sorted((tmp_path / "scene" / "input").iterdir())[0]
    mask = tmp_path / "scene" / "mask" / src.name
    port = StyleTransferInference(compose(REPO / "config", "inference",
                                          overrides=over))
    port.process_image(src, mask, tmp_path / "port.png")
    jeng = JaxInference(jax_compose(REPO / "config", "inference",
                                    overrides=over))
    jeng.process_image(str(src), str(mask), str(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png")).astype(int)
    want = np.asarray(Image.open(tmp_path / "jax.png")).astype(int)
    assert got.std() > 1.0
    assert np.abs(got - want).max() <= 1


def _moments(opt):
    inner = opt.inner if isinstance(opt, MultiSteps) else opt
    return [m.detach().clone() for m in inner.mu]


def _jax_adam(opt_state):
    chain = opt_state.inner_opt_state if hasattr(opt_state,
                                                 "inner_opt_state") \
        else opt_state
    return [s for s in chain if hasattr(s, "mu")][0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_one_step_matches_jax_resume(case, written):
    path, jm, jstep, fresh = written(case)
    jstate = JaxCheckpointManager.restore(str(path), fresh)
    pm = StyleTransferModel(**_configs(case))
    ps = pm.init_state(0, "cpu")
    CheckpointManager.restore(str(path), ps)
    # the loaded state, bit for bit
    nets = [("G", ps.generator, ps.g_opt, jstate.g_params, jstate.g_opt,
             lambda t: generator_state_from_jax(t, jstate.g_batch_stats,
                                                resnet_blocks=1))]
    if CASES[case]["disc"]:
        nets.append(("D", ps.discriminator, ps.d_opt, jstate.d_params,
                     jstate.d_opt,
                     lambda t: discriminator_state_from_jax(t, n_layers=2)))
    assert ps.step == int(jstate.step) == 1
    before = {}
    for tag, net, opt, _, jopt, to_sd in nets:
        adam = _jax_adam(jopt)
        inner = opt.inner if isinstance(opt, MultiSteps) else opt
        assert inner.count == int(adam.count)
        names = [n for n, _ in net.named_parameters()]
        for mine, theirs in ((inner.mu, adam.mu), (inner.nu, adam.nu)):
            sd = to_sd(jax.tree.map(np.asarray, theirs))
            for n, t in zip(names, mine):
                assert torch.equal(t, sd[n]), (tag, n)
        if isinstance(opt, MultiSteps):
            assert (opt.mini_step, opt.gradient_step) == (
                int(jopt.mini_step), int(jopt.gradient_step)) == (1, 0)
            sd = to_sd(jax.tree.map(np.asarray, jopt.acc_grads))
            for n, t in zip(names, opt.acc):
                assert torch.equal(t, sd[n]), (tag, n)
        before[tag] = _moments(opt)
    # one step on both sides
    batch = _batch(1)
    new, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                      jax.random.PRNGKey(2))
    met = make_train_step(pm)(ps, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                              torch.Generator().manual_seed(0))
    assert ps.step == int(new.step) == 2
    for k in jmet:
        tol = 1e-5 if k.startswith("d_") else 1e-4
        assert abs(float(met[k]) - float(jmet[k])) <= tol, k
    jnew = {"G": (new.g_params, new.g_opt),
            "D": (new.d_params, new.d_opt)}
    for tag, net, opt, _, jopt0, to_sd in nets:
        params, jopt = jnew[tag]
        want_p = to_sd(jax.tree.map(np.asarray, params))
        want_mu = to_sd(jax.tree.map(np.asarray, _jax_adam(jopt).mu))
        names = [n for n, _ in net.named_parameters()]
        pairs = []
        for n, p, m0, m1 in zip(names, net.parameters(), before[tag],
                                _moments(opt)):
            g_mine = ((m1 - 0.9 * m0) / 0.1).numpy()
            g_jax = ((want_mu[n] - 0.9 * m0) / 0.1).numpy()
            pairs.append((n, n.endswith("weight") and p.ndim == 4,
                          want_p[n].numpy(), p.detach().numpy(), g_jax,
                          g_mine))
        assert_first_step_close(first_step_agreement(pairs), 5e-5,
                                f"{case} {tag}")


@pytest.mark.parametrize("case", ["base", "acc2"])
def test_fit_resumes_from_the_directory(case, written, tmp_path, capsys):
    """``fit(resume_from=<Orbax dir>)``, the path under ``train_torch.py
    training.resume_from``: JAX's line, the step going on from the
    checkpoint's, Adam's count (and MultiSteps' counters) with it."""
    from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
    from patch_toon_tpu_torch.train.loop import fit

    path, _, _, _ = written(case)
    rng = np.random.default_rng(8)
    frames = [rng.uniform(-1, 1, (24, 24, 3)).astype(np.float32)
              for _ in range(2)]
    mask = np.zeros((24, 24), np.float32)
    mask[12, 12] = 1
    data = StyleTransferDataset(frames[:1], frames[1:], [mask],
                                [frames[0]], [3], patch_size=PS,
                                device="cpu")
    cfg = _configs(case)
    cfg["training_config"]["max_steps"] = 2
    state = fit(StyleTransferModel(**cfg), data, str(tmp_path / "run"),
                progress=False, resume_from=str(path))
    assert f"Resumed from {path} at step 1" in capsys.readouterr().out
    assert state.step == 2
    if case == "acc2":  # the second micro-step applied the update
        assert (state.g_opt.mini_step, state.g_opt.gradient_step,
                state.g_opt.inner.count) == (0, 1, 1)
    else:
        assert state.g_opt.count == state.d_opt.count == 2


def test_the_port_imports_no_jax_orbax_tensorstore_or_zstandard():
    """In a fresh interpreter: the port's modules import none of the four;
    with the four made unimportable the committed checkpoint still reads
    whole and matches the digest."""
    code = f"""
import hashlib, json, sys
import patch_toon_tpu_torch.infer.engine, patch_toon_tpu_torch.train.loop
import patch_toon_tpu_torch.cli, patch_toon_tpu_torch.train_cli
import patch_toon_tpu_torch.utils.orbax as orbax
bad = ("jax", "orbax", "tensorstore", "zstandard", "patch_toon_tpu")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in bad)
assert not loaded, loaded
for m in bad:
    sys.modules[m] = None
tree = orbax.read_tree({str(LAST)!r})
want = json.load(open({str(DIGEST)!r}))["leaves"]
def walk(t, p):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from walk(t[k], p + [repr(k)])
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from walk(v, p + [repr(i)])
    elif t is not None:
        yield "".join("[" + k + "]" for k in p), t
got = sorted(walk(tree, []))
assert [g[0] for g in got] == [w["path"] for w in want]
for (k, v), w in zip(got, want):
    assert hashlib.sha256(v.tobytes()).hexdigest() == w["sha256"], k
print("ok", len(got))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO),
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["ok", "173"]


if __name__ == "__main__":
    make_digest()
