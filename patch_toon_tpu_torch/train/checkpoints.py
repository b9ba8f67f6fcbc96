"""Training checkpoints as reference-layout ``.ckpt`` files (counterpart of
patch_toon_tpu/train/checkpoints.py, which writes Orbax directories).

Each file is a ``torch.save`` of ``{"state_dict": {"generator.*",
"discriminator.*"}, "epoch", "global_step", "g_total_loss",
"hyper_parameters", "optimizer_states"}``: the reference Lightning layout
(lightning_model.py:11) that the port's ``utils/weights.py::
load_generator_state`` and the JAX package's
``StyleTransferModel.load_torch_checkpoint`` read as they are. Every value
is a tensor or a plain Python type, so the files load with
``weights_only=True``.

Retention is the reference's (train.py:22-31): the top ``keep_top_k``
epochs by score plus an always-current ``last.ckpt``. The scores are read
back from the files on start, so retention carries across a resume, and
``read_meta`` gives the resumed run its epoch numbering. Files are written
to a temporary name and moved into place. Under gradient accumulation an
optimizer state also carries k, the running mean of the gradients, its
micro-step and its update count (``optim.MultiSteps.state_dict``), so a
run resumed in the middle of an accumulation goes on exactly as Orbax's
``g_opt`` lets the JAX package go on.

A directory is the JAX package's Orbax checkpoint, read by
``utils/orbax.py`` (no jax): :func:`restore_orbax` loads it as JAX's
``CheckpointManager.restore`` does (``patch_toon_tpu/train/
checkpoints.py:116-130``): G and its BatchNorm statistics, D where both
the checkpoint and the run have one, ``step``, and from each optax chain
(``patch_toon_tpu/train/optim.py:31-39``: clipping, decayed weights where
``weight_decay`` is set, ``scale_by_adam``, ``scale``) Adam's ``count``,
``mu`` and ``nu``, the moments through the weights' HWIO -> OIHW mapping;
under ``optax.MultiSteps`` also ``mini_step``, ``gradient_step`` and
``acc_grads``. A tree that does not fit the run is refused, naming the
leaf.

Under tensor parallelism a rank holds slices of the sharded parameters
and of their Adam moments: :func:`whole_state` gathers them over the
model group (``parallel/tp.py::gather_whole``, a collective every rank
calls), so the file is the whole reference-layout checkpoint that one
device writes, and a resume loads it whole before ``fit`` shards it
again.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from patch_toon_tpu_torch.parallel.tp import gather_whole
from patch_toon_tpu_torch.train.optim import MultiSteps
from patch_toon_tpu_torch.train.state import GANTrainState
from patch_toon_tpu_torch.utils import orbax
from patch_toon_tpu_torch.utils.weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
)

_SKIP = ("state_dict", "optimizer_states")


def _cpu_state(module: torch.nn.Module, prefix: str) -> Dict[str, Any]:
    sd = module.state_dict()
    if getattr(module, "tp", None) is not None:
        sd = gather_whole(sd, module.tp_sharding, module.tp)
    return {f"{prefix}{k}": v.detach().to("cpu", copy=True)
            for k, v in sd.items()}


def _optimizer_state(opt, net: torch.nn.Module) -> Dict[str, Any]:
    """``opt.state_dict()``, its moments (and accumulated gradient) whole
    under tensor parallelism."""
    sd = opt.state_dict()
    if getattr(net, "tp", None) is None:
        return sd
    names = [n for n, _ in net.named_parameters()]

    def whole(tensors):
        got = gather_whole(dict(zip(names, tensors)), net.tp_sharding, net.tp)
        return [got[n].to("cpu", copy=True) for n in names]

    inner = getattr(opt, "inner", opt)
    inner_sd = {"count": inner.count, "mu": whole(inner.mu),
                "nu": whole(inner.nu)}
    if inner is opt:
        return inner_sd
    return {**sd, "inner": inner_sd, "acc": whole(opt.acc)}


def whole_state(state: GANTrainState) -> Dict[str, Any]:
    """The networks' state dicts (``generator.*``, ``discriminator.*``)
    and the optimizer states of ``state``, whole and on the CPU: under
    tensor parallelism gathered over the model group (every rank of it
    calls this, in the same order)."""
    sd = _cpu_state(state.generator, "generator.")
    opts = [_optimizer_state(state.g_opt, state.generator)]
    if state.discriminator is not None:
        sd.update(_cpu_state(state.discriminator, "discriminator."))
        opts.append(_optimizer_state(state.d_opt, state.discriminator))
    return {"state_dict": sd, "optimizer_states": opts}


class CheckpointManager:
    def __init__(self, directory, keep_top_k: int = 3,
                 meta: Optional[Dict[str, Any]] = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_top_k = keep_top_k
        self.meta = dict(meta or {})
        self._scores: Dict[str, float] = {}
        for path in sorted(self.directory.glob("epoch_*.ckpt")):
            meta = self.read_meta(path)
            if "g_total_loss" in meta:
                self._scores[path.name] = float(meta["g_total_loss"])

    def _write(self, name: str, whole: Dict[str, Any],
               extra: Dict[str, Any]) -> Path:
        path = self.directory / name
        tmp = path.with_name(f".{name}.{os.getpid()}.tmp")
        torch.save({**whole, "hyper_parameters": self.meta, **extra}, tmp)
        os.replace(tmp, path)
        return path

    def save(self, state: GANTrainState, epoch: int, score: float,
             whole: Dict[str, Any]) -> None:
        """``last.ckpt`` and ``epoch_<epoch>.ckpt`` of ``whole``, the
        :func:`whole_state` of ``state`` (under tensor parallelism every
        rank of the model group computes it, so the caller passes it in),
        then drop the worst epoch files beyond the top k."""
        extra = {"epoch": int(epoch), "g_total_loss": float(score),
                 "global_step": int(state.step)}
        self._write("last.ckpt", whole, extra)
        name = f"epoch_{epoch:04d}.ckpt"
        self._write(name, whole, extra)
        self._scores[name] = float(score)
        while len(self._scores) > self.keep_top_k:
            worst = max(self._scores, key=self._scores.get)
            self._scores.pop(worst)
            (self.directory / worst).unlink(missing_ok=True)

    @staticmethod
    def read_meta(path) -> Dict[str, Any]:
        """Everything but the weights and optimizer states: epoch,
        global_step, g_total_loss, hyper_parameters; an Orbax directory's
        ``meta.json``; {} for neither."""
        if Path(path).is_dir():
            return orbax.read_meta(path)
        if not Path(path).is_file():
            return {}
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        return {k: v for k, v in ckpt.items() if k not in _SKIP}

    @staticmethod
    def restore(path, state: GANTrainState) -> GANTrainState:
        """Load the networks, the optimizer states and the step count of a
        checkpoint into ``state`` (same architecture), in place."""
        if os.path.isdir(str(path)):
            return restore_orbax(path, state)
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        sd = ckpt["state_dict"]
        nets = [("generator.", state.generator, state.g_opt)]
        if state.discriminator is not None:
            nets.append(("discriminator.", state.discriminator, state.d_opt))
        for i, (pre, net, opt) in enumerate(nets):
            net.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                                 if k.startswith(pre)}, strict=True)
            if i < len(ckpt.get("optimizer_states", [])):
                opt.load_state_dict(ckpt["optimizer_states"][i])
        state.step = int(ckpt.get("global_step", 0))
        return state


def _generator_sd(params, stats, gen) -> Dict[str, torch.Tensor]:
    return generator_state_from_jax(
        params, stats, resnet_blocks=len(gen.resnet_blocks),
        append_smoothers=gen.smoothers is not None,
        norm_layer="instance_norm" if gen.norm else "none")


def _discriminator_sd(params, disc) -> Dict[str, torch.Tensor]:
    return discriminator_state_from_jax(params,
                                        n_layers=len(disc.intermediate) + 1)


def _load_opt(path, name: str, tree: Any, opt, net, to_sd) -> None:
    """``opt`` (an :class:`Adam` or :class:`MultiSteps`) from the optax
    state ``tree`` of the network ``net``; ``to_sd`` maps a params-shaped
    tree to a torch state dict."""
    inner = opt.inner if isinstance(opt, MultiSteps) else opt
    if isinstance(opt, MultiSteps) != (isinstance(tree, dict)
                                       and "inner_opt_state" in tree):
        raise ValueError(
            f"{path}: {name} was written "
            + ("with" if isinstance(tree, dict) else "without")
            + " optax.MultiSteps; resume it with "
            + ("training.accumulate_grad_batches > 1" if isinstance(
                tree, dict) else "training.accumulate_grad_batches=1"))
    chain = tree["inner_opt_state"] if isinstance(opt, MultiSteps) else tree
    idx = int(inner.clip_norm is not None) + int(bool(inner.weight_decay))
    where = name + (".inner_opt_state" if isinstance(opt, MultiSteps)
                    else "")
    if not isinstance(chain, list) or len(chain) != idx + 2 or any(
            chain[i] is not None for i in range(len(chain)) if i != idx) \
            or not isinstance(chain[idx], dict) \
            or set(chain[idx]) != {"count", "mu", "nu"}:
        have = (f"{len(chain)} entries" if isinstance(chain, list)
                else type(chain).__name__)
        raise ValueError(
            f"{path}: {where} ({have}) does not fit this run's chain: "
            f"scale_by_adam at index {idx} of {idx + 2} (clipping "
            f"{'on' if inner.clip_norm is not None else 'off'}, "
            f"weight_decay {inner.weight_decay})")
    names = [n for n, _ in net.named_parameters()]

    def tensors(sub, leaf):
        try:
            sd = to_sd(sub)
        except KeyError as e:
            raise ValueError(f"{path}: {leaf} has no {e.args[0]}: it does "
                             "not fit this run's network") from e
        out = []
        for n, p in zip(names, net.parameters()):
            t = sd[n]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{path}: {leaf} {n} is {tuple(t.shape)}, "
                                 f"the run's is {tuple(p.shape)}")
            out.append(t)
        return out

    adam = chain[idx]
    inner.load_state_dict({
        "count": int(adam["count"]),
        "mu": tensors(adam["mu"], f"{where}.{idx}.mu"),
        "nu": tensors(adam["nu"], f"{where}.{idx}.nu")})
    if isinstance(opt, MultiSteps):
        opt.mini_step = int(tree["mini_step"])
        opt.gradient_step = int(tree["gradient_step"])
        for dst, src in zip(opt.acc, tensors(tree["acc_grads"],
                                             f"{name}.acc_grads")):
            dst.copy_(src)


def restore_orbax(path, state: GANTrainState) -> GANTrainState:
    """Load the JAX package's Orbax checkpoint ``path`` into ``state`` in
    place (JAX ``CheckpointManager.restore``)."""
    want = ["step", "g_params", "g_batch_stats", "g_opt"]
    if state.discriminator is not None:
        want += ["d_params", "d_opt"]
    tree = orbax.read_tree(path, want)
    for k in ("step", "g_params", "g_opt"):
        if k not in tree:
            raise ValueError(f"{path}: the checkpoint holds no {k}")
    gen = state.generator
    stats = tree.get("g_batch_stats") or {}

    def g_sd(sub):
        return _generator_sd(sub, stats, gen)

    try:
        sd = g_sd(tree["g_params"])
    except KeyError as e:
        raise ValueError(f"{path}: g_params has no {e.args[0]}: it does not "
                         "fit this run's generator") from e
    nets = [("g", gen, state.g_opt, sd, g_sd)]
    if state.discriminator is not None and "d_params" in tree:
        disc = state.discriminator

        def d_sd(sub):
            return _discriminator_sd(sub, disc)

        try:
            dsd = d_sd(tree["d_params"])
        except KeyError as e:
            raise ValueError(f"{path}: d_params has no {e.args[0]}: it does "
                             "not fit this run's discriminator") from e
        nets.append(("d", disc, state.d_opt, dsd, d_sd))
    for pre, net, opt, sd, to_sd in nets:
        try:
            net.load_state_dict(sd, strict=True)
        except RuntimeError as e:
            raise ValueError(f"{path}: {pre}_params does not fit this run's "
                             f"network: {e}") from e
        _load_opt(path, f"{pre}_opt", tree[f"{pre}_opt"], opt, net, to_sd)
    state.step = int(tree["step"])
    return state
