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
``g_opt`` lets the JAX package go on. The JAX package's Orbax directories
are refused with the command that exports them
(``tools/export_checkpoint.py``).

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
from patch_toon_tpu_torch.train.state import GANTrainState

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
        global_step, g_total_loss, hyper_parameters; {} for no file."""
        if not Path(path).is_file():
            return {}
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        return {k: v for k, v in ckpt.items() if k not in _SKIP}

    @staticmethod
    def restore(path, state: GANTrainState) -> GANTrainState:
        """Load the networks, the optimizer states and the step count of a
        checkpoint into ``state`` (same architecture), in place."""
        if os.path.isdir(str(path)):
            raise ValueError(
                f"{path} is a directory, an Orbax checkpoint of the JAX "
                "package; this port resumes from torch .ckpt files only. "
                "Export it first with tools/export_checkpoint.py (needs "
                f"jax): python tools/export_checkpoint.py {path} out.ckpt, "
                "then pass training.resume_from=out.ckpt (the networks "
                "resume; the optimizer states start anew)")
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
