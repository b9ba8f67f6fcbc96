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
to a temporary name and moved into place.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from patch_toon_tpu_torch.train.state import GANTrainState

_SKIP = ("state_dict", "optimizer_states")


def _cpu_state(module: torch.nn.Module, prefix: str) -> Dict[str, Any]:
    return {f"{prefix}{k}": v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


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

    def _write(self, name: str, state: GANTrainState,
               extra: Dict[str, Any]) -> Path:
        sd = _cpu_state(state.generator, "generator.")
        opts = [state.g_opt.state_dict()]
        if state.discriminator is not None:
            sd.update(_cpu_state(state.discriminator, "discriminator."))
            opts.append(state.d_opt.state_dict())
        path = self.directory / name
        tmp = path.with_name(f".{name}.{os.getpid()}.tmp")
        torch.save({"state_dict": sd, "optimizer_states": opts,
                    "global_step": int(state.step),
                    "hyper_parameters": self.meta, **extra}, tmp)
        os.replace(tmp, path)
        return path

    def save(self, state: GANTrainState, epoch: int, score: float) -> None:
        """``last.ckpt`` and ``epoch_<epoch>.ckpt``, then drop the worst
        epoch files beyond the top k."""
        extra = {"epoch": int(epoch), "g_total_loss": float(score)}
        self._write("last.ckpt", state, extra)
        name = f"epoch_{epoch:04d}.ckpt"
        self._write(name, state, extra)
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
