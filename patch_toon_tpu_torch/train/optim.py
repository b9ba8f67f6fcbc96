"""Adam with the JAX package's update, in torch (counterpart of
patch_toon_tpu/train/optim.py).

The reference runs ``torch.optim.Adam(lr, betas, weight_decay)`` after a
manual ``clip_grad_norm_`` (lightning_model.py:229-248, 323-341); the JAX
package emulates it with the optax chain clip_by_global_norm ->
add_decayed_weights -> scale_by_adam(eps=1e-8) -> scale(-lr). This module
computes that chain's arithmetic in its order, so the port lands where the
JAX step lands:

- the global norm over all gradients, and a scale by ``max_norm / norm``
  only when ``norm >= max_norm``, as ``(g / norm) * max_norm`` with no
  ``+ 1e-6`` (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
  and scales whenever the norm is above the limit, so it is not used);
- coupled L2 weight decay, ``g + wd * p`` (torch Adam's ``weight_decay``);
- Adam moments ``b * m + (1 - b) * g^k`` with bias corrections
  ``1 - b^t`` in fp32, ``u = m_hat / (sqrt(v_hat) + eps)``, ``p += -lr * u``.

The sums may round differently from optax's (a fused multiply-add, the
global norm as the norm of the tensors' norms): fp32 roundoff.

Everything stays on the device: the clip is a ``torch.where`` on the norm,
with no host synchronisation, and each stage is one multi-tensor
``torch._foreach_*`` call over all of a network's tensors (a handful of
launches a step instead of about nine per tensor).

Under tensor parallelism (``parallel/tp.py``) each rank holds slices of the
sharded parameters: the global norm sums the squared norms of the sharded
gradients over the model group and counts the replicated ones once
(:meth:`Adam.shard_`), so every model rank clips by the whole network's
norm; the rest of the chain is elementwise.

Gradient accumulation (``training.accumulate_grad_batches = k > 1``) wraps
the chain in :class:`MultiSteps`, the counterpart of ``optax.MultiSteps``
(JAX ``train/optim.py:37-39``): the running mean of the micro-steps'
gradients in optax's Welford form, ``acc + (g - acc) / (n + 1)``, and the
whole chain (clip, weight decay, Adam) on that mean at every k-th
micro-step only, so Adam's count advances once every k; in between the
parameters are not touched.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


class Adam:
    def __init__(self, params: Sequence[torch.nn.Parameter], lr: float,
                 betas: Sequence[float] = (0.9, 0.999),
                 weight_decay: float = 0.0, eps: float = 1e-8,
                 clip_norm: Optional[float] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr = float(lr)
        self.b1, self.b2 = (float(b) for b in betas)
        self.weight_decay = float(weight_decay)
        self.eps = float(eps)
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        self.count = 0
        self.mu = [torch.zeros_like(p, memory_format=torch.preserve_format)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, memory_format=torch.preserve_format)
                   for p in self.params]
        self.sharded: Optional[torch.Tensor] = None  # see shard_
        self.shard = None

    def shard_(self, sharded: Sequence[bool], shard) -> None:
        """Tensor parallelism: ``sharded[i]`` says whether parameter i is
        a slice of a sharded one, ``shard`` (a ``parallel.tp.ModelShard``)
        sums the clip's squared norms of those over the model group."""
        dev = self.params[0].device if self.params else "cpu"
        self.sharded = torch.tensor(list(sharded), dtype=torch.bool,
                                    device=dev)
        self.shard = shard

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(grads))
        if self.shard is None:
            return torch.linalg.vector_norm(norms)
        sq = torch.square(norms)
        split = torch.where(self.sharded, sq, 0.0).sum().reshape(1)
        self.shard.comm.all_reduce_(split)
        return torch.sqrt(split[0] + torch.where(self.sharded, 0.0, sq).sum())

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every parameter from its gradient (fp32)."""
        grads = [g.float() for g in grads]
        if self.clip_norm is not None:
            norm = self._global_norm(grads)
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            # (g / norm) * max_norm where the norm reaches the limit
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(norm, self.clip_norm)))
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params,
                                       alpha=self.weight_decay)
        self.count += 1
        # bias corrections in fp32, as optax computes 1 - decay**count
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(
            self.count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(
            self.count))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update, alpha=-self.lr)

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "mu": [m.detach().cpu() for m in self.mu],
                "nu": [v.detach().cpu() for v in self.nu]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if "inner" in state:
            raise ValueError(
                "this optimizer state was written under gradient "
                "accumulation; resume it with the same "
                "training.accumulate_grad_batches")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu,
                            list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k)`` with ``use_grad_mean``: the
    same ``step(grads)`` / ``state_dict`` surface as :class:`Adam`."""

    def __init__(self, inner: Adam, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0       # micro-steps taken into the running mean
        self.gradient_step = 0   # updates applied
        self.acc = [torch.zeros_like(p, memory_format=torch.preserve_format)
                    for p in inner.params]

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return self.inner.params

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Fold one micro-step's gradients into the mean; at the k-th,
        update the parameters from the mean and start a new one."""
        delta = torch._foreach_sub([g.float() for g in grads], self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step == self.every_k - 1:
            self.inner.step(self.acc)
            torch._foreach_zero_(self.acc)
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.every_k

    def state_dict(self) -> Dict[str, object]:
        return {"inner": self.inner.state_dict(), "every_k": self.every_k,
                "mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": [a.detach().cpu() for a in self.acc]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if int(state.get("every_k", 1)) != self.every_k:
            raise ValueError(
                "this optimizer state was written with another "
                "training.accumulate_grad_batches; resume it with the same")
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        for dst, src in zip(self.acc, state["acc"]):
            dst.copy_(src)


def from_config(params: Sequence[torch.nn.Parameter], opt_cfg: dict,
                clip_norm: Optional[float] = None,
                accumulate_steps: int = 1) -> Union[Adam, MultiSteps]:
    """From the config/optimizer/default.yaml per-network schema; with
    ``accumulate_steps > 1`` wrapped in :class:`MultiSteps`."""
    adam = Adam(params, lr=float(opt_cfg["lr"]),
                betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
                weight_decay=float(opt_cfg.get("weight_decay", 0.0)),
                clip_norm=clip_norm)
    return adam if accumulate_steps == 1 else MultiSteps(adam,
                                                         accumulate_steps)
