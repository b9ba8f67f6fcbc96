"""The train state: both networks, the frozen VGG prefix, the optimizers
and the step count (counterpart of patch_toon_tpu/train/state.py).

JAX keeps one immutable pytree; here the modules hold the parameters and
the generator's BatchNorm statistics, the step updates them in place and
bumps ``step`` (micro-steps, under gradient accumulation, as in JAX).
:func:`shard_state_` cuts a state to one rank's shards for tensor
parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from torch import nn

from patch_toon_tpu_torch.parallel.tp import (
    ModelShard,
    local_slice,
    shard_module_,
)
from patch_toon_tpu_torch.train.optim import Adam, MultiSteps

Optimizer = Union[Adam, MultiSteps]


@dataclass
class GANTrainState:
    step: int
    generator: nn.Module
    g_opt: Optimizer
    discriminator: Optional[nn.Module] = None  # None without a discriminator
    d_opt: Optional[Optimizer] = None
    perception: Optional[nn.Module] = None     # frozen, never updated


def shard_state_(state: GANTrainState, shard: ModelShard) -> None:
    """Tensor parallelism: both networks sharded in place for ``shard``'s
    rank (``parallel/tp.py::shard_module_``), and each optimizer's
    parameters, Adam moments and accumulated gradient cut to the same
    slices (Adam is elementwise, so each rank keeps its shards' moments);
    the optimizer's clip learns which parameters are sharded
    (``optim.Adam.shard_``)."""
    for net, opt in ((state.generator, state.g_opt),
                     (state.discriminator, state.d_opt)):
        if net is None:
            continue
        rule = shard_module_(net, shard)
        dims = [rule[n] for n, _ in net.named_parameters()]

        def cut(tensors):
            return [local_slice(t, d, shard.rank, shard.size)
                    for t, d in zip(tensors, dims)]

        inner = getattr(opt, "inner", opt)
        inner.params = list(net.parameters())
        inner.mu, inner.nu = cut(inner.mu), cut(inner.nu)
        if inner is not opt:
            opt.acc = cut(opt.acc)
        inner.shard_([d is not None for d in dims], shard)
