"""Tensor parallelism: conv output channels sharded over a model group
(counterpart of ``patch_toon_tpu/parallel/tp.py``).

JAX shards the parameters by :func:`tp_param_sharding`'s rule and lets
GSPMD partition the convs and insert the gathers. Here the rule is the
same, on the port's names and OIHW layout, and the networks' forward does
explicitly what GSPMD does, Megatron's column-parallel pattern on convs
(``models/layers.py::site``):

- a sharded conv takes the whole input through :func:`copy_to_model` (the
  identity; its backward all-reduces the input gradient over the model
  group) and computes its slice of the output channels from its slice of
  the weight, with cuDNN;
- the per-channel ops after it (InstanceNorm + activation through kernel
  B1, ReLU, the smoothers' BatchNorm) run on that slice;
- :func:`gather_from_model` all-gathers the slices into the whole
  channels-last tensor before the next conv, concat or residual add (its
  backward takes this rank's channel slice of the gradient).

Between the two, the replicated layers (any conv whose Cout the size does
not divide: the 1x1 head but at size 3, D's 1-channel output) see the same
tensors on every model rank, so their gradients agree without
communication. Every conv goes through ``site``, so a sharded head is
gathered like any other sharded conv.

:func:`shard_params_tp` gives a rank copies of its slices and
:func:`unshard` puts the whole state dict back together;
:func:`shard_module_` shards a network in place for training and
:func:`gather_whole` is :func:`unshard` across the model group's ranks
(collective). :class:`TurnGroup` runs the ranks of a model group as
threads of one process that take turns, so every rank's share of a
sharded forward runs, one after another, on one device.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

# BatchNorm's buffers: replicated, as JAX's batch_stats
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
Sharding = Dict[str, Optional[int]]


def tp_param_sharding(params: Any, size: int) -> Sharding:
    """JAX's rule (``tp.py:20-37``) on the port's names and OIHW layout:
    {name: 0} for a 4-D weight or a 1-D parameter (bias, BatchNorm scale
    and bias) whose first dim O is at least ``size`` and divisible by it,
    sharded on O; {name: None}, replicated, for everything else (the
    3-channel head but at size 3, D's 1-channel output, BatchNorm's
    buffers).
    ``params``: a module (its parameters) or a state dict."""
    items = params.named_parameters() if isinstance(params, nn.Module) \
        else params.items()
    out: Sharding = {}
    for name, t in items:
        shape = tuple(t.shape)
        split = name.rsplit(".", 1)[-1] not in BUFFERS \
            and len(shape) in (1, 4) and shape[0] >= size \
            and shape[0] % size == 0
        out[name] = 0 if split else None
    return out


def local_slice(t: torch.Tensor, dim: Optional[int], rank: int,
                size: int) -> torch.Tensor:
    """A copy of rank ``rank``'s slice of ``t`` (all of it when ``dim`` is
    None)."""
    t = t.detach()
    if dim is None:
        return t.clone()
    n = t.shape[0] // size
    return t[rank * n:(rank + 1) * n].clone()


def shard_params_tp(source: Any, rank: int, size: int
                    ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s state dict of a model group of ``size`` (JAX
    ``tp.py:40-43``): copies of its slices of the sharded parameters and
    of every other tensor whole. ``source``: a module or a whole state
    dict. Copies, never views: ``np.asarray`` of a tensor aliases its
    storage, and a later in-place update must not reach the source."""
    sd = source.state_dict() if isinstance(source, nn.Module) else source
    rule = tp_param_sharding(source, size)
    return {k: local_slice(v, rule.get(k), rank, size) for k, v in sd.items()}


def unshard(shards: Sequence[Mapping[str, torch.Tensor]],
            sharding: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The whole state dict from the ranks' state dicts, in rank order:
    the sharded entries of ``sharding`` (the whole rule) concatenated on
    dim 0, the others taken from rank 0. The inverse of
    :func:`shard_params_tp`."""
    return {k: torch.cat([s[k].detach() for s in shards])
            if sharding.get(k) == 0 else shards[0][k].detach().clone()
            for k in shards[0]}


_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class DistGroup:
    """The collectives of a ``torch.distributed`` group of ``size``
    ranks."""

    def __init__(self, group: Any, size: int):
        self.group, self.size = group, int(size)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated on dim 0, in rank
        order: one collective into one buffer."""
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single(out, x.contiguous(), group=self.group)
        return out

    def all_reduce_(self, x: torch.Tensor) -> None:
        """The sum over the ranks, in place (``x`` contiguous)."""
        dist.all_reduce(x, group=self.group)


class TurnGroup:
    """The ranks of a model group as threads of one process that take
    turns: rank r runs until its next collective, leaves its tensor there,
    hands the turn to r + 1 and waits until the turn comes back, by which
    time every rank has left its tensor for that call. One rank runs at a
    time, so each rank's share runs in turn on one device, and what the
    ranks share (the kernels' launch counters) is never touched by two at
    once. Forward passes only: autograd runs a backward pass on threads of
    its own. :meth:`run` starts the ranks; :meth:`member` is a rank's
    collectives."""

    TIMEOUT = 600.0  # seconds a rank waits for its turn before it raises

    def __init__(self, size: int):
        self.size = int(size)
        self._cv = threading.Condition()
        self._turn = 0
        self._calls: Dict[int, List[Any]] = {}
        self._reads: Dict[int, int] = {}
        self._count = [0] * self.size
        self._error: Optional[BaseException] = None

    def member(self, rank: int) -> "_TurnMember":
        return _TurnMember(self, rank)

    def _wait_turn(self, rank: int) -> None:
        if not self._cv.wait_for(lambda: self._turn == rank
                                 or self._error is not None, self.TIMEOUT):
            raise TimeoutError(f"TurnGroup: rank {rank} waited "
                               f"{self.TIMEOUT} s for its turn")
        if self._error is not None:
            raise RuntimeError("TurnGroup: another rank failed") \
                from self._error

    def _pass_turn(self, rank: int) -> None:
        self._turn = (rank + 1) % self.size
        self._cv.notify_all()

    def exchange(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        """Leave ``x`` for this rank's next collective and take every
        rank's, in rank order."""
        with self._cv:
            k = self._count[rank]
            self._count[rank] += 1
            self._calls.setdefault(k, [None] * self.size)[rank] = x
            self._pass_turn(rank)
            self._wait_turn(rank)
            parts = self._calls[k]
            self._reads[k] = self._reads.get(k, 0) + 1
            if self._reads[k] == self.size:
                del self._calls[k], self._reads[k]
            return parts

    def run(self, fns: Sequence[Callable[[], Any]]) -> List[Any]:
        """``fns[r]()`` as rank r, one thread each, in turns from rank 0;
        -> their results in rank order. A rank that raises makes every
        other raise too, and the first error is raised here."""
        if len(fns) != self.size:
            raise ValueError(f"TurnGroup of {self.size} ranks given "
                             f"{len(fns)} functions")
        results: List[Any] = [None] * self.size

        def rank_main(r: int) -> None:
            try:
                with self._cv:
                    self._wait_turn(r)
                results[r] = fns[r]()
                with self._cv:
                    self._pass_turn(r)
            except BaseException as e:  # noqa: BLE001 (re-raised by run)
                with self._cv:
                    if self._error is None:
                        self._error = e
                    self._cv.notify_all()

        threads = [threading.Thread(target=rank_main, args=(r,))
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        return results


class _TurnMember:
    """Rank ``rank``'s collectives in a :class:`TurnGroup`; the ranks may
    sit on different devices (each takes the others' tensors to its
    own)."""

    def __init__(self, group: TurnGroup, rank: int):
        self.group, self.rank, self.size = group, rank, group.size

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = self.group.exchange(self.rank, x.contiguous())
        return torch.cat([p.to(x.device) for p in parts])

    def all_reduce_(self, x: torch.Tensor) -> None:
        parts = self.group.exchange(self.rank, x.clone())
        total = parts[0].to(x.device, copy=True)
        for p in parts[1:]:
            total += p.to(x.device)
        x.copy_(total)


class ModelShard:
    """Rank ``rank`` of a model group of ``size`` ranks whose collectives
    are ``comm``'s (a :class:`DistGroup`, or a :class:`TurnGroup`
    member), and of its data group: ``data`` ranks, this one
    ``data_index``, reduced over ``data_group`` (one data rank by
    default). The networks carry it as ``tp``, so the step, BatchNorm and
    the comparison grid read the whole data x model layout from it
    (``parallel.comm.data_layout``)."""

    def __init__(self, rank: int, size: int, comm: Any, data: int = 1,
                 data_index: int = 0, data_group: Any = None):
        self.rank, self.size, self.comm = int(rank), int(size), comm
        self.data, self.data_index = int(data), int(data_index)
        self.data_group = data_group

    def channels(self, c: int) -> slice:
        """This rank's slice of ``c`` whole channels."""
        n = c // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def site(self, conv: nn.Module, x: torch.Tensor,
             post: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """A sharded conv and its per-channel ops: the whole NCHW
        (channels-last) ``x`` in, this rank's channels through ``conv`` (its
        weight slice) and ``post``, the whole output gathered."""
        return gather_from_model(post(conv(copy_to_model(x, self))), self)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the sum of the input gradient over the
    model group (each rank's conv slice gave its share of it)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        nhwc = g.permute(0, 2, 3, 1)
        if not nhwc.is_contiguous():
            nhwc = nhwc.contiguous()
        ctx.shard.comm.all_reduce_(nhwc)
        return nhwc.permute(0, 3, 1, 2), None


class _GatherFromModel(torch.autograd.Function):
    """Forward, the all-gather of the ranks' (N, c, H, W) channel slices
    into the whole (N, m c, H, W) tensor, channels-last: one collective
    into an (m N, H, W, c) buffer, then the interleave copy to (N, H, W,
    m c). Backward, this rank's channel slice of the gradient (a strided
    view)."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, shard: ModelShard) -> torch.Tensor:
        ctx.shard = shard
        n, c, h, w = y.shape
        m = shard.size
        parts = shard.comm.all_gather(y.permute(0, 2, 3, 1).contiguous())
        whole = parts.view(m, n, h, w, c).permute(1, 2, 3, 0, 4).reshape(
            n, h, w, m * c)
        return whole.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g[:, ctx.shard.channels(g.shape[1])], None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` into a sharded conv: the identity, whose backward sums the
    input gradient over the model group."""
    return _CopyToModel.apply(x, shard)


def gather_from_model(y: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The whole channels-last NCHW tensor from every rank's channel slice
    ``y``; the backward hands back this rank's slice of the gradient."""
    return _GatherFromModel.apply(y, shard)


def model_shard(layout: Any) -> Optional[ModelShard]:
    """The :class:`ModelShard` of a ``parallel.comm.Layout`` (its model
    index and group, its data index and group), None at model 1."""
    if layout.model == 1:
        return None
    return ModelShard(layout.model_index, layout.model,
                      DistGroup(layout.model_group, layout.model),
                      layout.data, layout.data_index, layout.data_group)


def _owner(module: nn.Module, name: str):
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    return module.get_submodule(path), leaf


def shard_module_(module: nn.Module, shard: ModelShard) -> Sharding:
    """Shard ``module`` in place for ``shard``'s rank: each parameter that
    the rule shards replaced by a copy of its slice, each conv whose weight
    is sharded marked ``tp_sharded``, and ``shard`` set as the ``tp`` of
    every submodule that has one (the networks' forward then takes the
    sharded path). -> the rule, by whole names (also ``module.
    tp_sharding``)."""
    rule = tp_param_sharding(module, shard.size)
    for name, dim in rule.items():
        if dim is None:
            continue
        owner, leaf = _owner(module, name)
        setattr(owner, leaf, nn.Parameter(local_slice(
            getattr(owner, leaf), dim, shard.rank, shard.size)))
    for name, sub in module.named_modules():
        if isinstance(sub, nn.Conv2d):
            key = f"{name}.weight" if name else "weight"
            sub.tp_sharded = rule.get(key) == 0
        if hasattr(sub, "tp"):
            sub.tp = shard
    module.tp_sharding = rule
    return rule


def gather_whole(tensors: Mapping[str, torch.Tensor],
                 sharding: Mapping[str, Optional[int]],
                 shard: ModelShard) -> Dict[str, torch.Tensor]:
    """:func:`unshard` of every rank's ``tensors``: each sharded entry
    gathered from the model group (collective: every rank of the group
    calls it with the same names in the same order), the others this
    rank's."""
    gathered = {k: shard.comm.all_gather(v.detach().contiguous()).chunk(
        shard.size) for k, v in tensors.items() if sharding.get(k) == 0}
    return unshard([{k: gathered[k][r] if k in gathered else v
                     for k, v in tensors.items()}
                    for r in range(shard.size)], sharding)
