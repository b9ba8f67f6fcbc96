"""The process group, the devices a process owns, the data x model layout
of its ranks, and the collectives of training (counterpart of
``patch_toon_tpu/parallel/mesh.py`` and ``dcn.py``).

JAX runs one SPMD program over a mesh and lets GSPMD insert the gradient
reduction. Here each card is one rank of a ``torch.distributed`` process
group (NCCL on the card, gloo on the CPU) running the same step on its rows
of the global batch, and the step reduces explicitly:

- :func:`all_reduce_mean_` averages a list of tensors over the ranks in one
  collective over their concatenation, in the list's order, so every rank
  gets the same bits;
- :func:`all_reduce_sum` is differentiable: its backward pass all-reduces
  the gradient, so a statistic summed over every rank's rows (BatchNorm's)
  carries the cross-rank terms into each rank's gradient.

Each collective takes a ``group`` (None: the world). A world of
``data x model`` ranks (JAX's ``('data', 'model')`` mesh, ``parallel.mesh.
model``) is laid out by :func:`set_layout`: global rank r is data index
``r // model`` and model index ``r % model``, so the ``model`` ranks of one
data index (a model group: one replica's channel shards,
``parallel/tp.py``) are consecutive and stay inside a process or node; the
ranks of one model index form a data group, over which gradients,
BatchNorm's statistics and metrics are reduced.

Without a process group, or at world size 1, every collective here is the
identity; without one :func:`rank` and :func:`world` are 0 and 1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a rank that waits longer than this for its peers raises instead of hanging
TIMEOUT = timedelta(minutes=10)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def join(address: str, world_size: int, rank_: int,
         backend: Optional[str] = None,
         device: Optional[torch.device] = None) -> None:
    """Join the process group at ``tcp://<address>`` as ``rank_`` of
    ``world_size``; ``backend`` NCCL where a card is available, gloo
    otherwise; ``device``, a card, binds NCCL to it. Idempotent: a process
    already in a group stays in it."""
    if dist.is_initialized():
        return
    if not 0 <= int(rank_) < int(world_size):
        raise ValueError(f"rank {rank_} is not in a world of {world_size}")
    dist.init_process_group(backend or default_backend(),
                            init_method=f"tcp://{address}",
                            world_size=int(world_size), rank=int(rank_),
                            timeout=TIMEOUT, **_bound(device))


def _bound(device: Optional[torch.device]) -> Dict[str, Any]:
    """``init_process_group``'s binding of NCCL to a card."""
    if device is not None and device.type == "cuda":
        return {"device_id": device}
    return {}


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def torchrun_env() -> bool:
    """Whether torchrun (or another launcher that sets its variables)
    started this process."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Optional[torch.device] = None) -> None:
    """Join the cluster (JAX ``parallel/dcn.py::initialize_distributed``).
    Idempotent. With all three arguments: ``tcp://<coordinator_address>``,
    world ``num_processes``, rank ``process_id``. With all three None:
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``). Anything else raises ``ValueError``. ``backend`` and
    ``device`` as :func:`join`'s."""
    if dist.is_initialized():
        return
    given = [coordinator_address, num_processes, process_id]
    if all(v is None for v in given):
        if not torchrun_env():
            raise ValueError(
                "parallel.dcn: coordinator_address, num_processes and "
                "process_id are null and no launcher set RANK, WORLD_SIZE, "
                "MASTER_ADDR and MASTER_PORT (use torchrun, or give all "
                "three)")
        dist.init_process_group(backend or default_backend(),
                                init_method="env://", timeout=TIMEOUT,
                                **_bound(device))
        return
    if any(v is None for v in given):
        raise ValueError(
            "parallel.dcn: give coordinator_address, num_processes and "
            f"process_id together (got {given})")
    join(str(coordinator_address), int(num_processes), int(process_id),
         backend, device)


def local_devices(n: int = -1, cpu: bool = False) -> List[torch.device]:
    """The devices this process drives, ``n`` of them (-1: all). A rank
    that torchrun started with ``LOCAL_WORLD_SIZE > 1`` owns
    ``cuda:LOCAL_RANK`` only; any other process owns every visible card.
    With ``cpu``, ``n`` CPU entries (one for -1), so the sharding logic
    runs on the CPU."""
    n = int(n)
    if n == 0 or n < -1:
        raise ValueError(f"devices={n}: expected -1 or a positive count")
    if cpu:
        return [torch.device("cpu")] * (1 if n == -1 else n)
    if not torch.cuda.is_available():
        raise RuntimeError("asked for CUDA devices and none is available")
    if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1:
        owned = [torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))]
    else:
        owned = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    if n == -1:
        return owned
    if n > len(owned):
        raise ValueError(f"devices={n}: this process owns {len(owned)} "
                         f"card(s) ({', '.join(map(str, owned))})")
    return owned[:n]


def shard_rows(global_batch: int, rank_: int, world_: int) -> slice:
    """The rows of a global batch that ``rank_`` of ``world_`` takes; a
    batch the world does not divide raises ``ValueError`` naming both."""
    if world_ < 1 or global_batch % world_:
        raise ValueError(
            f"training.batch_size={global_batch} is not divisible by the "
            f"world size {world_} (ranks): each rank takes an equal share "
            "of the global batch")
    per = global_batch // world_
    return slice(rank_ * per, (rank_ + 1) * per)


def mesh_model(parallel: Optional[Dict[str, Any]]) -> int:
    """``parallel.mesh.model``, the ranks of a model group (1 when
    absent); a value below 1 raises ``ValueError``."""
    model = int(((parallel or {}).get("mesh") or {}).get("model", 1) or 1)
    if model < 1:
        raise ValueError(f"parallel.mesh.model={model}: expected a positive "
                         "count")
    return model


def check_mesh(devices: int, model: int, owned: int) -> Tuple[int, int]:
    """The (data, model) layout of ``training.devices`` = ``devices`` and
    ``parallel.mesh.model`` = ``model`` over ``owned`` devices, as JAX's
    ``train.py:123-141`` and ``mesh.py::make_mesh`` resolve it:
    ``devices=1`` builds no mesh and ignores ``model`` (one device);
    ``devices=d`` takes d x model devices; -1 takes ``owned // model``.
    A ``model`` that does not divide ``owned`` (at -1), or a layout larger
    than ``owned``, raises ``ValueError`` in JAX's words."""
    if devices == 1:
        return 1, 1
    if devices == -1:
        if owned % model:
            raise ValueError(f"{owned} devices not divisible by "
                             f"model={model}")
        data = owned // model
    else:
        data = devices
    use = data * model
    if use > owned:
        raise ValueError(f"mesh {data}x{model} needs {use} devices, have "
                         f"{owned}")
    return data, model


@dataclass(frozen=True)
class Layout:
    """This rank's place in a world of ``data x model`` ranks (see the
    module's docstring). ``data_group``: the ranks of this model index
    (None: the world, at model 1); ``model_group``: the ranks of this data
    index (None at model 1)."""
    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None


# the layouts set_layout built (by model size) for the process group
# ``world``: dist.new_group is collective, so each is built once
_LAYOUTS: Dict[str, Any] = {"world": None, "built": {}}


def data_layout(tp: Any = None) -> Tuple[int, int, Any]:
    """(data ranks, data index, data group) of this rank: under tensor
    parallelism those of ``tp`` (a ``parallel.tp.ModelShard``, the
    networks' ``tp``), else every rank of the world a data index (group
    None: the world)."""
    if tp is not None:
        return tp.data, tp.data_index, tp.data_group
    return world(), rank(), None


def set_layout(model: int) -> Layout:
    """Lay the world out as ``world // model`` data x ``model`` ranks; ->
    this rank's :class:`Layout` (``parallel.tp.model_shard`` carries it to
    the networks). Collective at model >
    1 (every rank builds every subgroup with ``dist.new_group``, in the
    same order; built once per model size and process group). A world
    that ``model`` does not divide raises ``ValueError``."""
    n, r, model = world(), rank(), int(model)
    if model < 1 or n % model:
        raise ValueError(f"parallel.mesh.model={model} does not divide the "
                         f"world of {n} rank(s)")
    if not dist.is_initialized():
        return Layout()
    if _LAYOUTS["world"] is not dist.group.WORLD:
        _LAYOUTS.update(world=dist.group.WORLD, built={})
    built = _LAYOUTS["built"]
    if model not in built:
        data = n // model
        if model == 1:
            built[model] = Layout(data=n, data_index=r)
        else:
            model_groups = [dist.new_group([j * model + i
                                            for i in range(model)])
                            for j in range(data)]
            data_groups = [dist.new_group([j * model + i
                                           for j in range(data)])
                           for i in range(model)]
            built[model] = Layout(data, model, r // model, r % model,
                                  data_groups[r % model],
                                  model_groups[r // model])
    return built[model]


def group_size(group: Any = None) -> int:
    """The ranks of ``group`` (None: the world, :func:`world`); 1 without
    a process group."""
    if group is None:
        return world()
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     group: Any = None) -> None:
    """Average each tensor over the ranks of ``group`` (None: the world),
    in place: one all-reduce over the concatenation of all of them (one per
    dtype), in the list's order. Every rank ends with the same bits. The
    identity without a process group or over one rank."""
    n = group_size(group)
    if n == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (None: the world),
    differentiable: the gradient that reaches each rank's ``x`` is the sum
    of every rank's gradient of the result. Every rank must call it in the
    same order."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) of ``group`` (None: the world)
    concatenated on the first axis in rank order, on every rank; ``x``
    itself without a process group or over one rank."""
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
