"""The process group, the devices a process owns, and the collectives of
data-parallel training (counterpart of ``patch_toon_tpu/parallel/mesh.py``
and ``dcn.py``).

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

Without a process group, or at world size 1, every collective here is the
identity; without one :func:`rank` and :func:`world` are 0 and 1.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence

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


def check_mesh(parallel: Optional[Dict[str, Any]]) -> None:
    """Tensor parallelism (``parallel.mesh.model != 1``) is not ported."""
    model = int(((parallel or {}).get("mesh") or {}).get("model", 1) or 1)
    if model != 1:
        raise NotImplementedError(
            f"parallel.mesh.model={model}: tensor parallelism "
            "(patch_toon_tpu/parallel/tp.py) is not ported; the port shards "
            "the batch (data parallel) only")


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average each tensor over the ranks, in place: one all-reduce over
    the concatenation of all of them (one per dtype), in the list's order.
    Every rank ends with the same bits. The identity without a process
    group or at world size 1."""
    n = world()
    if n == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the gradient that
    reaches each rank's ``x`` is the sum of every rank's gradient of the
    result. Every rank must call it in the same order."""
    return _AllReduceSum.apply(x)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated on the first axis in
    rank order, on every rank; ``x`` itself without a process group."""
    if not dist.is_initialized() or world() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
