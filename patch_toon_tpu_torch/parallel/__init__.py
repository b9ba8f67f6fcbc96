"""Several devices and processes (counterpart of ``patch_toon_tpu/parallel``):
the process group, the devices a process owns, the collectives of
data-parallel training (``comm``) and a local launcher (``launch``).
Tensor parallelism (JAX ``parallel/tp.py``) is not ported: ``check_mesh``
refuses ``parallel.mesh.model != 1``."""

from patch_toon_tpu_torch.parallel.comm import (
    all_reduce_mean_,
    all_reduce_sum,
    barrier,
    check_mesh,
    gather_rows,
    initialize_distributed,
    join,
    local_devices,
    rank,
    shard_rows,
    world,
)
from patch_toon_tpu_torch.parallel.launch import free_port, spawn

__all__ = [
    "all_reduce_mean_",
    "all_reduce_sum",
    "barrier",
    "check_mesh",
    "free_port",
    "gather_rows",
    "initialize_distributed",
    "join",
    "local_devices",
    "rank",
    "shard_rows",
    "spawn",
    "world",
]
