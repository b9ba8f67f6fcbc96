"""Several devices and processes (counterpart of ``patch_toon_tpu/parallel``):
the process group, the devices a process owns, the data x model layout of
the ranks and the collectives of training (``comm``), a local launcher
(``launch``) and tensor parallelism, conv output channels sharded over a
model group (``tp``, JAX ``parallel/tp.py``)."""

from patch_toon_tpu_torch.parallel.comm import (
    all_reduce_mean_,
    all_reduce_sum,
    barrier,
    check_mesh,
    data_layout,
    gather_rows,
    initialize_distributed,
    join,
    local_devices,
    mesh_model,
    rank,
    set_layout,
    shard_rows,
    world,
)
from patch_toon_tpu_torch.parallel.launch import free_port, spawn

__all__ = [
    "all_reduce_mean_",
    "all_reduce_sum",
    "barrier",
    "check_mesh",
    "data_layout",
    "free_port",
    "gather_rows",
    "initialize_distributed",
    "join",
    "local_devices",
    "mesh_model",
    "rank",
    "set_layout",
    "shard_rows",
    "spawn",
    "world",
]
