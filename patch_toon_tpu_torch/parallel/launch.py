"""The port's own local launcher: one process a device, each a rank of one
process group.

    spawn(fn, args, devices)

starts ``len(devices)`` processes with ``torch.multiprocessing``'s
``spawn`` start method (a fresh interpreter each: no forked CUDA or thread
state). Local rank ``i`` takes ``devices[i]`` (and makes it the current
card), joins the group at ``tcp://<address>`` (a free localhost port when
none is given) as global rank ``offset + i`` of ``world`` (``len(devices)``
when none is given), then runs ``fn(device, *args)``. A cluster of several
processes that each spawn their local ranks passes the coordinator's
address, its own offset (``process_id x local ranks``) and the whole
world. ``spawn`` returns when every rank has returned, and raises if one
failed; ``fn`` and ``args`` must pickle (a module-level function).
"""

from __future__ import annotations

import socket
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from patch_toon_tpu_torch.parallel.comm import join


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, fn: Callable, args: tuple,
               devices: Sequence[torch.device], address: str, offset: int,
               world_size: int, backend: Optional[str]) -> None:
    device = torch.device(devices[local_rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    join(address, world_size, offset + local_rank,
         backend or ("nccl" if device.type == "cuda" else "gloo"), device)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], args: tuple,
          devices: Sequence[torch.device], address: Optional[str] = None,
          offset: int = 0, world_size: Optional[int] = None,
          backend: Optional[str] = None) -> None:
    """Run ``fn(device, *args)`` in one process per device, each a rank of
    one process group (see the module's docstring)."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("spawn needs at least one device")
    address = address or f"localhost:{free_port()}"
    world_size = len(devices) if world_size is None else int(world_size)
    mp.start_processes(_rank_main,
                       args=(fn, tuple(args), devices, address, int(offset),
                             world_size, backend),
                       nprocs=len(devices), join=True, start_method="spawn")
