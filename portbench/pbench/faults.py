"""Faults planted in the program's spawned ranks, for the readings that
limits are set from (``control.py``) and for the tests. A spawned rank
imports the program afresh, so the parent's patches do not reach it: the
fault is planted in the rank itself."""

from __future__ import annotations


def rank_without_exchange(device, spec) -> None:
    """A rank whose tensors are not averaged over the ranks (gradients and
    BatchNorm statistics): each steps on its own share."""
    import patch_toon_tpu_torch.parallel.comm as comm
    from pbench.drivers.fit import rank_main

    comm.all_reduce_mean_ = lambda tensors, group=None: None
    rank_main(device, spec)
