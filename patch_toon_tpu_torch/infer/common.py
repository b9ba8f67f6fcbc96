"""Shared inference helpers: normalization, composite, image listing, and
the host clock of each serving step.

Counterparts of ``patch_toon_tpu/infer/common.py`` (``_to_signed_unit``
:21-34, ``_composite_u8`` :66-75, ``_image_files`` :52-64), with the same
arithmetic in the same order so uint8 outputs agree with the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

from patch_toon_tpu_torch.data.io import SIGNED_UNIT, list_images

_TABLES: Dict[torch.device, torch.Tensor] = {}


def _signed_unit_table(device: torch.device) -> torch.Tensor:
    table = _TABLES.get(device)
    if table is None:
        table = _TABLES[device] = torch.from_numpy(SIGNED_UNIT).to(device)
    return table


def _to_signed_unit(frame: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> fp32 [-1, 1] as /255*2-1 (reference dataset.py:191),
    gathered from :data:`SIGNED_UNIT` so every device gives the host's
    IEEE values: serving follows the JAX package's host arithmetic (its
    dataset's), not its jitted inference program, which is 1 ulp off at
    205 bytes (a uint8 output moves by at most 1 count); float input passes
    through."""
    if frame.dtype == torch.uint8:
        return _signed_unit_table(frame.device)[frame.to(torch.int32)]
    return frame


def _composite_u8(rgb: torch.Tensor, out: torch.Tensor, mask: torch.Tensor):
    """Masked composite, clip and uint8 rounding (reference
    generator.py:562-563 and 643-652). -> (uint8, composited float)."""
    out = rgb * (1.0 - mask) + out * mask
    out = torch.clamp(out, -1.0, 1.0)
    u8 = torch.round(torch.clamp((out + 1.0) * 127.5, 0.0, 255.0)).to(
        torch.uint8)
    return u8, out


def _image_files(directory) -> List[Path]:
    """Sorted image paths (.png/.jpg/.jpeg, any case); [] for a missing
    directory."""
    try:
        return [Path(directory) / f for f in list_images(directory)]
    except (FileNotFoundError, NotADirectoryError):
        return []


class HostSpans:
    """Host seconds and calls of each named serving step, from any thread.

    ``with spans("host/decode"): ...`` adds the block's host-clock time to
    its name and opens a ``torch.profiler`` range of that name, so a trace
    shows the steps of the thread that started the profiler, and these
    sums cover every thread (the profiler records ranges only on its own).
    Costs two clock reads and a lock a block."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.calls[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{name: {"ms": total host ms, "calls": n}}."""
        with self._lock:
            return {k: {"ms": 1e3 * v, "calls": self.calls[k]}
                    for k, v in sorted(self.seconds.items())}
