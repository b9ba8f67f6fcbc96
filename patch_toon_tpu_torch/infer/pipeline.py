"""The host<->device pipeline of directory serving.

Counterpart of the JAX engine's ``_GroupPipeline``
(``patch_toon_tpu/infer/engine.py:981-1122``) without its pod and crop
branches, and of the staging half of its ``_load_for_dispatch``
(``:623-667``):

- :class:`PinnedPool` stages frames for upload, on a prefetch thread: a
  buffer of pinned host memory, allocated once per shape and reused, copied
  ``non_blocking`` on the engine's copy stream. A buffer is handed out
  again only after the copy that last read it has completed (its event).
- :class:`GroupPipeline` keeps dispatched groups in flight: each group's
  output is copied to pinned host buffers frame by frame, ``non_blocking``,
  with an event a frame, and a group is drained (each frame's event
  waited on, the frame handed to the asynchronous writer) only when more
  than ``inference.readback_streams + 2`` frames are in flight, so the card
  runs one group while the host dispatches the next.

On the CPU (a device the caller asked for) nothing is pinned or copied:
frames stay host tensors and outputs are read as they are.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patch_toon_tpu_torch.infer.tiling import Box, draw_tile_boxes


@dataclass
class Staged:
    """One frame ready for dispatch: (H, W, C) uint8 and its (H, W, 1)
    mask (uint8 when it is {0, 1}, else fp32) on the engine's device, the
    copies' event (None on the CPU), its tile boxes, its input path and,
    in a temporal chain, its stream position and either its (H, W, 2)
    backward flow (flows from files) or its (H, W) uint8 raw flow mask (the
    device flow); None when missing."""

    frame: torch.Tensor
    mask: torch.Tensor
    ready: Optional[torch.cuda.Event]
    boxes: List[Box]
    path: Path
    position: Optional[int] = None
    flow: Optional[torch.Tensor] = None
    fmask: Optional[torch.Tensor] = None


class PinnedPool:
    """Pinned host buffers of one shape and dtype, each with the event of
    the copy that last used it. ``acquire`` takes the buffer released
    longest ago, after its event has completed, or allocates one when
    every buffer is out; so the pool holds at most as many buffers as were
    ever out at once (the prefetch threads, or the frames in flight)."""

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype):
        self.shape, self.dtype = tuple(shape), dtype
        self._free: Deque[Tuple[torch.Tensor, Any]] = collections.deque()
        self._lock = threading.Lock()
        self.allocated = 0

    def acquire(self) -> torch.Tensor:
        with self._lock:
            item = self._free.popleft() if self._free else None
            if item is None:
                self.allocated += 1
        if item is None:
            return torch.empty(self.shape, dtype=self.dtype, pin_memory=True)
        buf, event = item
        if event is not None:
            event.synchronize()
        return buf

    def release(self, buf: torch.Tensor, event=None) -> None:
        with self._lock:
            self._free.append((buf, event))


class PinnedPools:
    """One :class:`PinnedPool` per (shape, dtype), created at first use;
    the pools of the last ``keep`` keys are kept (a directory's frames
    rarely change shape). A dropped buffer is freed through PyTorch's host
    allocator, which waits for the copies recorded on it."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self._pools: "collections.OrderedDict[Any, PinnedPool]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, shape, dtype: torch.dtype) -> PinnedPool:
        key = (tuple(shape), dtype)
        with self._lock:
            pool = self._pools.get(key)
            if pool is None:
                pool = self._pools[key] = PinnedPool(shape, dtype)
                while len(self._pools) > self.keep:
                    self._pools.popitem(last=False)
            return pool

    def allocated(self) -> int:
        with self._lock:
            return sum(p.allocated for p in self._pools.values())


def stage_upload(parts: Sequence[np.ndarray], device: torch.device,
                 pools: PinnedPools, copy_stream) -> Tuple[torch.Tensor, Any]:
    """The concatenation of ``parts`` along the last axis, on ``device``:
    each part through a pinned buffer of ``pools`` and a ``non_blocking``
    copy on ``copy_stream`` (the calling thread enters the stream itself:
    stream context is per thread), then joined there, so the host never
    interleaves the channels -> (device tensor, the event after the join).
    On the CPU -> (host tensor, None)."""
    hosts = [torch.from_numpy(np.ascontiguousarray(a)) for a in parts]
    if device.type != "cuda":
        return (hosts[0] if len(hosts) == 1 else torch.cat(hosts, -1)), None
    staged = []
    for host in hosts:
        pool = pools(host.shape, host.dtype)
        buf = pool.acquire()
        buf.copy_(host)
        staged.append((pool, buf))
    with torch.cuda.stream(copy_stream):
        devs = [buf.to(device, non_blocking=True) for _, buf in staged]
        dev = devs[0] if len(devs) == 1 else torch.cat(devs, -1)
        event = torch.cuda.Event()
        event.record(copy_stream)
    for pool, buf in staged:
        pool.release(buf, event)
    return dev, event


class _InFlight:
    """A dispatched group: per frame, its output (a pinned host buffer on
    CUDA, else the host tensor), the copy's event and its save path."""

    def __init__(self):
        self.outs: List[torch.Tensor] = []
        self.events: List[Any] = []
        self.paths: List[Path] = []
        self.boxes: List[List[Box]] = []


class GroupPipeline:
    """Dispatch, per-frame readback and bounded drain for directory
    serving. The engine dispatches (``engine.dispatch_staged``); the
    pipeline owns the in-flight window and hands each finished frame to the
    writer. ``submitted`` counts the frames handed over."""

    def __init__(self, engine, writer, output_dir: Path):
        self.e = engine
        self.writer = writer
        self.output_dir = Path(output_dir)
        self.window = engine.readback_streams + 2  # frames, the JAX rule
        self.in_flight: Deque[_InFlight] = collections.deque()
        self.out_pools = PinnedPools()
        self.submitted = 0

    def frames_in_flight(self) -> int:
        return sum(len(g.paths) for g in self.in_flight)

    def dispatch(self, group: Sequence[Staged]) -> None:
        """Run a group (``engine.dispatch_staged``) and :meth:`submit` its
        output."""
        self.submit(group, self.e.dispatch_staged(group))

    def submit(self, group: Sequence[Staged], u8: torch.Tensor) -> None:
        """Queue the readback of a group's (F, H, W, 3) uint8 output on the
        device; then drain the oldest groups while more than ``window``
        frames are in flight, keeping at least this group (JAX
        ``engine.py:1092-1099``)."""
        e = self.e
        g = _InFlight()
        with e.spans("host/readback_issue"):
            for k, staged in enumerate(group):
                if u8.device.type == "cuda":
                    pool = self.out_pools(u8.shape[1:], torch.uint8)
                    buf = pool.acquire()
                    buf.copy_(u8[k], non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    g.outs.append(buf)
                    g.events.append((pool, event))
                else:
                    g.outs.append(u8[k])
                    g.events.append(None)
                g.paths.append(self.output_dir / staged.path.name)
                g.boxes.append(staged.boxes)
        self.in_flight.append(g)
        while self.frames_in_flight() > self.window \
                and len(self.in_flight) > 1:
            try:
                self.drain_one()
            except Exception as err:
                # a deferred device error belongs to the drained group
                # (already popped), not to the group just dispatched
                e.logger.error(f"Readback failed: {err}")

    def drain_one(self) -> None:
        """Wait for the oldest group's frames and hand each to the writer.
        One frame's failure does not drop its siblings: every failed frame
        is logged by name, then one error names them all."""
        e = self.e
        g = self.in_flight.popleft()
        failed = []
        for out, ev, path, boxes in zip(g.outs, g.events, g.paths, g.boxes):
            try:
                with e.spans("host/readback_wait"):
                    if ev is not None:
                        ev[1].synchronize()
                img = out.numpy()
                with e.spans("host/encode_submit"):
                    self.writer.submit(path, img)
                    self.submitted += 1
                    if e.debug_mode:
                        self.writer.submit(
                            path.with_name(f"debug_{path.name}"),
                            draw_tile_boxes(img, boxes))
            except Exception as err:
                failed.append((path.name, err))
            finally:
                if ev is not None:
                    ev[0].release(out)
        if failed:
            for name, err in failed:
                e.logger.error(f"readback failed for {name}", exc_info=err)
            names = ", ".join(f"{n}: {err!r}" for n, err in failed)
            raise RuntimeError(
                f"readback failed for [{names}]") from failed[0][1]

    def drain_all(self) -> None:
        """Drain every group in flight; a group whose readback fails is
        logged and the rest still drain (they are independent)."""
        while self.in_flight:
            try:
                self.drain_one()
            except Exception as err:
                self.e.logger.error(f"Tail drain failed for a group: {err}")

    def close(self) -> None:
        """Drop the pinned output buffers (after :meth:`drain_all`)."""
        self.out_pools = PinnedPools()
