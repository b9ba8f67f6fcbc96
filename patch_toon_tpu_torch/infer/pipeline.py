"""The host<->device pipeline of directory serving.

Counterpart of the JAX engine's ``_GroupPipeline``
(``patch_toon_tpu/infer/engine.py:981-1122``) and of the staging half of
its ``_load_for_dispatch`` (``:623-667``):

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
- The readback is cropped as in JAX (``engine.py:1050-1075``): a group
  uploaded as windows (``crop_upload``) reads back each whole window and
  pastes it at its frame's own origin; otherwise, with ``crop_readback``,
  only ``compute_crop_bbox`` of the group's mask supports (or, for the
  multi-stream cycle, of each frame's own) is read back and pasted into
  the input's RGB bytes, which outside the mask's support are the
  composite's output exactly. The boxes are 64-aligned, so a drifting mask
  gives few readback shapes, one pinned pool each.

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

from patch_toon_tpu_torch.infer.common import (
    Bbox,
    compute_crop_bbox,
    unpack_mask,
)
from patch_toon_tpu_torch.infer.tiling import Box, draw_tile_boxes


@dataclass
class Staged:
    """One frame ready for dispatch: (H, W, C) uint8 and its mask on the
    engine's device (bit-packed (ceil(H*W/8),) uint8 under
    ``mask_upload: packed``, else an (H, W, 1) plane: uint8 when it is {0,
    1}, fp32 when not), the copies' event (None on the CPU), its tile
    boxes, its input path and, in a temporal chain, its stream position and
    either its (H, W, 2) backward flow (flows from files) or its raw flow
    mask (the device flow: packed, or an (H, W) uint8 plane); None when
    missing. For the cropped readback: the input's (H, W, 3) uint8 RGB on
    the host, the mask's support box (None: no mask) and the upload window
    (None: the whole frame went up; else ``frame``, ``mask`` and ``boxes``
    are the window's)."""

    frame: torch.Tensor
    mask: torch.Tensor
    ready: Optional[torch.cuda.Event]
    boxes: List[Box]
    path: Path
    position: Optional[int] = None
    flow: Optional[torch.Tensor] = None
    fmask: Optional[torch.Tensor] = None
    rgb: Optional[np.ndarray] = None
    mbox: Optional[Bbox] = None
    cropwin: Optional[Bbox] = None


def stack_masks(group: Sequence[Staged]) -> torch.Tensor:
    """The staged frames' masks as one tensor: (F, ceil(H*W/8)) packed when
    every one is, else (F, H, W, 1) planes (a packed one unpacked on the
    device), fp32 when any is fractional (uint8 otherwise)."""
    masks = [s.mask for s in group]
    if len({m.dim() for m in masks}) > 1:
        masks = [unpack_mask(m, *s.frame.shape[:2])[..., None]
                 if m.dim() == 1 else m for m, s in zip(masks, group)]
    if len({m.dtype for m in masks}) > 1:
        masks = [m.float() for m in masks]
    return torch.stack(masks)


def readback_boxes(engine, group: Sequence[Staged], h: int, w: int,
                   per_frame: bool = False) -> List[Optional[Bbox]]:
    """Each frame's readback box in its (h, w) output, None for the whole
    output: None for an upload-cropped group (the window is read whole);
    with ``crop_readback``, ``compute_crop_bbox`` of the group's mask
    supports, or of each frame's own with ``per_frame`` (the multi-stream
    cycle, JAX ``multistream.py:272-278``). The group's box (or None) is
    kept in ``engine._last_crop``, the upload window for a cropped group
    (JAX ``engine.py:1050-1068``)."""
    if group[0].cropwin is not None:
        engine._last_crop = group[0].cropwin
        return [None] * len(group)
    if not engine.crop_readback:
        if not per_frame:
            engine._last_crop = None
        return [None] * len(group)
    if per_frame:
        return [compute_crop_bbox([s.mbox], h, w) if s.mbox is not None
                else None for s in group]
    bbox = compute_crop_bbox([s.mbox for s in group], h, w)
    engine._last_crop = bbox
    return [bbox] * len(group)


def _paste(s: Staged, img: np.ndarray, box: Optional[Bbox]) -> np.ndarray:
    """A frame's output from what was read back: ``img`` itself when it is
    the whole frame, else the input's RGB bytes with ``img`` pasted at the
    upload window's origin or at the readback box."""
    at = s.cropwin if s.cropwin is not None else box
    if at is None:
        return img
    full = s.rgb.copy()
    full[at[0]:at[1], at[2]:at[3]] = img
    return full


def _frame_boxes(s: Staged) -> List[Box]:
    """The staged frame's tile boxes in full-frame coordinates (the debug
    overlay's)."""
    cw = s.cropwin
    if cw is None:
        return s.boxes
    return [(b[0] + cw[0], b[1] + cw[0], b[2] + cw[2], b[3] + cw[2])
            for b in s.boxes]


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
        self.staged: List[Staged] = []
        self.crops: List[Optional[Bbox]] = []


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

    def submit(self, group: Sequence[Staged], u8: torch.Tensor,
               paths: Optional[Sequence[Path]] = None,
               per_frame: bool = False) -> None:
        """Queue the readback of a group's (F, H, W, 3) uint8 output on the
        device (or of a list of its frames' (H, W, 3) outputs, each on its
        own device), to ``paths`` (``output_dir`` / each input's name when
        None), cropped by :func:`readback_boxes` (``per_frame``: each
        frame's own box); then drain the oldest groups while more than
        ``window`` frames are in flight, keeping at least this group (JAX
        ``engine.py:1092-1099``). Each copy and its event are queued on
        the current stream of the frame's own card."""
        e = self.e
        g = _InFlight()
        with e.spans("host/readback_issue"):
            h, w = u8[0].shape[:2]
            crops = readback_boxes(e, group, h, w, per_frame)
            for k, staged in enumerate(group):
                out = u8[k]
                box = crops[k]
                if box is not None:
                    out = out[box[0]:box[1], box[2]:box[3]].contiguous()
                if out.device.type == "cuda":
                    pool = self.out_pools(out.shape, torch.uint8)
                    buf = pool.acquire()
                    with torch.cuda.device(out.device):
                        buf.copy_(out, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(torch.cuda.current_stream(out.device))
                    g.outs.append(buf)
                    g.events.append((pool, event))
                else:
                    g.outs.append(out)
                    g.events.append(None)
                g.paths.append(self.output_dir / staged.path.name
                               if paths is None else Path(paths[k]))
                g.staged.append(staged)
                g.crops.append(box)
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
        for out, ev, path, staged, box in zip(g.outs, g.events, g.paths,
                                              g.staged, g.crops):
            try:
                with e.spans("host/readback_wait"):
                    if ev is not None:
                        ev[1].synchronize()
                img = _paste(staged, out.numpy(), box)
                with e.spans("host/encode_submit"):
                    self.writer.submit(path, img)
                    self.submitted += 1
                    if e.debug_mode:
                        self.writer.submit(
                            path.with_name(f"debug_{path.name}"),
                            draw_tile_boxes(img, _frame_boxes(staged)))
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
