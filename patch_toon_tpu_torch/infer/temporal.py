"""The temporal guide chain: the warp prologue, the on-device flow, the chain.

Counterpart of ``patch_toon_tpu/infer/temporal.py``: ``_temporal_prep``
(:28-55), ``_temporal_device_flow`` (:57-91), ``_device_gray`` (:93-98),
the chain's state on the engine (``_temporal_register`` /
``_temporal_position``, :184-227), ``_chain_step`` (:229-274) and, in
``infer/engine.py``, ``_process_directory_temporal`` (:276-529). Frame i's
generator input gains ``depth`` channels holding the previous stylized
frame warped by the backward flow i -> i-1. That flow comes

- from files (``flow_source: files``): ``flow_dir / (file_format % i).npy``,
  written by ``tools/optical_flow.py`` or ``tools/optical_flow_torch.py``;
  a missing file holds the previous output unwarped, with a warning, and
  ``flow_dir: null`` is the broken chain (every frame its own RGB). A flow
  is rounded to float16 on the host where JAX's ``flow_upload`` rule says
  (``auto``: unless ``inference.upload`` resolves to f32, which it does
  under precision 32); the warp is fp32 on the device either way;
- or from the device (``flow_source: device``): pyramidal Lucas-Kanade
  (``ops/flow.py::dense_flow``, ``flow_scale`` 1, 2 or 4) between this
  frame's PIL-exact luma and the previous frame's, which stays on the
  device as the chain's second carry, zeroed outside the frame's raw flow
  mask (> 127; none when the mask is missing): the flow tool's
  ``masked_flow`` on the same bytes. On the card the whole flow step is one
  CUDA graph a frame shape (:class:`FlowGraphs`), the counterpart of JAX's
  one jitted dispatch; ``flow_batch`` > 1 computes the next frames' flows
  ahead by the same graph, bitwise equal to one at a time.

Frame 0 and a restarted chain take the frame's own RGB. The chain is
sequential only on the device: frame i+1's input needs frame i's fp32
composite, which stays on the card, so stream order carries it and the host
dispatches frame i+1 without waiting on a readback.

Not ported yet, and refused by name by the engine: the multi-stream layout
(a subdirectory per video; JAX's ``_temporal_flow_pairs`` serves it) and
watch mode.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from patch_toon_tpu_torch.infer.common import _to_signed_unit
from patch_toon_tpu_torch.ops.flow import dense_flow, pil_gray, warp_image


def _temporal_prep(frame: torch.Tensor, prev: Optional[torch.Tensor],
                   flow: Optional[torch.Tensor], depth: int) -> torch.Tensor:
    """(H, W, C) frame (uint8 or fp32 in [-1, 1]), the previous frame's
    (H, W, 3) fp32 composite or None, its (H, W, 2) backward flow (f16 or
    f32) or None -> the (H, W, C + depth) fp32 generator input: the frame
    in [-1, 1], then the guide: the frame's own RGB (``prev`` None: chain
    start), ``prev`` unwarped (``flow`` None: a missing flow), or ``prev``
    warped by ``flow`` in fp32."""
    fdev = _to_signed_unit(frame)
    if prev is None:
        guide = fdev[..., :3]
    elif flow is None:
        guide = prev
    else:
        guide = warp_image(prev, flow.to(torch.float32))
    return torch.cat([fdev, guide[..., :depth].to(torch.float32)], dim=-1)


def _device_gray(frame: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 PIL luma of an (H, W, C) frame's RGB: the chain's first
    frame, which has no flow yet."""
    return pil_gray(frame[..., :3])


def _temporal_device_flow(frame: torch.Tensor, prev_gray: torch.Tensor,
                          fmask: Optional[torch.Tensor], scale: int = 1):
    """The flow step: this frame's luma and its backward flow against the
    previous frame's luma ``prev_gray`` -> ((H, W, 2) fp32 flow, (H, W)
    uint8 luma). ``fmask`` (H, W) uint8 {0, 1} zeroes the flow outside it;
    None leaves it whole. At ``scale`` 1 this is what the flow tool writes
    to ``flow_bwd/{i}.npy``."""
    gray = pil_gray(frame[..., :3])
    flow = dense_flow(gray.to(torch.float32) / 255.0,
                      prev_gray.to(torch.float32) / 255.0, scale=scale)
    if fmask is not None:
        flow = flow * (fmask.to(torch.float32) > 0.5)[..., None]
    return flow, gray


class _FlowGraph:
    """:func:`_temporal_device_flow` captured once for one frame shape and
    type, scale and mask presence, with static input and output buffers."""

    def __init__(self, frame: torch.Tensor, masked: bool, scale: int):
        dev = frame.device
        h, w = frame.shape[:2]
        self.rgb = torch.zeros((h, w, 3), dtype=frame.dtype, device=dev)
        self.prev = torch.zeros((h, w), dtype=torch.uint8, device=dev)
        self.mask = torch.ones((h, w), dtype=torch.uint8, device=dev) \
            if masked else None
        # a warm-up on a side stream before the capture, as
        # torch.cuda.graphs asks
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _temporal_device_flow(self.rgb, self.prev, self.mask, scale)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # the capture runs on torch's own side stream; "thread_local" lets
        # the prefetch threads go on allocating and copying meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.flow, self.gray = _temporal_device_flow(
                self.rgb, self.prev, self.mask, scale)

    def replay(self, frame, prev_gray, fmask):
        """Copy the inputs in, replay, copy the outputs out: all on the
        current stream, so the replay follows whatever the caller queued
        (the frame's upload wait) and the next replay cannot overwrite an
        output or an input that an earlier step still reads."""
        self.rgb.copy_(frame[..., :3])
        self.prev.copy_(prev_gray)
        if self.mask is not None:
            self.mask.copy_(fmask)
        self.graph.replay()
        return self.flow.clone(), self.gray.clone()


class FlowGraphs:
    """The flow step as the chain runs it. On a CUDA device: one captured
    :class:`_FlowGraph` per (H, W, frame type, scale, masked or not),
    replayed each frame; a failed capture raises. On the CPU:
    :func:`_temporal_device_flow`, eagerly. ``captures`` and ``replays``
    count the graphs made and run."""

    def __init__(self):
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, frame: torch.Tensor, prev_gray: torch.Tensor,
                 fmask: Optional[torch.Tensor], scale: int):
        if frame.device.type != "cuda":
            return _temporal_device_flow(frame, prev_gray, fmask, scale)
        key = (tuple(frame.shape[:2]), frame.dtype, scale, fmask is not None)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _FlowGraph(frame, fmask is not None,
                                                   scale)
            self.captures += 1
        self.replays += 1
        return graph.replay(frame, prev_gray, fmask)


class TemporalChain:
    """The single-stream chain's state and step, mixed into the engine
    (which owns the model, the programs and the temporal settings)."""

    def _temporal_init(self) -> None:
        """The chain's state, kept across calls: the carry (the last
        frame's fp32 composite on the device and, with the device flow,
        its luma) and the stream's members; the flow step's graphs."""
        self._temporal_prev: Optional[torch.Tensor] = None
        self._temporal_prev_gray: Optional[torch.Tensor] = None
        self.flow_graphs = FlowGraphs()
        self._temporal_members_lock = threading.RLock()
        self._temporal_members: set = set()

    def _temporal_register(self, name: str) -> None:
        """Mark a frame as a member of the temporal stream (idempotent)."""
        with self._temporal_members_lock:
            self._temporal_members.add(name)

    def _temporal_position(self, name: str) -> int:
        """A frame's position in the stream: its rank among the sorted
        names of the members known so far (flow files are numbered by
        position, not parsed from names). Registering the frames of a
        directory in sorted order gives frame i the position i."""
        with self._temporal_members_lock:
            self._temporal_members.add(name)
            return sorted(self._temporal_members).index(name)

    def _flow_label(self, position: int) -> str:
        if self.temporal_flow_dir is None:
            return str(position)
        return (f"{position} ({self.temporal_flow_dir}/"
                f"{self.temporal_format % position}.npy)")

    def _chain_step(self, fdev: torch.Tensor, mask: torch.Tensor, boxes,
                    carry, aux: Optional[torch.Tensor] = None,
                    flow_hit=None, label: Optional[str] = None):
        """One step of the chain: the guide from ``carry`` (the previous
        frame's fp32 composite and, with the device flow, its luma; each
        None at a chain's start) and ``aux`` (files: this frame's flow on
        the device; device: its raw flow mask; either may be None), then
        the serving program of the engine's mode on the (H, W, C + depth)
        input. ``flow_hit``: this frame's (flow, luma), computed ahead by a
        lookahead window.

        fdev (H, W, C) and mask (H, W, 1) on the device -> ((H, W, 3)
        uint8 on the device, the tile boxes ([] in fullframe mode), the
        new carry); nothing is synchronised."""
        prev, prev_gray = carry
        gray = None
        if self.temporal_flow_source == "device":
            if prev is not None and prev_gray is not None:
                if flow_hit is not None:
                    flow_in, gray = flow_hit
                else:
                    with self.spans("host/flow"):
                        flow_in, gray = self.flow_graphs(
                            fdev, prev_gray, aux, self.temporal_flow_scale)
                prev_in = prev
            else:  # chain start: the window may hold this frame's luma
                if flow_hit is not None:
                    gray = flow_hit[1]
                else:
                    with self.spans("host/flow"):
                        gray = _device_gray(fdev)
                prev_in, flow_in = None, None
        elif prev is None or self.temporal_flow_dir is None:
            prev_in, flow_in = None, None  # bootstrap: own RGB
        elif aux is not None:
            prev_in, flow_in = prev, aux
        else:
            self.logger.warning(f"No flow for frame {label}; "
                                "using unwarped previous output")
            prev_in, flow_in = prev, None
        full = _temporal_prep(fdev, prev_in, flow_in, self.temporal_depth)
        u8, out_float, boxes = self._stylize_device(full, mask, boxes)
        return u8, boxes, (out_float, gray)
