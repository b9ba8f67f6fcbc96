"""Temporal-guide serving with flows from files: the warp chain.

Counterpart of ``patch_toon_tpu/infer/temporal.py`` in ``flow_source:
files`` mode: ``_temporal_prep`` (:28-55), the chain's state on the engine
(``_temporal_register`` / ``_temporal_position``, :184-227), ``_chain_step``
(:229-274, its files branch) and ``_process_directory_temporal``
(:276-529, files mode). Frame i's generator input gains ``depth`` channels
holding the previous stylized frame warped by the backward flow
``flow_dir / (file_format % i).npy`` (i -> i-1, written by
``tools/optical_flow.py``); frame 0, a restarted chain and ``flow_dir:
null`` (the broken chain) take the frame's own RGB; a missing flow file
holds the previous output unwarped, with a warning.

The chain is sequential only on the device: frame i+1's input needs frame
i's fp32 composite, which stays on the card, so stream order carries it and
the host dispatches frame i+1 without waiting on a readback. Each frame's
uint8 readback goes through the engine's :class:`GroupPipeline`, so it
overlaps the next frames' compute, and the prefetch threads decode each
frame, read its flow and stage both for upload ahead of the chain.

A flow is rounded to float16 on the host where JAX's ``flow_upload`` rule
says (``auto``: unless ``inference.upload`` resolves to f32, which it does
under precision 32); the warp is fp32 on the device either way.

Not ported yet, and refused by name by the engine: ``flow_source: device``
(the on-device Lucas-Kanade flow), the multi-stream layout (a subdirectory
per video) and watch mode.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from patch_toon_tpu_torch.infer.common import _to_signed_unit
from patch_toon_tpu_torch.ops.flow import warp_image


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


class TemporalChain:
    """The single-stream chain's state and step, mixed into the engine
    (which owns the model, the programs and the temporal settings)."""

    def _temporal_init(self) -> None:
        """The chain's state, kept across calls: the carry (the last
        frame's fp32 composite on the device) and the stream's members."""
        self._temporal_prev: Optional[torch.Tensor] = None
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
                    label: Optional[str] = None):
        """One step of the chain (files mode): the guide from ``carry``
        (the previous frame's fp32 composite, or None) and ``aux`` (this
        frame's flow on the device, or None), then the serving program of
        the engine's mode on the (H, W, C + depth) input.

        fdev (H, W, C) and mask (H, W, 1) on the device -> ((H, W, 3)
        uint8 on the device, the tile boxes ([] in fullframe mode), the
        new carry); nothing is synchronised."""
        prev = carry[0]
        if prev is None or self.temporal_flow_dir is None:
            prev_in, flow_in = None, None  # bootstrap: own RGB
        elif aux is not None:
            prev_in, flow_in = prev, aux
        else:
            self.logger.warning(f"No flow for frame {label}; "
                                "using unwarped previous output")
            prev_in, flow_in = prev, None
        full = _temporal_prep(fdev, prev_in, flow_in, self.temporal_depth)
        u8, out_float, boxes = self._stylize_device(full, mask, boxes)
        return u8, boxes, (out_float, None)
