"""Point advection through saved flow fields (counterpart of
``patch_toon_tpu/ops/advect.py``).

Every tracked point of a frame moves through the flow field in one batch
of tensor ops: a clamped-neighbour bilinear gather of the flow at the
points, the displacement added, and the reference's in-bounds validity
rule (tools/gaussian_filter.py:100-120 and :360-374): a point that leaves
the frame is invalidated and stays where it was, so order and count are
kept. It needs no kernel: one gather over at most ``max_points`` (1,000)
points a frame. The arithmetic is JAX's, in its order, in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sample_flow_bilinear(flow: torch.Tensor,
                         points: torch.Tensor) -> torch.Tensor:
    """Bilinear flow sample at (x, y) points with clamped neighbours.

    flow: (H, W, 2); points: (N, 2) as (x, y). floor, then each corner
    clamped to the frame on its own (tools/gaussian_filter.py:100-120).
    """
    h, w = flow.shape[:2]
    x, y = points[:, 0], points[:, 1]
    ix = torch.floor(x).to(torch.int64)
    iy = torch.floor(y).to(torch.int64)
    s = (x - ix.to(x.dtype))[:, None]
    t = (y - iy.to(y.dtype))[:, None]
    ix0, ix1 = ix.clamp(0, w - 1), (ix + 1).clamp(0, w - 1)
    iy0, iy1 = iy.clamp(0, h - 1), (iy + 1).clamp(0, h - 1)
    return ((1 - s) * (1 - t) * flow[iy0, ix0]
            + s * (1 - t) * flow[iy0, ix1]
            + (1 - s) * t * flow[iy1, ix0]
            + s * t * flow[iy1, ix1])


def _inside(points: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return ((points[:, 0] >= 0) & (points[:, 0] < w)
            & (points[:, 1] >= 0) & (points[:, 1] < h))


def advect_points(flow: torch.Tensor, points: torch.Tensor,
                  valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One advection step, ``p' = p + flow(p)``. flow (H, W, 2) (dx, dy),
    points (N, 2) (x, y), valid (N,) bool. A point out of the frame before
    or after the step is invalidated and kept at its last position.
    -> (points, valid)."""
    h, w = flow.shape[:2]
    moved = points + sample_flow_bilinear(flow, points)
    new_valid = valid & _inside(points, h, w) & _inside(moved, h, w)
    return torch.where(new_valid[:, None], moved, points), new_valid
