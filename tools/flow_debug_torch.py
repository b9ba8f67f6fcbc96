#!/usr/bin/env python
"""Flow debug overlays with the PyTorch port: arrows showing where pixels
move between frames.

    python tools/flow_debug_torch.py INPUT_DIR FLOW_DIR OUTPUT_DIR \
        [--start 1] [--end N] [--skip 1] [--scale 1.0] [--grid 20]

The counterpart of ``tools/flow_debug.py``, with the same arguments,
console lines and files, and without Pillow or cv2: for each frame pair
(i, i+1) with a flow ``{i:03d}.npy``, ``flow_{i:03d}.png`` shows the flow
as a grid of arrows (cell means of the flow, from each cell's centre, the
colour yellow to red by magnitude, a dot where an arrow would be under a
pixel) over the 50/50 blend of the two frames. The lines and dots are
drawn as Pillow's ``ImageDraw`` draws them at width 1 (coordinates cut to
integers toward zero, Bresenham's walk from the start, both ends drawn,
pixels outside the frame dropped), so the overlays are the JAX tool's
pixel for pixel. Frames are read by the port's codec (8-bit PNG, baseline
JPEG) and the overlays written as PNG by it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.data.io import to_rgb  # noqa: E402
from patch_toon_tpu_torch.native.frameio import (  # noqa: E402
    decode_png,
    encode_png,
)


def sample_flow_grid(flow: np.ndarray, grid: int):
    """Cell means of the flow over grid x grid cells anchored at their
    centres -> (cy, cx, u, v) arrays (JAX ``sample_flow_grid``)."""
    h, w = flow.shape[:2]
    ys = np.arange(grid // 2, h, grid)
    xs = np.arange(grid // 2, w, grid)
    cy, cx, us, vs = [], [], [], []
    for y in ys:
        y0, y1 = max(0, y - grid // 2), min(h, y + grid // 2 + 1)
        for x in xs:
            x0, x1 = max(0, x - grid // 2), min(w, x + grid // 2 + 1)
            cell = flow[y0:y1, x0:x1]
            cy.append(y)
            cx.append(x)
            us.append(float(cell[..., 0].mean()))
            vs.append(float(cell[..., 1].mean()))
    return (np.array(cy), np.array(cx), np.array(us), np.array(vs))


def draw_point(img: np.ndarray, x: int, y: int, color) -> None:
    """One pixel, dropped outside the frame."""
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """A width-1 line from p0 to p1 as Pillow's ``ImageDraw.line`` draws
    it: the float coordinates cut to integers toward zero, then
    Bresenham's walk from p0 over max(|dx|, |dy|) + 1 pixels, both ends
    drawn."""
    x0, y0, x1, y1 = int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1])
    dx, xs = (x0 - x1, -1) if x1 < x0 else (x1 - x0, 1)
    dy, ys = (y0 - y1, -1) if y1 < y0 else (y1 - y0, 1)
    if dx == 0:
        for _ in range(dy + 1):
            draw_point(img, x0, y0, color)
            y0 += ys
    elif dy == 0:
        for _ in range(dx + 1):
            draw_point(img, x0, y0, color)
            x0 += xs
    elif dx > dy:
        e = 2 * dy - dx
        for _ in range(dx + 1):
            draw_point(img, x0, y0, color)
            if e >= 0:
                y0 += ys
                e -= 2 * dx
            e += 2 * dy
            x0 += xs
    else:
        e = 2 * dx - dy
        for _ in range(dy + 1):
            draw_point(img, x0, y0, color)
            if e >= 0:
                x0 += xs
                e -= 2 * dy
            e += 2 * dx
            y0 += ys


def render_flow_overlay(img1: np.ndarray, img2: np.ndarray,
                        flow: np.ndarray, grid: int = 20,
                        scale: float = 1.0) -> np.ndarray:
    """Two RGB uint8 frames and a (H, W, 2) flow -> the overlay (JAX
    ``render_flow_overlay``): arrows from the cell centres spanning the
    cell's mean displacement times ``scale``, heads of two strokes at
    +-150 degrees, yellow (small) to red (large)."""
    out = ((img1.astype(np.uint16) + img2.astype(np.uint16)) // 2
           ).astype(np.uint8)
    cy, cx, us, vs = sample_flow_grid(flow, grid)
    mags = np.hypot(us, vs)
    vmax = max(float(mags.max()), 1e-6)
    for y, x, u, v, m in zip(cy, cx, us, vs, mags):
        dx, dy = u * scale, v * scale
        x1, y1 = x + dx, y + dy
        t = m / vmax
        color = (255, int(round(255 * (1.0 - t * 0.8))), 0)
        draw_line(out, (x, y), (x1, y1), color)
        if m * scale >= 1.0:
            ang = np.arctan2(dy, dx)
            hl = min(6.0, 2.0 + m * scale * 0.25)
            for da in (np.pi * 5 / 6, -np.pi * 5 / 6):
                draw_line(out, (x1, y1), (x1 + hl * np.cos(ang + da),
                                          y1 + hl * np.sin(ang + da)), color)
        else:
            draw_point(out, int(x), int(y), color)
    return out


def _open_frame(input_dir: Path, idx: int) -> Optional[np.ndarray]:
    for ext in (".png", ".jpg", ".jpeg"):
        p = input_dir / f"{idx:03d}{ext}"
        if p.exists():
            return to_rgb(decode_png(p))
    return None


def visualize_pairs(input_dir, flow_dir, output_dir, frame_start=1,
                    frame_end=None, skip_frames=1, flow_scale=1.0,
                    grid_size=20) -> int:
    """Render every (frame, frame+1) overlay in the range; returns the
    count. ``frame_end`` defaults to the largest numbered ``.npy``; a pair
    whose frame, successor or flow file is missing is reported and
    skipped."""
    input_dir, flow_dir = Path(input_dir), Path(flow_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if frame_end is None:
        nums = [int(f.stem) for f in flow_dir.glob("*.npy")
                if f.stem.isdigit()]
        if not nums:
            raise ValueError(f"No flow files found in {flow_dir}")
        frame_end = max(nums)
    done = 0
    for idx in range(frame_start, frame_end + 1, skip_frames):
        a = _open_frame(input_dir, idx)
        b = _open_frame(input_dir, idx + 1)
        fp = flow_dir / f"{idx:03d}.npy"
        if a is None or b is None or not fp.exists():
            print(f"Skipped frame {idx} (missing frame or flow)")
            continue
        overlay = render_flow_overlay(a, b, np.load(str(fp)),
                                      grid=grid_size, scale=flow_scale)
        encode_png(output_dir / f"flow_{idx:03d}.png", overlay)
        done += 1
    print(f"Wrote {done} flow overlays to {output_dir}")
    return done


class FlowDebugVisualizer:
    """The object form of :func:`visualize_pairs` (JAX
    ``FlowDebugVisualizer``)."""

    def __init__(self, input_dir, flow_dir, output_dir, frame_start=1,
                 frame_end=None, skip_frames=1, flow_scale=1.0,
                 grid_size=20):
        self.kwargs = dict(
            input_dir=input_dir, flow_dir=flow_dir, output_dir=output_dir,
            frame_start=frame_start, frame_end=frame_end,
            skip_frames=skip_frames, flow_scale=flow_scale,
            grid_size=grid_size)

    def visualize_all(self) -> None:
        visualize_pairs(**self.kwargs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Flow debug overlays (PyTorch port)")
    p.add_argument("input_dir")
    p.add_argument("flow_dir")
    p.add_argument("output_dir")
    p.add_argument("--start", type=int, default=1)
    p.add_argument("--end", type=int)
    p.add_argument("--skip", type=int, default=1)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--grid", type=int, default=20)
    a = p.parse_args(argv)
    visualize_pairs(a.input_dir, a.flow_dir, a.output_dir, a.start, a.end,
                    a.skip, a.scale, a.grid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
