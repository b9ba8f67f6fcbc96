#!/usr/bin/env python
"""Flow-advected Gaussian-splat guide channels, with the PyTorch port.

    python tools/gaussian_filter_torch.py --mask-dir MASKS \
        --flow-fwd-dir FLOW_FWD --flow-bwd-dir FLOW_BWD --output-dir OUT \
        --frame-first 1 --frame-last 24 --key-frames 1 11 21 24 \
        [--radius 10] [--sigma 5] [--file-format %03d] [--max-points 1000] \
        [--device cuda|cpu]

The counterpart of ``tools/gaussian_filter.py``, with the same arguments,
keyframe order, advection runs, colours, RGB output and per-frame messages:
Poisson-disk points inside each keyframe's mask (at most ``max_points``,
``ops/poisson.py``), golden-ratio HSV colours, the points advected frame by
frame forward (through the backward-flow files ``(frame - 1).npy``) to the
next keyframe and backward (through the forward-flow files ``frame.npy``)
to the previous one (``ops/advect.py``), and every frame written as its
mask's RGB with the points of its keyframe at or before it splatted on it
(``ops/splat.py``; on the card the kernel ``csrc/splat.cu``). The points and
the splat run on ``--device`` (the card by default).

Masks are ``file_format % frame`` with ``.jpg``, ``.png`` or ``.jpeg``, read
through the port's ``data/io.py``: a PNG by its own codec, a JPEG by Pillow,
so without Pillow (as on a machine with only the card's stack) the masks
must be PNG. Outputs are PNG through the same codec.

The JAX tool pads the points to a power-of-two bucket so that its jitted
programs compile once per bucket; the port runs eagerly and takes the
points as they are (a padding point would be invalid and never drawn, so
the frames are the same).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.data.io import (  # noqa: E402
    decode_rgb_uint8,
    load_luma,
    save_image_uint8,
)
from patch_toon_tpu_torch.ops.advect import advect_points  # noqa: E402
from patch_toon_tpu_torch.ops.poisson import (  # noqa: E402
    golden_ratio_color,
    poisson_disk_sample,
)
from patch_toon_tpu_torch.ops.splat import splat_points  # noqa: E402


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no CUDA device is available "
                           "(pass --device cpu)")
    return dev


class GaussianFilter:
    def __init__(self, mask_dir, flow_fwd_dir, flow_bwd_dir, output_dir,
                 frame_first, frame_last, key_frames, radius, sigma,
                 file_format="%03d", num_workers=None, max_points=1000,
                 seed=0, device="cuda"):
        if not key_frames:
            raise ValueError("key_frames list is empty")
        self.mask_dir = Path(mask_dir)
        self.flow_fwd_dir = Path(flow_fwd_dir)
        self.flow_bwd_dir = Path(flow_bwd_dir)
        self.output_dir = Path(output_dir)
        self.frame_first = int(frame_first)
        self.frame_last = int(frame_last)
        self.key_frames = sorted(int(k) for k in key_frames)
        self.radius = float(radius)
        self.sigma = float(sigma)
        self.file_format = file_format
        self.max_points = int(max_points)
        self.seed = seed
        self.device = _device(device)

        for d in (self.mask_dir, self.flow_fwd_dir, self.flow_bwd_dir):
            if not d.exists():
                raise ValueError(f"Directory does not exist: {d}")
        self.output_dir.mkdir(parents=True, exist_ok=True)

        first_mask = self._read_mask_gray(self.key_frames[0])
        if first_mask is None:
            raise ValueError(
                f"Failed to read initial mask for frame {self.key_frames[0]}")
        self.size = first_mask.shape  # (H, W)

        # per-keyframe, per-frame point sets: pts[k][frame] -> (N,2) (x,y)
        self.pts: Dict[int, Dict[int, np.ndarray]] = {
            k: {} for k in range(len(self.key_frames))}
        self.flow_cache: Dict[Path, np.ndarray] = {}
        # host seconds of the tool's steps: the keyframes' Poisson points,
        # reading flow files, advecting, splatting (upload, splat,
        # readback) and the PNG decode and encode
        self.seconds = {"poisson": 0.0, "flow_read": 0.0, "advect": 0.0,
                        "splat": 0.0, "png": 0.0}

    # ------------------------------------------------------------------

    def _mask_path(self, frame: int) -> Optional[Path]:
        for ext in (".jpg", ".png", ".jpeg"):
            p = self.mask_dir / f"{self.file_format % frame}{ext}"
            if p.exists():
                return p
        return None

    def _read_mask_gray(self, frame: int) -> Optional[np.ndarray]:
        p = self._mask_path(frame)
        return None if p is None else load_luma(p)

    def _get_flow(self, path: Path) -> Optional[np.ndarray]:
        if path not in self.flow_cache:
            if not path.exists():
                return None
            t0 = time.perf_counter()
            self.flow_cache[path] = np.load(str(path))
            self.seconds["flow_read"] += time.perf_counter() - t0
        return self.flow_cache[path]

    def generate_points(self, mask: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        points = poisson_disk_sample(mask, self.radius, seed=self.seed)
        if len(points) > self.max_points:
            rng = np.random.RandomState(self.seed)
            idx = rng.choice(len(points), self.max_points, replace=False)
            points = points[idx]
        self.seconds["poisson"] += time.perf_counter() - t0
        return points

    # ------------------------------------------------------------------

    def _advect_run(self, key_points: np.ndarray, frames, flow_dir: Path,
                    flow_frame_of, store_key: int) -> None:
        """Advect ``key_points`` through consecutive flow files, storing
        the surviving points of each frame in their original order
        (reference gaussian_filter.py:349-401)."""
        pts = torch.from_numpy(key_points.astype(np.float32)).to(self.device)
        valid = torch.ones(len(key_points), dtype=torch.bool,
                           device=self.device)
        for frame in frames:
            flow = self._get_flow(
                flow_dir / f"{self.file_format % flow_frame_of(frame)}.npy")
            if flow is None:
                print(f"Warning: no flow data for frame {frame}")
                break
            t0 = time.perf_counter()
            pts, valid = advect_points(torch.from_numpy(flow).to(
                self.device), pts, valid)
            valid_np = valid.cpu().numpy()
            if valid_np.any():
                self.pts[store_key][frame] = pts.cpu().numpy()[valid_np]
            self.seconds["advect"] += time.perf_counter() - t0
            if not valid_np.any():
                break

    def process(self) -> None:
        print(f"Starting process with {len(self.key_frames)} key frames")
        for k, key_frame in enumerate(self.key_frames):
            mask = self._read_mask_gray(key_frame)
            if mask is None:
                print(f"Warning: skip key frame {key_frame} (no mask)")
                continue
            key_points = self.generate_points(mask)
            if len(key_points) == 0:
                print(f"Warning: skip key frame {key_frame} (no points)")
                continue
            print(f"Key frame {key_frame}: {len(key_points)} points")
            self.pts[k][key_frame] = key_points

            next_key = (self.key_frames[k + 1]
                        if k + 1 < len(self.key_frames) else float("inf"))
            prev_key = self.key_frames[k - 1] if k > 0 else -1

            # forward: key_frame+1 .. min(next_key, frame_last); flow file
            # (frame-1).npy from the *backward*-flow dir (reference :349-374)
            if key_frame < next_key and key_frame < self.frame_last:
                end = min(next_key, self.frame_last + 1)
                self._advect_run(key_points, range(key_frame + 1, int(end)),
                                 self.flow_bwd_dir, lambda f: f - 1, k)

            # backward: key_frame-1 .. max(prev_key, frame_first); flow file
            # frame.npy from the *forward*-flow dir (reference :376-401)
            if key_frame > prev_key and key_frame > self.frame_first:
                start = max(prev_key, self.frame_first - 1)
                self._advect_run(key_points,
                                 range(key_frame - 1, int(start), -1),
                                 self.flow_fwd_dir, lambda f: f, k)

        print("Drawing and saving results...")
        for frame in range(self.frame_first, self.frame_last + 1):
            print(self._process_output_frame(frame))

    def _process_output_frame(self, frame: int) -> str:
        try:
            p = self._mask_path(frame)
            if p is None:
                return f"Warning: No mask found for frame {frame}"
            t0 = time.perf_counter()
            base = decode_rgb_uint8(p).astype(np.float32) / np.float32(255.0)
            self.seconds["png"] += time.perf_counter() - t0

            # nearest keyframe at-or-before this frame (reference :282-291)
            current_key = None
            for key_frame in self.key_frames:
                if key_frame <= frame:
                    current_key = key_frame
                else:
                    break
            output = base
            if current_key is not None:
                k = self.key_frames.index(current_key)
                points = self.pts[k].get(frame)
                if points is not None and len(points) > 0:
                    t0 = time.perf_counter()
                    output = self._render(base, points)
                    self.seconds["splat"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            out_path = self.output_dir / f"{self.file_format % frame}.png"
            save_image_uint8((np.clip(output, 0, 1) * 255).astype(np.uint8),
                             out_path)
            self.seconds["png"] += time.perf_counter() - t0
            return f"Saved frame {frame}"
        except Exception as e:
            return f"Error processing frame {frame}: {e}"

    def _render(self, base: np.ndarray, points: np.ndarray) -> np.ndarray:
        n = len(points)
        # per-index golden-ratio colours (reference get_unique_color,
        # :214-221, called with sequential indices at render time, :296)
        colors = np.asarray([golden_ratio_color(i) for i in range(n)],
                            np.float32).reshape(n, 3)
        dev = self.device
        out = splat_points(
            torch.from_numpy(base).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                points[:, :2], np.float32)).to(dev),
            torch.from_numpy(colors).to(dev),
            torch.ones(n, dtype=torch.bool, device=dev), self.sigma)
        return out.cpu().numpy()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Gaussian splat guide generator (PyTorch port)")
    parser.add_argument("--mask-dir", required=True)
    parser.add_argument("--flow-fwd-dir", required=True)
    parser.add_argument("--flow-bwd-dir", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--frame-first", type=int, required=True)
    parser.add_argument("--frame-last", type=int, required=True)
    parser.add_argument("--key-frames", type=int, nargs="+", required=True)
    parser.add_argument("--radius", type=float, default=10.0)
    parser.add_argument("--sigma", type=float, default=5.0)
    parser.add_argument("--file-format", default="%03d")
    parser.add_argument("--num-workers", type=int, default=None)
    parser.add_argument("--max-points", type=int, default=1000)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the points and the splat "
                        "(cuda or cpu)")
    args = parser.parse_args(argv)
    GaussianFilter(
        mask_dir=args.mask_dir, flow_fwd_dir=args.flow_fwd_dir,
        flow_bwd_dir=args.flow_bwd_dir, output_dir=args.output_dir,
        frame_first=args.frame_first, frame_last=args.frame_last,
        key_frames=args.key_frames, radius=args.radius, sigma=args.sigma,
        file_format=args.file_format, num_workers=args.num_workers,
        max_points=args.max_points, device=args.device,
    ).process()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
