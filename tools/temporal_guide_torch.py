#!/usr/bin/env python
"""Temporal-guide training channels with the PyTorch port: each frame's
guide is the previous stylized frame warped to its geometry.

    python tools/temporal_guide_torch.py INPUT_DIR OUTPUT_DIR FLOW_BWD_DIR \
        OUT_DIR [--file-format %03d] [--device cuda|cpu]

The counterpart of ``tools/temporal_guide.py``: for frame i of the sorted
stylized frames in OUTPUT_DIR, the guide is ``warp(output[i-1],
flow_bwd[i])`` (``ops/flow.py::warp_image``, bilinear, clamped), rounded
half to even and clipped to uint8 as the JAX tool rounds it; frame 0 takes
its own input RGB (or the stylized frame where the input is missing), and a
frame without a flow file copies the previous frame. The warp runs on
``--device`` (the card by default). Frames are read and written through the
port's ``data/io.py`` (PNG by its own codec; a JPEG needs Pillow).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.data.io import (  # noqa: E402
    decode_rgb_uint8,
    save_image_uint8,
)
from patch_toon_tpu_torch.ops.flow import warp_image  # noqa: E402


def build_temporal_guides(input_dir: str, output_dir: str, flow_bwd_dir: str,
                          out_dir: str, file_format: str = "%03d",
                          device: str = "cuda") -> int:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no CUDA device is available "
                           "(pass --device cpu)")
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    flow_bwd_dir, out = Path(flow_bwd_dir), Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    frames = sorted(p for p in output_dir.iterdir()
                    if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if not frames:
        raise ValueError(f"No stylized frames in {output_dir}")

    written = 0
    for i, frame_path in enumerate(frames):
        if i == 0:
            src = input_dir / frame_path.name
            guide = decode_rgb_uint8(src if src.exists() else frame_path)
        else:
            prev = decode_rgb_uint8(frames[i - 1]).astype(np.float32)
            flow_path = flow_bwd_dir / f"{file_format % i}.npy"
            if flow_path.exists():
                flow = torch.from_numpy(np.load(str(flow_path))).to(dev)
                guide = warp_image(torch.from_numpy(prev).to(dev),
                                   flow).cpu().numpy()
            else:
                print(f"Warning: no flow for frame {i}; copying previous")
                guide = prev
            guide = np.clip(np.round(guide), 0, 255).astype(np.uint8)
        save_image_uint8(guide, out / f"{frame_path.stem}.png")
        written += 1
    print(f"Wrote {written} temporal guides to {out}")
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Temporal-guide channel generator (PyTorch port)")
    parser.add_argument("input_dir",
                        help="original frames (frame-0 bootstrap)")
    parser.add_argument("output_dir", help="stylized keyframes")
    parser.add_argument("flow_bwd_dir", help="backward flow .npy directory")
    parser.add_argument("out_dir", help="guide-channel output directory")
    parser.add_argument("--file-format", default="%03d")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the warp (cuda or cpu)")
    args = parser.parse_args(argv)
    build_temporal_guides(args.input_dir, args.output_dir, args.flow_bwd_dir,
                          args.out_dir, args.file_format, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
