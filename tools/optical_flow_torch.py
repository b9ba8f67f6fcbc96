#!/usr/bin/env python
"""Pairwise dense optical flow over a frame directory, with the PyTorch port.

    python tools/optical_flow_torch.py INPUT_DIR MASK_DIR FLOW_FWD_DIR \
        FLOW_BWD_DIR [--format %03d] [--scale 1|2|4] [--device cuda|cpu]

The counterpart of ``tools/optical_flow.py``'s default backend, with the
same arguments, file naming and masking: the forward flow (frame i -> i+1)
goes to ``FLOW_FWD_DIR/{i+1}.npy`` zeroed outside frame i+1's mask, the
backward flow (i -> i-1) to ``FLOW_BWD_DIR/{i}.npy`` zeroed outside frame
i's mask; a mask is ``MASK_DIR/(format % index).jpg`` or ``.png``, tracked
where its luma is above 127, and must exist. Each file is raw float32
(H, W, 2) (dx, dy). The flow is ``patch_toon_tpu_torch.ops.flow.masked_flow``
(pyramidal Lucas-Kanade, ``--scale`` 2 or 4 on a downsampled pyramid) of the
frames' PIL luma over 255, run on ``--device`` (the card by default). The
DIS backend (cv2's code) stays in ``tools/optical_flow.py``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.data.io import list_images, load_luma  # noqa: E402
from patch_toon_tpu_torch.ops.flow import masked_flow  # noqa: E402


class OpticalFlowCalculator:
    def __init__(self, input_dir: Union[str, Path],
                 flow_fwd_dir: Union[str, Path],
                 flow_bwd_dir: Union[str, Path], mask_dir: Union[str, Path],
                 file_format: str = "%03d", scale: int = 1,
                 device: str = "cuda"):
        self.input_dir = Path(input_dir)
        self.flow_fwd_dir = Path(flow_fwd_dir)
        self.flow_bwd_dir = Path(flow_bwd_dir)
        self.mask_dir = Path(mask_dir)
        self.file_format = file_format
        self.scale = int(scale)
        if self.scale not in (1, 2, 4):
            raise ValueError(f"scale={scale!r}: expected 1, 2 or 4")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda and no CUDA device is "
                               "available (pass --device cpu)")
        self.flow_fwd_dir.mkdir(parents=True, exist_ok=True)
        self.flow_bwd_dir.mkdir(parents=True, exist_ok=True)
        self.image_files = self._get_image_files()
        self.grays: Dict[int, torch.Tensor] = {}
        self.masks: Dict[int, torch.Tensor] = {}

    def _get_image_files(self) -> List[Path]:
        files = [self.input_dir / f for f in list_images(self.input_dir)]
        if not files:
            raise ValueError(f"No images found in {self.input_dir}")
        return files

    def _gray(self, index: int) -> torch.Tensor:
        """Frame ``index``'s luma over 255, fp32 on the device (cached)."""
        if index not in self.grays:
            luma = load_luma(self.image_files[index])
            self.grays[index] = torch.from_numpy(luma).to(
                self.device).to(torch.float32) / 255.0
        return self.grays[index]

    def _mask(self, index: int) -> torch.Tensor:
        """Frame ``index``'s mask, bool on the device (cached): luma > 127
        of ``format % index`` with .jpg, else .png."""
        if index not in self.masks:
            path = self.mask_dir / f"{self.file_format % index}.jpg"
            if not path.exists():
                alt = self.mask_dir / f"{self.file_format % index}.png"
                if not alt.exists():
                    raise ValueError(f"Mask file not found: {path}")
                path = alt
            self.masks[index] = torch.from_numpy(
                load_luma(path) > 127).to(self.device)
        return self.masks[index]

    def calculate_direction(self, is_forward: bool = True) -> None:
        n = len(self.image_files)
        if n < 2:
            raise ValueError("Need at least 2 images")
        if is_forward:
            out, pairs = self.flow_fwd_dir, [(i, i + 1, i + 1)
                                             for i in range(n - 1)]
        else:
            out, pairs = self.flow_bwd_dir, [(i, i - 1, i)
                                             for i in range(n - 1, 0, -1)]
        for src, dst, name in pairs:
            flow = masked_flow(self._gray(src), self._gray(dst),
                               self._mask(name), scale=self.scale)
            np.save(str(out / f"{self.file_format % name}.npy"),
                    flow.cpu().numpy().astype(np.float32))
        print(f"{'forward' if is_forward else 'backward'} flow: "
              f"{len(pairs)} files in {out}", flush=True)

    def calculate_flows(self) -> None:
        try:
            self.calculate_direction(is_forward=True)
            self.calculate_direction(is_forward=False)
            print("Flow calculation complete")
        finally:
            self.grays.clear()
            self.masks.clear()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Dense optical flow (PyTorch port)")
    parser.add_argument("input_dir")
    parser.add_argument("mask_dir")
    parser.add_argument("flow_fwd_dir")
    parser.add_argument("flow_bwd_dir")
    parser.add_argument("--format", default="%03d")
    parser.add_argument("--scale", type=int, choices=[1, 2, 4], default=1,
                        help="LK on a downsampled pyramid, displacements "
                        "upsampled (cheaper, sub-pixel lost)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the flow (cuda or cpu)")
    args = parser.parse_args(argv)
    try:
        OpticalFlowCalculator(args.input_dir, args.flow_fwd_dir,
                              args.flow_bwd_dir, args.mask_dir, args.format,
                              scale=args.scale,
                              device=args.device).calculate_flows()
        return 0
    except Exception as e:
        print(f"Error: {e}")
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
