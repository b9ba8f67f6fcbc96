#!/usr/bin/env python
"""Guide-channel preprocessing pipeline, with the PyTorch port.

    python tools/process_pipeline_torch.py SCENE_SRC SCENE_OUT \
        [--resize-mode width|scale] [--resize-value 512] \
        [--flow-backend tpu|dis] [--file-format %03d] [--device cuda|cpu]

The counterpart of ``tools/process_pipeline.py``, with the same steps,
directories, messages and flags, and without Pillow or JAX: resize
the scene and extract the masks (``tools/imageprocessor_torch.py``), the
forward and backward flows (``tools/optical_flow_torch.py``), then the
Gaussian-splat guides at radius 10 and sigma 10 and 15
(``tools/gaussian_filter_torch.py``) into ``gauss_r10_s10/`` and
``gauss_r10_s15/``, with keyframes every 10 frames plus the last. The flow
and the splats run on ``--device`` (the card by default); ``--device
cuda`` without a card is an error, never a move to the CPU. The flow
backend ``tpu`` (the default; the name is the JAX tool's) is the port's
Lucas-Kanade, ``ops/flow.py::masked_flow``; ``dis`` is OpenCV's DIS on the
host, which needs OpenCV (``tools/optical_flow_torch.py``).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, Union

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from gaussian_filter_torch import GaussianFilter  # noqa: E402
from imageprocessor_torch import ImageProcessor  # noqa: E402
from optical_flow_torch import OpticalFlowCalculator, dis_flow  # noqa: E402


def process_pipeline(
    input_dir: str,
    output_base_dir: str,
    resize_mode: str = "width",
    resize_value: Union[int, float] = 512,
    flow_backend: str = "tpu",
    file_format: str = "%03d",
    device: str = "cuda",
) -> Dict[str, float]:
    """Run the four steps; returns each step's host seconds: ``decode``,
    ``resize`` and ``encode`` of the resize step, ``flow``, and ``guides``
    (both sigmas), the card's queued work included."""
    if flow_backend not in ("tpu", "dis"):
        raise ValueError(f"Unknown backend {flow_backend!r} (tpu|dis)")
    if flow_backend == "dis":
        dis_flow()  # without OpenCV, refused before any work
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no CUDA device is available "
                           "(pass --device cpu)")

    def synced() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    output_base_dir = Path(output_base_dir)
    input_dir_resized = output_base_dir / "input"
    mask_dir = output_base_dir / "mask"
    flow_fwd_dir = output_base_dir / "flow_fwd"
    flow_bwd_dir = output_base_dir / "flow_bwd"

    print("\n[1/4] Resize scene + extract masks")
    resize = ImageProcessor(
        input_dir=input_dir, output_dir=str(output_base_dir),
        size_mode=resize_mode, size_value=resize_value,
    )
    resize.process_directory()
    seconds = dict(resize.seconds)

    print("\n[2/4] Dense optical flow (fwd+bwd)")
    t0 = synced()
    OpticalFlowCalculator(
        input_dir=str(input_dir_resized),
        flow_fwd_dir=str(flow_fwd_dir),
        flow_bwd_dir=str(flow_bwd_dir),
        mask_dir=str(mask_dir),
        file_format=file_format,
        device=device,
        backend=flow_backend,
    ).calculate_flows()
    seconds["flow"] = synced() - t0

    input_images = sorted(
        p for ext in (".png", ".jpg", ".jpeg")
        for p in input_dir_resized.glob(f"*{ext}"))
    if not input_images:
        raise ValueError(f"No input images found in {input_dir_resized}")

    frame_first, frame_last = 1, len(input_images)
    key_frames = list(range(frame_first, frame_last + 1, 10))
    if frame_last not in key_frames:
        key_frames.append(frame_last)

    t0 = synced()
    for sigma in (10.0, 15.0):
        print(f"\n[3-4/4] Gaussian splat guides (r10_s{int(sigma)})")
        GaussianFilter(
            mask_dir=str(mask_dir),
            flow_fwd_dir=str(flow_fwd_dir),
            flow_bwd_dir=str(flow_bwd_dir),
            output_dir=str(output_base_dir / f"gauss_r10_s{int(sigma)}"),
            frame_first=frame_first, frame_last=frame_last,
            key_frames=key_frames, radius=10.0, sigma=sigma,
            file_format=file_format, device=device,
        ).process()
    seconds["guides"] = synced() - t0

    print(f"\nGuide pipeline finished -> {output_base_dir}")
    return seconds


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Image Processing Pipeline (PyTorch port)")
    parser.add_argument("input_dir")
    parser.add_argument("output_dir")
    parser.add_argument("--resize-mode", choices=["width", "scale"],
                        default="width")
    parser.add_argument("--resize-value", type=float, default=512)
    parser.add_argument("--flow-backend", choices=["tpu", "dis"],
                        default="tpu")
    parser.add_argument("--file-format", default="%03d")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the flow and the splats "
                        "(cuda or cpu)")
    args = parser.parse_args(argv)
    try:
        process_pipeline(
            input_dir=args.input_dir, output_base_dir=args.output_dir,
            resize_mode=args.resize_mode, resize_value=args.resize_value,
            flow_backend=args.flow_backend, file_format=args.file_format,
            device=args.device,
        )
        return 0
    except Exception as e:
        print(f"Error: {e}")
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
