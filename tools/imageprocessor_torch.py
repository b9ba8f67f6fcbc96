#!/usr/bin/env python
"""Scene resize and alpha-mask extraction, with the PyTorch port's codec.

    python tools/imageprocessor_torch.py SCENE_SRC SCENE_OUT \
        [--size-mode width|scale] [--size-value 512]

The counterpart of ``tools/imageprocessor.py``, with the same arguments,
planning, files and console lines, and without Pillow: given a scene with
``input/``, ``output/`` and ``tracking/`` subdirectories, every image is
resized to a target width (height in proportion) or by a scale, with
Pillow's LANCZOS filter (``native/resample.cpp``), and written as a JPEG at
quality 95 under its own file name (``native/jpeg.cpp``: the bytes
Pillow's ``save(format="JPEG", quality=95)`` writes). Companion images take
the size of the input frame of the same stem (a square of the size value
when there is none), and an RGBA input frame gives ``mask/<stem>.jpg``, its
alpha resized the same way and written as RGB. Sizes come from the files'
headers; a file that fails is reported and skipped.

Images are read by the port's codec (8-bit PNG, baseline JPEG, by
signature) and converted to RGB as PIL's ``convert("RGB")`` does
(``data/io.py::to_rgb``); PIL is imported only for a file the codec refuses
by its format. No progress bar: the JAX tool's goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.data.io import to_rgb  # noqa: E402
from patch_toon_tpu_torch.native.frameio import (  # noqa: E402
    Refused,
    decode_png,
    encode_jpeg,
    read_comment,
    pil_open,
    probe,
    resize_lanczos,
)

_IMAGE_EXTS = {".png", ".jpg", ".jpeg"}
_SUBDIRS = ("input", "output", "tracking")  # resized as-is
JPEG_QUALITY = 95


def list_images(directory: Path) -> List[Path]:
    if not directory.exists():
        return []
    return sorted(p for p in directory.iterdir()
                  if p.is_file() and p.suffix.lower() in _IMAGE_EXTS)


def scaled_size(width: int, height: int, size_mode: str,
                size_value: float) -> Tuple[int, int]:
    """Target (w, h): fixed width with proportional height, or a scale."""
    if size_mode == "width":
        tw = int(size_value)
        return tw, int(tw * height / width)
    return int(width * size_value), int(height * size_value)


def image_size(path: Path) -> Tuple[int, int]:
    """(width, height) from the file's header: the codec's, or PIL's for a
    file of neither signature."""
    try:
        w, h, _ = probe(path)
    except Refused as r:
        with pil_open(r) as img:
            return img.size
    return w, h


def build_size_registry(input_files: List[Path], size_mode: str,
                        size_value: float) -> Dict[str, Tuple[int, int]]:
    """stem -> target size, from image headers only (no pixel decode)."""
    registry: Dict[str, Tuple[int, int]] = {}
    for path in input_files:
        try:
            registry[path.stem] = scaled_size(*image_size(path), size_mode,
                                              size_value)
        except Exception as e:
            print(f"Could not read size of {path.name}: {e}")
    return registry


@contextlib.contextmanager
def _timed(seconds: Dict[str, float], key: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0


@dataclass(frozen=True)
class ResizeJob:
    src: Path
    dst: Path                       # JPEG bytes under the source filename
    size: Tuple[int, int]
    mask_dst: Optional[Path] = None  # alpha -> mask JPEG (RGBA inputs only)

    def run(self, seconds: Dict[str, float]) -> None:
        """Decode, resize and encode, adding each step's host seconds to
        ``seconds``."""
        w, h = self.size
        # carried as resize, convert and getchannel carry Pillow's info;
        # a scan of the headers alone, outside the decode step's time
        comment = read_comment(self.src)
        with _timed(seconds, "decode"):
            arr = decode_png(self.src)
        with _timed(seconds, "resize"):
            small = resize_lanczos(to_rgb(arr), w, h)
        with _timed(seconds, "encode"):
            encode_jpeg(self.dst, small, JPEG_QUALITY, comment)
        if self.mask_dst is not None and arr.shape[-1] == 4:
            with _timed(seconds, "resize"):
                alpha = resize_lanczos(arr[..., 3], w, h)
            with _timed(seconds, "encode"):
                encode_jpeg(self.mask_dst, to_rgb(alpha[..., None]),
                            JPEG_QUALITY, comment)


class ImageProcessor:
    """Plans all jobs for the scene, then executes them.
    ``seconds`` holds the host seconds of the decode, resize and JPEG
    encode steps of the last run."""

    def __init__(
        self,
        input_dir: Union[str, Path],
        output_dir: Union[str, Path],
        size_mode: str = "width",
        size_value: float = 512,
    ):
        self.input_dir = Path(input_dir)
        self.output_dir = Path(output_dir)
        self.size_mode = size_mode
        self.size_value = size_value
        self.target_sizes: Dict[str, Tuple[int, int]] = {}
        self.seconds: Dict[str, float] = {}
        for name in _SUBDIRS + ("mask",):
            (self.output_dir / name).mkdir(parents=True, exist_ok=True)

    def _default_size(self) -> Tuple[int, int]:
        # companions with no same-named input frame fall back to a square
        return int(self.size_value), int(self.size_value)

    def plan(self) -> List[ResizeJob]:
        input_files = list_images(self.input_dir / "input")
        self.target_sizes = build_size_registry(
            input_files, self.size_mode, self.size_value)
        jobs: List[ResizeJob] = []
        for subdir in _SUBDIRS:
            for src in list_images(self.input_dir / subdir):
                jobs.append(ResizeJob(
                    src=src,
                    dst=self.output_dir / subdir / src.name,
                    size=self.target_sizes.get(src.stem, self._default_size()),
                    mask_dst=(self.output_dir / "mask" / f"{src.stem}.jpg")
                    if subdir == "input" else None,
                ))
        return jobs

    def process_directory(self) -> None:
        jobs = self.plan()
        if not self.target_sizes:
            print(f"Nothing to do: no images under "
                  f"{self.input_dir / 'input'}")
            return
        failures = 0
        self.seconds = {"decode": 0.0, "resize": 0.0, "encode": 0.0}
        for job in jobs:
            try:
                job.run(self.seconds)
            except Exception as e:
                failures += 1
                print(f"Failed on {job.src.name}: {e}")
        done = len(jobs) - failures
        print(f"Scene resized: {done}/{len(jobs)} images"
              + (f" ({failures} failed)" if failures else ""))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Resize a scene and extract alpha masks (PyTorch port)")
    parser.add_argument("input_dir", help="Scene directory (input/output/tracking)")
    parser.add_argument("output_dir", help="Destination scene directory")
    parser.add_argument("--size-mode", choices=["width", "scale"],
                        default="width")
    parser.add_argument("--size-value", type=float, default=512)
    args = parser.parse_args(argv)
    try:
        ImageProcessor(args.input_dir, args.output_dir, args.size_mode,
                       args.size_value).process_directory()
        return 0
    except Exception as e:
        print(f"Error: {e}")
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
