#!/usr/bin/env python
"""Synthetic tracking-texture generator, with the PyTorch port's codec.

    python tools/texture_mapper_torch.py INPUT_DIR [--grid-size 32]

The counterpart of ``tools/texture_mapper.py``, with the same arguments,
colours and messages, and without Pillow: every ``*.png`` of INPUT_DIR
without ``_map`` in its name that is RGBA gets ``<name>_map.png``, its
alpha-covered pixels replaced by a grid of random high-saturation colours
(one hue a cell, ``numpy.random.RandomState``), its alpha kept. PNGs are
read and written by the port's codec (``native/frameio.py``).
"""

from __future__ import annotations

import argparse
import colorsys
import os
import sys
from pathlib import Path
from typing import List

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.native.frameio import (  # noqa: E402
    decode_png,
    encode_png,
)


class ColorGrid:
    def __init__(self, width: int, height: int, grid_size: int):
        self.width = width
        self.height = height
        self.grid_size = max(4, grid_size)
        self.cols = max(1, width // self.grid_size)
        self.rows = max(1, height // self.grid_size)
        self.total_grids = self.rows * self.cols

    def generate_unique_colors(self, seed: int = None) -> List[np.ndarray]:
        """RGB uint8 colours, hues evenly spread then shuffled, s and v in
        [180, 255] (hue in cv2's 0-179)."""
        if self.total_grids == 0:
            raise ValueError("Total number of grids cannot be zero")
        rng = np.random.RandomState(seed)
        hues = np.linspace(0, 179, self.total_grids)
        rng.shuffle(hues)
        sats = rng.randint(180, 256, self.total_grids)
        vals = rng.randint(180, 256, self.total_grids)
        colors = []
        for h, s, v in zip(hues, sats, vals):
            r, g, b = colorsys.hsv_to_rgb(h / 180.0, s / 255.0, v / 255.0)
            colors.append(np.array([r * 255, g * 255, b * 255], np.uint8))
        return colors


def process_texture(input_path: str, output_path: str,
                    grid_size: int = 32, seed: int = None) -> None:
    arr = decode_png(input_path)
    if arr.shape[-1] != 4:
        print(f"Warning: Image {input_path} has no alpha channel")
        return
    alpha = arr[:, :, 3]
    mask = alpha > 0

    grid = ColorGrid(arr.shape[1], arr.shape[0], grid_size)
    colors = grid.generate_unique_colors(seed)

    color_map = np.zeros((arr.shape[0], arr.shape[1], 3), np.uint8)
    for idx, color in enumerate(colors):
        row, col = idx // grid.cols, idx % grid.cols
        y0, y1 = row * grid.grid_size, min((row + 1) * grid.grid_size,
                                           arr.shape[0])
        x0, x1 = col * grid.grid_size, min((col + 1) * grid.grid_size,
                                           arr.shape[1])
        color_map[y0:y1, x0:x1] = color

    result = np.where(mask[..., None], color_map, arr[:, :, :3])
    encode_png(output_path, np.dstack([result, alpha]))
    print(f"Saved texture map to {output_path}")


def process_directory(input_dir: str, grid_size: int = 32) -> None:
    if not os.path.exists(input_dir):
        print(f"Error: Directory {input_dir} does not exist")
        return
    for filename in sorted(os.listdir(input_dir)):
        if filename.lower().endswith(".png") and "_map" not in filename:
            name, ext = os.path.splitext(filename)
            process_texture(os.path.join(input_dir, filename),
                            os.path.join(input_dir, f"{name}_map{ext}"),
                            grid_size)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate texture maps from PNG images with alpha "
                    "(PyTorch port)")
    parser.add_argument("input_dir")
    parser.add_argument("--grid-size", type=int, default=32)
    args = parser.parse_args(argv)
    process_directory(args.input_dir, args.grid_size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
