#!/usr/bin/env python
"""Generate a synthetic sample scene with the PyTorch port (no Pillow).

    python tools/make_sample_scene_torch.py OUT_DIR [--frames 7] \
        [--height 270] [--width 480] [--seed 0]

The counterpart of ``tools/make_sample_scene.py``: the same numpy draws
give the same pixels, written by the port's PNG codec
(``patch_toon_tpu_torch/data/sample_scene.py``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.data.sample_scene import make_scene  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Synthetic sample scene")
    parser.add_argument("out_dir")
    parser.add_argument("--frames", type=int, default=7)
    parser.add_argument("--height", type=int, default=270)
    parser.add_argument("--width", type=int, default=480)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    make_scene(args.out_dir, args.frames, args.height, args.width, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
