"""A synthetic sample scene, so that training runs out of the box.

The port's copy of ``tools/make_sample_scene.py``: N frames of a textured
background with moving soft blobs, a "stylized" target (posterized, warm
tint), binary masks and tracking textures, under ``input/``, ``output/``,
``mask/`` and ``tracking/`` as ``001.png``, ``002.png``, ... The same numpy
draws from the same seed give the same pixels; the PNG files are written
by the port's own codec (``native/frameio.py``), so no Pillow is needed.
"""

from __future__ import annotations

import colorsys
from pathlib import Path

import numpy as np

from patch_toon_tpu_torch.native.frameio import encode_png


def _background(rng, h: int, w: int) -> np.ndarray:
    base = rng.random((h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8, 1), np.float32))[:h, :w]
    return img * 0.4 + 0.25


def stylize(frame: np.ndarray) -> np.ndarray:
    """The scene's deterministic "hand stylization": posterize to quarter
    steps, then a warm tint, in [0, 1]."""
    post = np.round(frame * 4) / 4
    tint = np.array([1.15, 0.95, 0.8], np.float32)
    return np.clip(post * tint, 0, 1)


def make_scene(out_dir: str, frames: int = 7, height: int = 270,
               width: int = 480, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    out = Path(out_dir)
    for sub in ("input", "output", "mask", "tracking"):
        (out / sub).mkdir(parents=True, exist_ok=True)

    bg = _background(rng, height, width)
    n_blobs = 5
    centers = rng.random((n_blobs, 2)) * [height * 0.6, width * 0.6] \
        + [height * 0.2, width * 0.2]
    velocity = rng.standard_normal((n_blobs, 2)) * 3.0
    radii = rng.random(n_blobs) * 18 + 14
    colors = np.array([colorsys.hsv_to_rgb((i * 0.618) % 1, 0.7, 0.9)
                       for i in range(n_blobs)], np.float32)

    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    for f in range(frames):
        frame = bg.copy()
        mask = np.zeros((height, width), np.float32)
        track = bg.copy() * 0.2
        for b in range(n_blobs):
            cy, cx = centers[b] + velocity[b] * f
            d2 = (ys - cy) ** 2 + (xs - cx) ** 2
            inside = d2 < radii[b] ** 2
            soft = np.exp(-d2 / (radii[b] ** 2))
            frame = frame * (1 - soft[..., None]) \
                + colors[b] * soft[..., None]
            mask[inside] = 1.0
            # tracking texture: a stable colour block a blob
            track[inside] = colors[(b + 2) % n_blobs]

        name = f"{f + 1:03d}.png"
        encode_png(out / "input" / name,
                   (np.clip(frame, 0, 1) * 255).astype(np.uint8))
        encode_png(out / "output" / name,
                   (stylize(frame) * 255).astype(np.uint8))
        encode_png(out / "mask" / name, (mask * 255).astype(np.uint8))
        encode_png(out / "tracking" / name,
                   (np.clip(track, 0, 1) * 255).astype(np.uint8))
    print(f"Wrote {frames} frames to {out}/(input|output|mask|tracking)")
