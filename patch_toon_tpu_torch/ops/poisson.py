"""Bridson Poisson-disk sampling inside a mask (host-side numpy).

The port's own copy of ``patch_toon_tpu/ops/poisson.py`` (numpy only, so
the port imports nothing of the JAX package). It replaces the reference's
numba-JIT kernel (tools/gaussian_filter.py:13-98
``_generate_points_numba``) with plain numpy. Bridson's algorithm is
sequential (each accepted sample changes the acceptance set), runs once a
keyframe in offline preprocessing and takes milliseconds at these sizes,
so it stays on the host. Semantics match the reference: mask threshold
>64, candidate annulus [radius, 2*radius), grid cell = radius/sqrt(2),
5x5-cell neighbour rejection, seeded numpy RNG (legacy
``np.random.RandomState``, like numba's); the same points as the JAX
package's copy, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def poisson_disk_sample(
    mask: np.ndarray,          # (H, W) uint8/float; valid where > 64
    radius: float,
    max_attempts: int = 30,
    seed: int = 0,
) -> np.ndarray:
    """Returns (N, 2) float64 points as (x, y)."""
    rng = np.random.RandomState(seed)
    h, w = mask.shape
    x_min = np.array([0.0, 0.0])
    cell_size = radius / np.sqrt(2)
    grid_size = (int(np.ceil(w / cell_size)), int(np.ceil(h / cell_size)))
    grid = np.full(grid_size, -1, dtype=np.int32)

    ys, xs = np.nonzero(mask > 64)
    if len(ys) == 0:
        return np.empty((0, 2), dtype=np.float64)
    valid_points = np.stack([xs, ys], axis=1).astype(np.float64)

    max_points = int((grid_size[0] * grid_size[1])
                     / (np.pi * (radius / cell_size) ** 2))
    max_points = max(max_points, 1)
    samples = np.empty((max_points, 2), dtype=np.float64)
    active = np.empty(max_points, dtype=np.int32)

    first = valid_points[rng.randint(0, len(valid_points))]
    cell = ((first - x_min) / cell_size).astype(np.int32)
    grid[cell[0], cell[1]] = 0
    samples[0] = first
    active[0] = 0
    num_samples = 1
    num_active = 1

    while num_active > 0:
        idx = rng.randint(0, num_active)
        point = samples[active[idx]]
        found = False
        for _ in range(max_attempts):
            angle = rng.random_sample() * 2 * np.pi
            distance = rng.uniform(radius, 2 * radius)
            candidate = point + distance * np.array(
                [np.cos(angle), np.sin(angle)])
            x, y = int(candidate[0]), int(candidate[1])
            if not (0 <= x < w and 0 <= y < h and mask[y, x] > 64):
                continue
            cell = ((candidate - x_min) / cell_size).astype(np.int32)
            if not (0 <= cell[0] < grid_size[0] and 0 <= cell[1] < grid_size[1]):
                continue
            i0, i1 = max(0, cell[0] - 2), min(grid_size[0], cell[0] + 3)
            j0, j1 = max(0, cell[1] - 2), min(grid_size[1], cell[1] + 3)
            neighbours = grid[i0:i1, j0:j1]
            occupied = neighbours[neighbours != -1]
            if occupied.size and np.any(
                np.sum((samples[occupied] - candidate) ** 2, axis=1)
                < radius ** 2
            ):
                continue
            if num_samples < max_points:
                grid[cell[0], cell[1]] = num_samples
                samples[num_samples] = candidate
                active[num_active] = num_samples
                num_samples += 1
                num_active += 1
                found = True
                break
        if not found:
            active[idx] = active[num_active - 1]
            num_active -= 1

    return samples[:num_samples]


def golden_ratio_color(index: int) -> Tuple[float, float, float]:
    """Stable unique point color: golden-ratio hue walk, HSV(h, 0.8, 0.95)
    (reference tools/gaussian_filter.py:214-221)."""
    from colorsys import hsv_to_rgb

    hue = (index * 0.618033988749895) % 1.0
    return hsv_to_rgb(hue, 0.8, 0.95)
