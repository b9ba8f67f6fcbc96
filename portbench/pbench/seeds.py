"""Seed streams: one ``--seed`` gives each use (weights, scene, sample of
checked answers) a seed of its own, the same on every run of that seed."""

from __future__ import annotations

import numpy as np

WEIGHTS_G, WEIGHTS_D, WEIGHTS_VGG, SCENE, CHECK, CHAIN = 1, 2, 3, 4, 5, 6


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of ``stream`` under ``seed`` (any whole number)."""
    return int(np.random.SeedSequence([int(seed) % 2**64, stream])
               .generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, stream])
