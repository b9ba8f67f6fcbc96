"""The benchmark's seeded weights: every tensor of a network drawn on the
device from ``--seed`` in one ``torch.randn`` call, then cut and scaled.

Conv weights are He-scaled normals (std sqrt(2 / fan_in)), the head's
1 / sqrt(fan_in) so that tanh sees unit variance; biases are normals of
std 0.1; BatchNorm starts at scale 1, shift 0, running mean 0 and
variance 1. The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from pbench.seeds import stream_seed

State = Dict[str, torch.Tensor]


def draw(specs: List[tuple], seed: int, stream: int,
         device: torch.device) -> State:
    """fp32 tensors of ``specs`` ((name, shape, kind)) on ``device``."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                 stream))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: State = {}
    for (name, shape, kind), part in zip(specs, flat.split(sizes)):
        z = part.view(shape)
        if kind == "conv":
            fan_in = math.prod(shape[1:])
            gain = 1.0 if name.startswith("output.") else 2.0
            t = z * math.sqrt(gain / fan_in)
        elif kind == "bias":
            t = z * 0.1
        elif kind == "bn_weight" or kind == "bn_var":
            t = torch.ones_like(z)
        elif kind == "bn_count":
            t = torch.zeros((), dtype=torch.int64, device=device)
        else:  # bn_bias, bn_mean
            t = torch.zeros_like(z)
        out[name] = t.contiguous()
    return out
