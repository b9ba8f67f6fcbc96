#!/usr/bin/env python
"""Write the JAX package's deterministic VGG19-prefix fallback as an .npz.

    python tools/export_vgg_fallback.py [--out PATH]

With ``perception_model.args.path: null`` the JAX package initializes the
VGG19 prefix with ``init_vgg_params(feature_layers)`` (flax init, seed 42,
patch_toon_tpu/models/perception.py:126-154). The PyTorch port has no JAX,
so it reads the same weights from this file, in the ``tools/convert_vgg.py``
layout (``features.<i>.weight`` OIHW, ``features.<i>.bias``), float32. The
default output is the copy committed inside the port
(patch_toon_tpu_torch/models/vgg19_fallback_seed42.npz): the prefix up to
feature 5 (convs 0, 2 and 5), which serves the default ``[0, 3, 5]``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DEFAULT_OUT = REPO / "patch_toon_tpu_torch" / "models" / \
    "vgg19_fallback_seed42.npz"


def export(out: Path, feature_layers=(0, 3, 5)) -> None:
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from patch_toon_tpu.models.perception import init_vgg_params
    from patch_toon_tpu.utils.torch_compat import vgg_params_to_torch

    params = init_vgg_params(list(feature_layers))["params"]
    arrays = {k: np.ascontiguousarray(v, np.float32) for k, v in
              vgg_params_to_torch(params, prefix="features.").items()}
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    print(f"Wrote {sorted(arrays)} to {out}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    export(parser.parse_args().out)


if __name__ == "__main__":
    main()
