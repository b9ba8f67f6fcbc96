#!/usr/bin/env python
"""Export a checkpoint to the reference ``.ckpt`` layout, without jax.

    python tools/export_checkpoint_torch.py RUN/checkpoints/last out.ckpt
    python tools/export_checkpoint_torch.py RUN/checkpoints/last out.ckpt \
        --full-reference-model [--num-classes 40] [--vgg-npz vgg19.npz] \
        [--feature-layers 0 3 5]

The counterpart of ``tools/export_checkpoint.py``, with its arguments and
its output: ``torch.save({"state_dict", "epoch", "global_step"})``, the
Lightning layout the reference's inference loads with ``strict=True``.

- The input is the JAX package's Orbax directory, read by
  ``patch_toon_tpu_torch/utils/orbax.py`` (no jax, orbax, tensorstore or
  zstandard), or a ``.ckpt`` that the port's trainer wrote (it writes those
  where the JAX trainer writes Orbax directories).
- ``generator.*`` under the reference's names, the smoothers' BatchNorm
  counter at twice the step (the reference advances it twice a step), and
  ``discriminator.*`` when the checkpoint has one. The residual blocks, the
  smoothers and the discriminator's layers are counted in the tree, and
  ``norm_layer`` is ``meta.json``'s. (The JAX tool takes the counts from
  ``meta.json`` with defaults of 7 blocks and 3 discriminator layers, so it
  fails on a checkpoint whose ``meta.json`` has no ``discriminator_args``
  and whose discriminator has 2, as ``docs/quality_2000/ours_ckpt/last``.)
  A ``.ckpt`` gives its ``generator.*`` and ``discriminator.*`` as they
  are.
- ``--full-reference-model`` adds ``perception_loss_model.*``: a zero
  VGG19 (features and classifier; ``--num-classes`` picks the custom head)
  with the convs trained against up to ``max(--feature-layers)`` embedded,
  JAX's seed-42 draw (``models/perception.py::init_vgg_state``) or
  ``--vgg-npz``'s. The zeros are about 0.55 GB of fp32.

It is a conversion on the host and touches no device.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from patch_toon_tpu_torch.models.perception import load_vgg_state  # noqa: E402
from patch_toon_tpu_torch.utils import orbax  # noqa: E402
from patch_toon_tpu_torch.utils.weights import (  # noqa: E402
    discriminator_state_from_jax,
    generator_state_from_jax,
)

# torchvision vgg19 ('E' cfg) features: conv index -> (out_ch, in_ch)
VGG19_FEATURE_CONVS = {
    0: (64, 3), 2: (64, 64),
    5: (128, 64), 7: (128, 128),
    10: (256, 128), 12: (256, 256), 14: (256, 256), 16: (256, 256),
    19: (512, 256), 21: (512, 512), 23: (512, 512), 25: (512, 512),
    28: (512, 512), 30: (512, 512), 32: (512, 512), 34: (512, 512),
}


def _zeros(*shape: int) -> torch.Tensor:
    # numpy's zeros are pages the system zeroes on first touch, so a filler
    # that is never written costs no time here
    return torch.from_numpy(np.zeros(shape, np.float32))


def _vgg_filler(num_classes: Optional[int]) -> Dict[str, torch.Tensor]:
    """The reference's whole VGG19 (perception.py:33-52) in zeros: its
    inference never runs it, but its strict load needs every key."""
    sd = {}
    for idx, (o, i) in VGG19_FEATURE_CONVS.items():
        sd[f"model.features.{idx}.weight"] = _zeros(o, i, 3, 3)
        sd[f"model.features.{idx}.bias"] = _zeros(o)
    if num_classes is None:
        dims = [(4096, 512 * 7 * 7), (4096, 4096), (1000, 4096)]
    else:  # the custom head the reference builds under a perception path
        dims = [(4096, 512 * 8 * 8), (4096, 4096), (num_classes, 4096)]
    for li, (o, i) in zip((0, 3, 6), dims):
        sd[f"model.classifier.{li}.weight"] = _zeros(o, i)
        sd[f"model.classifier.{li}.bias"] = _zeros(o)
    sd["mean"] = torch.tensor([0.485, 0.456, 0.406]).reshape(1, 3, 1, 1)
    sd["std"] = torch.tensor([0.229, 0.224, 0.225]).reshape(1, 3, 1, 1)
    return sd


def _count(params: Dict[str, Any], prefix: str) -> int:
    return sum(1 for k in params if k.startswith(prefix))


def _from_orbax(path: Path) -> Dict[str, Any]:
    tree = orbax.read_tree(path, ("g_params", "g_batch_stats", "d_params",
                                  "step"))
    meta = orbax.read_meta(path)
    step = int(np.asarray(tree.get("step", 0)))
    g = tree["g_params"]
    gen = generator_state_from_jax(
        g, tree.get("g_batch_stats", {}),
        resnet_blocks=_count(g, "resnet_"),
        append_smoothers="smoother_conv1" in g,
        norm_layer=meta.get("generator_args", {}).get("norm_layer",
                                                      "instance_norm"))
    if "smoothers.2.num_batches_tracked" in gen:
        gen["smoothers.2.num_batches_tracked"] = torch.tensor(2 * step)
    sd = {f"generator.{k}": v for k, v in gen.items()}
    if "d_params" in tree:
        disc = discriminator_state_from_jax(
            tree["d_params"],
            n_layers=1 + _count(tree["d_params"], "intermediate_"))
        sd.update({f"discriminator.{k}": v for k, v in disc.items()})
    return {"state_dict": sd, "epoch": int(meta.get("epoch", 0)),
            "global_step": step}


def _from_ckpt(path: Path) -> Dict[str, Any]:
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if not (isinstance(ckpt, dict) and any(
            k.startswith("generator.") for k in ckpt.get("state_dict", {}))):
        raise ValueError(f"{path}: not a training checkpoint (expected a "
                         "'state_dict' with 'generator.' keys)")
    sd = {k: v for k, v in ckpt["state_dict"].items()
          if k.startswith(("generator.", "discriminator."))}
    return {"state_dict": sd, "epoch": int(ckpt.get("epoch", 0)),
            "global_step": int(ckpt.get("global_step", 0))}


def export_state(checkpoint, full_reference_model: bool = False,
                 num_classes: Optional[int] = None,
                 vgg_npz: Optional[str] = None,
                 feature_layers: Sequence[int] = (0, 3, 5)
                 ) -> Dict[str, Any]:
    """The reference-layout checkpoint dict of ``checkpoint`` (an Orbax
    directory or a ``.ckpt``), built in memory."""
    path = Path(checkpoint).absolute()
    out = _from_orbax(path) if path.is_dir() else _from_ckpt(path)
    if full_reference_model:
        vsd = _vgg_filler(num_classes)
        for k, v in load_vgg_state(vgg_npz, max(feature_layers)).items():
            k = f"model.{k}"
            assert k in vsd and vsd[k].shape == v.shape, k
            vsd[k] = v
        out["state_dict"].update(
            {f"perception_loss_model.{k}": v for k, v in vsd.items()})
    return out


def save(out: Dict[str, Any], out_path) -> None:
    """``torch.save`` to a temporary name, then moved into place."""
    out_path = Path(out_path)
    tmp = out_path.with_name(f".{out_path.name}.{os.getpid()}.tmp")
    torch.save(out, tmp)
    os.replace(tmp, out_path)
    mb = out_path.stat().st_size / 1e6
    print(f"Exported {len(out['state_dict'])} tensors ({mb:.1f} MB) -> "
          f"{out_path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Export an Orbax directory or a .ckpt to the reference "
        ".ckpt layout (no jax)")
    ap.add_argument("checkpoint", help="Orbax checkpoint dir (.../last) or "
                    "a .ckpt the port's trainer wrote")
    ap.add_argument("output", help="output .ckpt path")
    ap.add_argument("--full-reference-model", action="store_true",
                    help="emit perception_loss_model.* for strict=True "
                         "loads of the full reference model")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="custom VGG classifier head (reference "
                         "perception path mode); omit for torchvision "
                         "layout")
    ap.add_argument("--vgg-npz", default=None,
                    help="embed real VGG19 features from a "
                         "tools/convert_vgg.py .npz")
    ap.add_argument("--feature-layers", type=int, nargs="+",
                    default=[0, 3, 5],
                    help="perception feature layers the run trained with")
    args = ap.parse_args(argv)
    save(export_state(args.checkpoint, args.full_reference_model,
                      args.num_classes, args.vgg_npz, args.feature_layers),
         args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
