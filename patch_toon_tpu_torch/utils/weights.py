"""Network weights: from the JAX trees, and from torch checkpoint files.

``generator_state_from_jax``, ``discriminator_state_from_jax`` and
``vgg_state_from_jax`` are the port's own copies of the name mappings in
``patch_toon_tpu/utils/torch_compat.py`` (flax HWIO kernels -> torch OIHW
weights). They copy every array: ``np.asarray`` of a tensor aliases its
storage, and converted weights must never share memory with their source.

``load_generator_state`` reads the two torch layouts that exist: the
reference Lightning ``.ckpt`` (``state_dict`` with a ``generator.`` prefix)
and the ``{"gen": ...}`` layout of the repo's trained checkpoints
(``docs/quality_2000/torch_train.ckpt``). Both load with
``weights_only=True``: no pickled code runs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv(out: Dict[str, torch.Tensor], name: str,
          p: Mapping[str, Any]) -> None:
    k = np.array(p["kernel"], copy=True)
    out[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def generator_state_from_jax(params: Mapping[str, Any],
                             batch_stats: Mapping[str, Any],
                             resnet_blocks: int = 7,
                             append_smoothers: bool = True,
                             ) -> Dict[str, torch.Tensor]:
    """flax GeneratorJ (params, batch_stats) as numpy -> torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "initial_conv.0", params["initial_conv"]["conv"])
    _conv(out, "downsample1.0", params["downsample1"]["conv"])
    _conv(out, "downsample2.0", params["downsample2"]["conv"])
    for i in range(resnet_blocks):
        _conv(out, f"resnet_blocks.{i}.block.1", params[f"resnet_{i}"]["conv1"])
        _conv(out, f"resnet_blocks.{i}.block.4", params[f"resnet_{i}"]["conv2"])
    _conv(out, "upsample2.1", params["upsample2"]["conv"])
    _conv(out, "upsample1.1", params["upsample1"]["conv"])
    _conv(out, "conv11.0", params["conv11"])
    if append_smoothers:
        _conv(out, "smoothers.0", params["smoother_conv1"])
        out["smoothers.2.weight"] = _t(params["smoother_bn"]["scale"])
        out["smoothers.2.bias"] = _t(params["smoother_bn"]["bias"])
        out["smoothers.2.running_mean"] = _t(batch_stats["smoother_bn"]["mean"])
        out["smoothers.2.running_var"] = _t(batch_stats["smoother_bn"]["var"])
        out["smoothers.2.num_batches_tracked"] = torch.tensor(0)
        _conv(out, "smoothers.3", params["smoother_conv2"])
    _conv(out, "output.0", params["output"])
    return out


def discriminator_state_from_jax(params: Mapping[str, Any],
                                 n_layers: int = 3
                                 ) -> Dict[str, torch.Tensor]:
    """flax DiscriminatorN_IN params as numpy -> torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "initial.0", params["initial"]["conv"])
    for i in range(n_layers - 1):
        _conv(out, f"intermediate.{i}.0", params[f"intermediate_{i}"]["conv"])
    _conv(out, "pre_output.0", params["pre_output"]["conv"])
    _conv(out, "output.0", params["output"])
    return out


def vgg_state_from_jax(params: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """flax PerceptualVGG19 params (``features_<i>``) as numpy -> the
    ``features.<i>.weight/bias`` state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        _conv(out, f"features.{int(name.split('_')[1])}", p)
    return out


def load_generator_state(path) -> Dict[str, torch.Tensor]:
    """GeneratorJ state dict from a reference ``.ckpt`` or a ``{"gen"}``
    checkpoint; raises on any other layout."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        pre = "generator."
        sd = {k[len(pre):]: v for k, v in ckpt["state_dict"].items()
              if k.startswith(pre)}
    elif isinstance(ckpt, dict) and "gen" in ckpt:
        sd = dict(ckpt["gen"])
    else:
        raise ValueError(f"{path}: not a generator checkpoint (expected a "
                         "'state_dict' with 'generator.' keys or a 'gen' "
                         "entry)")
    if "initial_conv.0.weight" not in sd:
        raise ValueError(f"{path}: no generator weights found")
    return sd
