"""Network weights: from the JAX trees, and from torch checkpoint files.

``generator_state_from_jax``, ``discriminator_state_from_jax`` and
``vgg_state_from_jax`` are the port's own copies of the name mappings in
``patch_toon_tpu/utils/torch_compat.py`` (flax HWIO kernels -> torch OIHW
weights); ``generator_state_to_jax`` goes the other way (its
``generator_params_from_torch``). A generator built with ``norm_layer``
other than "instance_norm" has each residual block's second conv at
``block.3`` (no norm modules before it). They copy every array:
``np.asarray`` of a tensor aliases its storage, and converted weights must
never share memory with their source.

Given ``shard=(rank, size)``, the converters return that rank's state dict
of a model group of ``size`` (``parallel/tp.py::shard_params_tp``: JAX's
sharding rule, copies of the rank's slices), so a tensor-parallel rank is
fed the numbers a JAX ``shard_params_tp`` tree holds.

``load_generator_state`` reads the two torch layouts that exist: the
reference Lightning ``.ckpt`` (``state_dict`` with a ``generator.`` prefix)
and the ``{"gen": ...}`` layout of the repo's trained checkpoints
(``docs/quality_2000/torch_train.ckpt``). Both load with
``weights_only=True``: no pickled code runs. A directory is the JAX
package's Orbax checkpoint: ``utils/orbax.py`` reads its generator (no
jax) and :func:`generator_state_from_jax` maps it, with the caller's
``norm_layer``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from patch_toon_tpu_torch.parallel.tp import shard_params_tp
from patch_toon_tpu_torch.utils import orbax

Shard = Optional[Tuple[int, int]]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv(out: Dict[str, torch.Tensor], name: str,
          p: Mapping[str, Any]) -> None:
    k = np.array(p["kernel"], copy=True)
    out[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _conv2_index(norm_layer: Any) -> int:
    """A residual block's second conv: ``block.4`` after a norm module,
    ``block.3`` without (JAX ``torch_compat.py:70``)."""
    return 4 if norm_layer in ("instance_norm", "batch_norm") else 3


def generator_state_from_jax(params: Mapping[str, Any],
                             batch_stats: Mapping[str, Any],
                             resnet_blocks: int = 7,
                             append_smoothers: bool = True,
                             norm_layer: Any = "instance_norm",
                             shard: Shard = None,
                             ) -> Dict[str, torch.Tensor]:
    """flax GeneratorJ (params, batch_stats) as numpy -> torch state dict
    (with ``shard``, that rank's)."""
    out: Dict[str, torch.Tensor] = {}
    c2 = _conv2_index(norm_layer)
    _conv(out, "initial_conv.0", params["initial_conv"]["conv"])
    _conv(out, "downsample1.0", params["downsample1"]["conv"])
    _conv(out, "downsample2.0", params["downsample2"]["conv"])
    for i in range(resnet_blocks):
        _conv(out, f"resnet_blocks.{i}.block.1", params[f"resnet_{i}"]["conv1"])
        _conv(out, f"resnet_blocks.{i}.block.{c2}",
              params[f"resnet_{i}"]["conv2"])
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
    return out if shard is None else shard_params_tp(out, *shard)


def _kernel(sd: Mapping[str, Any], name: str) -> Dict[str, np.ndarray]:
    w = np.array(sd[f"{name}.weight"], copy=True)
    out = {"kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))}
    if f"{name}.bias" in sd:
        out["bias"] = np.array(sd[f"{name}.bias"], copy=True)
    return out


def generator_state_to_jax(sd: Mapping[str, Any], resnet_blocks: int = 7,
                           append_smoothers: bool = True,
                           norm_layer: Any = "instance_norm"
                           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Torch GeneratorJ state dict -> flax (params, batch_stats) as numpy
    (torch OIHW weights -> HWIO kernels), the inverse of
    :func:`generator_state_from_jax`."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    c2 = _conv2_index(norm_layer)
    params: Dict[str, Any] = {
        "initial_conv": {"conv": _kernel(sd, "initial_conv.0")},
        "downsample1": {"conv": _kernel(sd, "downsample1.0")},
        "downsample2": {"conv": _kernel(sd, "downsample2.0")},
        "upsample2": {"conv": _kernel(sd, "upsample2.1")},
        "upsample1": {"conv": _kernel(sd, "upsample1.1")},
        "conv11": _kernel(sd, "conv11.0"),
        "output": _kernel(sd, "output.0"),
    }
    for i in range(resnet_blocks):
        params[f"resnet_{i}"] = {
            "conv1": _kernel(sd, f"resnet_blocks.{i}.block.1"),
            "conv2": _kernel(sd, f"resnet_blocks.{i}.block.{c2}")}
    stats: Dict[str, Any] = {}
    if append_smoothers:
        params["smoother_conv1"] = _kernel(sd, "smoothers.0")
        params["smoother_conv2"] = _kernel(sd, "smoothers.3")
        params["smoother_bn"] = {
            "scale": np.array(sd["smoothers.2.weight"], copy=True),
            "bias": np.array(sd["smoothers.2.bias"], copy=True)}
        stats["smoother_bn"] = {
            "mean": np.array(sd["smoothers.2.running_mean"], copy=True),
            "var": np.array(sd["smoothers.2.running_var"], copy=True)}
    return params, stats


def generator_scales_from_jax(quant: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """flax GeneratorJ's ``quant`` collection (``a_scale`` under each
    QuantConv's module path) as numpy -> {path: 0-d fp32 tensor}, the
    paths of ``GeneratorJ.quant_layers`` ("initial_conv/conv", ...,
    "conv11", ...)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for k, v in tree.items():
            if k == "a_scale":
                out[prefix] = _t(np.asarray(v, np.float32)).reshape(())
            elif isinstance(v, Mapping):
                walk(v, f"{prefix}/{k}" if prefix else k)

    walk(quant, "")
    return out


def load_quant_scales(generator, scales: Mapping[str, torch.Tensor]) -> None:
    """Set each w8a8 site's ``a_scale`` (a copy on its weight's device) and
    its ``calibrated`` flag (the scale is positive) from ``scales`` by
    module path; the paths must be the generator's own."""
    layers = generator.quant_layers()
    if set(scales) != set(layers):
        raise ValueError(f"scales for {sorted(scales)}, the generator's "
                         f"sites are {sorted(layers)}")
    positive = (torch.stack([torch.as_tensor(scales[p]).detach().reshape(())
                             .to("cpu", torch.float32) for p in layers])
                > 0).tolist()
    for (path, layer), pos in zip(layers.items(), positive):
        layer.a_scale = torch.as_tensor(scales[path]).detach().to(
            layer.weight.device, torch.float32).reshape(()).clone()
        layer.calibrated = bool(pos)


def discriminator_state_from_jax(params: Mapping[str, Any],
                                 n_layers: int = 3, shard: Shard = None
                                 ) -> Dict[str, torch.Tensor]:
    """flax DiscriminatorN_IN params as numpy -> torch state dict (with
    ``shard``, that rank's)."""
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "initial.0", params["initial"]["conv"])
    for i in range(n_layers - 1):
        _conv(out, f"intermediate.{i}.0", params[f"intermediate_{i}"]["conv"])
    _conv(out, "pre_output.0", params["pre_output"]["conv"])
    _conv(out, "output.0", params["output"])
    return out if shard is None else shard_params_tp(out, *shard)


def vgg_state_from_jax(params: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """flax PerceptualVGG19 params (``features_<i>``) as numpy -> the
    ``features.<i>.weight/bias`` state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        _conv(out, f"features.{int(name.split('_')[1])}", p)
    return out


def load_generator_state(path, norm_layer: Any = None
                         ) -> Dict[str, torch.Tensor]:
    """GeneratorJ state dict from a reference ``.ckpt``, a ``{"gen"}``
    checkpoint or an Orbax directory of the JAX package; raises on any
    other layout. A directory needs ``norm_layer``, the generator's (it
    places each residual block's second conv); the block count and the
    smoothers follow the tree."""
    if os.path.isdir(str(path)):
        if norm_layer is None:
            raise ValueError(f"{path}: an Orbax directory needs the "
                             "generator's norm_layer")
        params, stats = orbax.restore_generator(path)
        blocks = sum(1 for k in params if k.startswith("resnet_"))
        return generator_state_from_jax(
            params, stats, resnet_blocks=blocks,
            append_smoothers="smoother_conv1" in params,
            norm_layer=norm_layer)
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
