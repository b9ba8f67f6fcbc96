"""StyleTransferModel: the GAN assembled from the config (counterpart of
patch_toon_tpu/train/model.py).

Resolves ``input_channels: auto`` to 3 + the guide channels' depths
(reference lightning_model.py:71-157), validates the guide-channel schema,
builds GeneratorJ, DiscriminatorN_IN and the VGG19 prefix from the same
config dicts, and owns the two optimizers (``init_state``).

Precision ``32`` runs fp32 with TF32 off in cuDNN and in matrix products
(the JAX contract is HIGHEST precision); ``bf16`` runs the networks in
bf16 while InstanceNorm and BatchNorm statistics, the losses and the
optimizer stay fp32, as in JAX. ``training_backends`` sets these flags and
cuDNN's deterministic mode for the length of a run.

Not ported yet, and refused by name: precision ``32_fast``, gradient
accumulation, several devices, the ``parallel.dcn`` cluster and the
profiler trace (``training.profile_dir``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from patch_toon_tpu_torch.config.compose import to_container
from patch_toon_tpu_torch.models.discriminator import DiscriminatorN_IN
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.models.perception import PerceptualVGG19
from patch_toon_tpu_torch.train import optim
from patch_toon_tpu_torch.train.losses import get_criterion
from patch_toon_tpu_torch.train.state import GANTrainState


def calculate_total_channels(additional_channels: Optional[Dict[str, Any]]
                             ) -> int:
    """3 (RGB) + the guide channels' depths (lightning_model.py:71-88)."""
    return 3 + sum(int(c.get("depth", 1)) if isinstance(c, dict) else 1
                   for c in (additional_channels or {}).values())


def validate_additional_channels(additional_channels: Optional[Dict[str, Any]]
                                 ) -> None:
    """Schema validation (reference lightning_model.py:90-115)."""
    for name, cfg in (additional_channels or {}).items():
        if isinstance(cfg, dict):
            if not cfg.get("path"):
                raise ValueError(f"Channel {name}: 'path' is required")
            depth = cfg.get("depth", 1)
            if not isinstance(depth, int) or depth < 1:
                raise ValueError(
                    f"Channel {name}: 'depth' must be a positive integer")


def resolve_dtype(precision: Any) -> torch.dtype:
    p = str(precision)
    if p in ("32_fast", "tf32", "fp32_fast"):
        raise NotImplementedError(
            f"training.precision={precision!r} is not ported yet (32 or bf16)")
    if p in ("bf16", "bfloat16", "16"):
        return torch.bfloat16
    if p in ("32", "fp32", "float32"):
        return torch.float32
    raise ValueError(f"training.precision={precision!r}: expected 32 or bf16")


def check_unported_training_knobs(training: Dict[str, Any],
                                  parallel: Optional[Dict[str, Any]] = None
                                  ) -> None:
    """Raise NotImplementedError naming each training knob that asks for
    what this port does not do yet."""
    resolve_dtype(training.get("precision", 32))
    if int(training.get("accumulate_grad_batches", 1) or 1) != 1:
        raise NotImplementedError(
            "training.accumulate_grad_batches != 1 is not ported yet")
    if int(training.get("devices", 1) or 1) != 1:
        raise NotImplementedError(
            "training.devices != 1 is not ported yet (one GPU)")
    if bool(((parallel or {}).get("dcn") or {}).get("enabled", False)):
        raise NotImplementedError(
            "parallel.dcn.enabled=true is not ported yet (one GPU)")
    if training.get("profile_dir"):
        raise NotImplementedError(
            "training.profile_dir is not ported yet (no profiler trace)")


@contextlib.contextmanager
def training_backends(dtype: torch.dtype):
    """TF32 off at fp32 and cuDNN deterministic with autotuning off, for
    the length of a training run; the previous flags are restored."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved[3:]


class StyleTransferModel:
    """Module definitions and configs; ``init_state`` builds the networks
    and optimizers on a device."""

    def __init__(self, generator_config: Dict[str, Any],
                 discriminator_config: Optional[Dict[str, Any]],
                 training_config: Dict[str, Any],
                 optimizer_config: Dict[str, Any],
                 data_config: Dict[str, Any],
                 perception_loss_config: Optional[Dict[str, Any]] = None,
                 parallel_config: Optional[Dict[str, Any]] = None):
        generator_config = to_container(generator_config)
        discriminator_config = to_container(discriminator_config) \
            if discriminator_config is not None else None
        self.training_config = to_container(training_config)
        self.optimizer_config = to_container(optimizer_config)
        self.data_config = to_container(data_config)
        perception_loss_config = to_container(perception_loss_config) \
            if perception_loss_config else None
        check_unported_training_knobs(self.training_config,
                                      to_container(parallel_config or {}))

        self.additional_channels = \
            self.data_config.get("additional_channels") or {}
        validate_additional_channels(self.additional_channels)
        self.dtype = resolve_dtype(self.training_config.get("precision", 32))
        # fail fast on unknown criteria (lightning_model.py:48-54)
        get_criterion(self.training_config.get("reconstruction_criterion",
                                               "L1Loss"))
        get_criterion(self.training_config.get("adversarial_criterion",
                                               "MSELoss"))

        total = calculate_total_channels(self.additional_channels)
        g_args = dict(generator_config.get("args", {}))
        if g_args.get("input_channels") in ("auto", None):
            g_args["input_channels"] = \
                total if g_args.get("input_channels") == "auto" else 3
        g_args.pop("additional_channels", None)
        if "filters" in g_args:
            g_args["filters"] = list(g_args["filters"])
        self.generator_args = g_args
        self.input_channels = int(g_args["input_channels"])

        self.discriminator_args = None
        if discriminator_config is not None:
            d_args = dict(discriminator_config.get("args", {}))
            if d_args.get("input_channels") in ("auto", None):
                d_args["input_channels"] = \
                    total if d_args.get("input_channels") == "auto" else 3
            d_args.pop("additional_channels", None)
            self.discriminator_args = d_args

        self.perception_args = None
        self.perception_weight = 0.0
        if perception_loss_config:
            self.perception_args = dict(
                perception_loss_config["perception_model"].get("args", {}))
            self.perception_weight = float(perception_loss_config["weight"])

        tc = self.training_config
        self.clip = float(tc.get("gradient_clip_val", 0.5)) \
            if tc.get("use_gradient_clipping", False) else None

    def init_state(self, seed: int = 0, device: Any = "cpu"
                   ) -> GANTrainState:
        """Networks in train mode on ``device`` in channels_last memory
        with fp32 parameters, initialized from ``seed`` on a forked CPU
        generator (the caller's global RNG state is left as it was; the
        JAX package's flax init draws other numbers), and the two
        optimizers."""
        dev = torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            gen = GeneratorJ(**self.generator_args)
            disc = DiscriminatorN_IN(**self.discriminator_args) \
                if self.discriminator_args is not None else None
        perc = None
        if self.perception_args is not None:
            pa = self.perception_args
            perc = PerceptualVGG19(
                feature_layers=tuple(pa.get("feature_layers", (0, 3, 5))),
                use_normalization=bool(pa.get("use_normalization", True)),
                path=pa.get("path"))
        mods = [m.to(dev, memory_format=torch.channels_last) if m is not None
                else None for m in (gen, disc, perc)]
        gen, disc, perc = mods
        gen.train()
        if disc is not None:
            disc.train()
        if perc is not None:
            perc.eval()
        return GANTrainState(
            step=0, generator=gen,
            g_opt=optim.from_config(gen.parameters(),
                                    self.optimizer_config["generator"],
                                    self.clip),
            discriminator=disc,
            d_opt=optim.from_config(disc.parameters(),
                                    self.optimizer_config["discriminator"],
                                    self.clip) if disc is not None else None,
            perception=perc)
