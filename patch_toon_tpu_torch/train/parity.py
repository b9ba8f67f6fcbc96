"""Holding one training step of the port against a reference.

Used by ``tests/test_torch_train.py`` (the port against JAX on the CPU),
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (the card against the
CPU, :func:`device_step_parity` and its limits in
:func:`assert_device_step_parity`):

- :func:`first_step_agreement` is the rule for one step from the same
  parameters and batch. Adam's first update is ``lr * g / (|g| + 1e-8)``,
  nearly ``lr * sign(g)``, so where a gradient element is below 1e-7 (its
  own roundoff) the update is set by roundoff, and the parameters are held
  only where both gradients reach 1e-7, within the tolerances of
  ``tests/test_train_step.py::test_full_gan_step_parity_vs_torch`` (1.5e-4
  for conv kernels, under the 2 * lr = 8e-4 of a gradient of the other
  sign; 9e-4 otherwise, which lets the biases that feed an InstanceNorm,
  whose gradient is 0 but for roundoff, take either sign); the first-step
  gradients are held in relative L2 norm over the network and over each
  conv kernel.
- :class:`Kinks` records the branch that every ReLU, LeakyReLU and
  InstanceNorm + activation takes in a step, or makes a run take recorded
  branches. :func:`step_witness` uses it to explain where a card's step and
  the CPU's part: an activation input within roundoff of 0 can take the
  other branch on one device, and one such element moves every gradient
  upstream of it (about ``1 / sqrt(elements at the site)`` in relative L2).
  The witness runs the step on the CPU in fp64, once taking the card's
  branches and once the CPU's; each device must then agree with its own
  reference to roundoff, which leaves the branch flips as the whole gap.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from patch_toon_tpu_torch.models import discriminator as _disc
from patch_toon_tpu_torch.models import layers as _layers
from patch_toon_tpu_torch.train import optim
from patch_toon_tpu_torch.train.model import training_backends
from patch_toon_tpu_torch.train.step import make_train_step

TINY = 1e-7  # |first-step gradient| below which Adam's update is roundoff
KERNEL_TOL, OTHER_TOL = 1.5e-4, 9e-4


def first_step_agreement(pairs: Iterable[Tuple[str, bool, np.ndarray,
                                               np.ndarray, np.ndarray,
                                               np.ndarray]]) -> Dict:
    """``pairs``: (name, is_conv_kernel, reference parameter, parameter,
    reference gradient, gradient) after one step from the same start, as
    arrays. -> the gradients' relative L2 distance over all of them and
    the largest over single conv kernels (with its name), the largest
    parameter difference by kind where both gradients reach :data:`TINY`,
    the count of such elements beyond tolerance and of opposite sign, the
    count below :data:`TINY` and the total."""
    d2 = n2 = 0.0
    out = {"worst_kernel": 0.0, "worst_other": 0.0, "beyond": 0,
           "opposite": 0, "tiny": 0, "total": 0, "kernel_rel_l2": 0.0,
           "worst_tensor": None}
    for name, is_kernel, ref_p, p, ref_g, g in pairs:
        ref_g, g = np.asarray(ref_g, np.float64), np.asarray(g, np.float64)
        d2 += float(np.sum(np.square(g - ref_g)))
        n2 += float(np.sum(np.square(ref_g)))
        held = np.minimum(np.abs(ref_g), np.abs(g)) >= TINY
        d = np.abs(np.asarray(p, np.float64) - np.asarray(ref_p, np.float64))
        tol = KERNEL_TOL if is_kernel else OTHER_TOL
        key = "worst_kernel" if is_kernel else "worst_other"
        if held.any():
            out[key] = max(out[key], float(d[held].max()))
        out["beyond"] += int((d[held] > tol).sum())
        out["opposite"] += int((np.sign(g) != np.sign(ref_g))[held].sum())
        out["tiny"] += int((~held).sum())
        out["total"] += int(d.size)
        rel = float(np.linalg.norm(g - ref_g)) / max(
            float(np.linalg.norm(ref_g)), 1e-30)
        if is_kernel and rel >= out["kernel_rel_l2"]:
            out["kernel_rel_l2"], out["worst_tensor"] = rel, name
    out["grad_rel_l2"] = float(np.sqrt(d2 / max(n2, 1e-300)))
    return out


def assert_first_step_close(summary: Dict, grad_rel_l2: float,
                            tag: str = "") -> None:
    """Raise unless every held parameter is within tolerance and the
    gradients, all together and each conv kernel's, within
    ``grad_rel_l2``."""
    if summary["beyond"] or summary["grad_rel_l2"] > grad_rel_l2 \
            or summary["kernel_rel_l2"] > grad_rel_l2:
        raise AssertionError(f"{tag} step parity (gradient limit "
                             f"{grad_rel_l2:g}): {summary}")


def state_pairs(ref_state, state) -> List[Tuple]:
    """:func:`first_step_agreement`'s pairs for two ``GANTrainState`` after
    one step (the first-step gradient is Adam's ``mu / (1 - b1)``)."""
    pairs = []
    for tag, ref_opt, opt, net in (
            ("G", ref_state.g_opt, state.g_opt, state.generator),
            ("D", ref_state.d_opt, state.d_opt, state.discriminator)):
        if opt is None:
            continue
        names = [n for n, _ in net.named_parameters()]
        for name, rp, p, rm, m in zip(names, ref_opt.params, opt.params,
                                      ref_opt.mu, opt.mu):
            pairs.append((f"{tag}.{name}", p.dim() == 4,
                          rp.detach().double().cpu().numpy(),
                          p.detach().double().cpu().numpy(),
                          (rm.double() / (1 - ref_opt.b1)).cpu().numpy(),
                          (m.double() / (1 - opt.b1)).cpu().numpy()))
    return pairs


class Kinks:
    """Within ``with kinks:``, every ``F.relu``, ``layers.leaky_relu`` and
    InstanceNorm + activation site of the networks either records its
    branch mask (``replay=None``: True where the input takes the identity
    branch) or takes the masks of ``replay``, a list recorded by an earlier
    run of the same program, in order. Replayed InstanceNorm sites run the
    plain formula under autograd in the input's type (fp64 for a
    reference)."""

    def __init__(self, replay: Optional[List[torch.Tensor]] = None):
        self.replay = replay
        self.masks: List[torch.Tensor] = []
        self.sites: List[str] = []

    def _mask(self, x: torch.Tensor, site: str, identity: torch.Tensor):
        i = len(self.masks)
        if self.replay is None:
            mask = identity.detach()
        else:
            mask = self.replay[i].to(x.device)
            if mask.shape != x.shape:
                raise AssertionError(f"kink {i} ({site}): replayed mask "
                                     f"{tuple(mask.shape)}, input "
                                     f"{tuple(x.shape)}")
        self.masks.append(mask.cpu())
        self.sites.append(f"{site} {tuple(x.shape)}")
        return mask

    def _relu(self, x, inplace=False):
        return torch.where(self._mask(x, "relu", x > 0), x,
                           torch.zeros_like(x))

    def _leaky(self, x, slope=0.2):
        return torch.where(self._mask(x, "leaky_relu", x >= 0), x, x * slope)

    def _norm_act(self, x, act=None, slope=0.2, eps=1e-5):
        if self.replay is None:
            y = self._orig_norm_act(x, act, slope, eps)
            if act is not None:
                self._mask(x, f"instance_norm+{act}",
                           y >= 0 if act == "leaky_relu" else y > 0)
            return y
        mean = x.mean(dim=(1, 2), keepdim=True)
        xh = (x - mean) * torch.rsqrt(
            torch.square(x - mean).mean(dim=(1, 2), keepdim=True) + eps)
        if act is None:
            return xh
        mask = self._mask(x, f"instance_norm+{act}", xh >= 0)
        return torch.where(mask, xh, xh * slope if act == "leaky_relu"
                           else torch.zeros_like(xh))

    def __enter__(self):
        self._saved = (F.relu, _layers.leaky_relu, _disc.leaky_relu,
                       _layers.instance_norm_act_autograd)
        self._orig_norm_act = self._saved[3]
        F.relu = self._relu
        _layers.leaky_relu = _disc.leaky_relu = self._leaky
        _layers.instance_norm_act_autograd = self._norm_act
        return self

    def __exit__(self, *exc):
        (F.relu, _layers.leaky_relu, _disc.leaky_relu,
         _layers.instance_norm_act_autograd) = self._saved
        if exc[0] is None and self.replay is not None \
                and len(self.masks) != len(self.replay):
            raise AssertionError(f"replayed {len(self.masks)} of "
                                 f"{len(self.replay)} kinks")
        return False


def run_step(model, start, batch_np: Dict[str, np.ndarray], device,
             kinks: Optional[Kinks] = None, dtype: Optional[torch.dtype] = None):
    """One step of ``model`` from a copy of ``start`` (a CPU
    ``GANTrainState``, left as it was) on ``device``, with fresh optimizers
    and the batch from ``batch_np``. ``dtype`` float64 makes a reference:
    the networks, the batch and the step in fp64 on the CPU (losses,
    BatchNorm statistics and Adam keep their fp32 casts; replay the kinks
    of another run so InstanceNorm runs in fp64 too). -> (state, metrics)."""
    dev = torch.device("cpu") if dtype == torch.float64 else torch.device(
        device)
    st = copy.deepcopy(start)
    for net in (st.generator, st.discriminator, st.perception):
        if net is not None:
            net.to(dev, dtype or torch.float32)
    st.g_opt = optim.from_config(st.generator.parameters(),
                                 model.optimizer_config["generator"],
                                 model.clip)
    if st.discriminator is not None:
        st.d_opt = optim.from_config(st.discriminator.parameters(),
                                     model.optimizer_config["discriminator"],
                                     model.clip)
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(dev, dtype or
                                                           torch.float32)
             for k, v in batch_np.items()}
    saved = model.dtype
    model.dtype = dtype or saved
    try:
        step = make_train_step(model)
    finally:
        model.dtype = saved
    with kinks if kinks is not None else contextlib.nullcontext():
        metrics = step(st, batch, torch.Generator(device=dev).manual_seed(0))
    return st, {k: float(v) for k, v in metrics.items()}


def step_witness(model, start, batch_np: Dict[str, np.ndarray],
                 device) -> Dict:
    """One precision-32 step from ``start`` on the CPU and on ``device``
    (the caller sets ``training_backends``), each recording its branches,
    and the fp64 references that take each device's branches. -> each
    device's :func:`first_step_agreement` with its own reference, the card
    against the CPU, the loss differences, the number of kinks, and the
    branch flips between the two devices by kink site."""
    runs = {}
    for tag, where in (("cpu", "cpu"), ("card", device)):
        kinks = Kinks()
        st, met = run_step(model, start, batch_np, where, kinks)
        ref, _ = run_step(model, start, batch_np, "cpu",
                          Kinks(replay=kinks.masks), torch.float64)
        runs[tag] = dict(state=st, metrics=met, kinks=kinks, ref=ref)
    flips = {}
    for site, a, b in zip(runs["cpu"]["kinks"].sites,
                          runs["cpu"]["kinks"].masks,
                          runs["card"]["kinks"].masks):
        n = int((a != b).sum())
        if n:
            flips[site] = flips.get(site, 0) + n
    cpu, card = runs["cpu"], runs["card"]
    bn_d = (0.0, 0.0)
    if cpu["state"].generator.smoothers is not None:
        a, b = (r["state"].generator.smoothers[2] for r in (cpu, card))
        bn_d = tuple(float((getattr(b, k).cpu() - getattr(a, k)).abs().max())
                     for k in ("running_mean", "running_var"))
    return {
        "to_own_reference": {
            tag: first_step_agreement(state_pairs(r["ref"], r["state"]))
            for tag, r in runs.items()},
        "card_vs_cpu": first_step_agreement(state_pairs(cpu["state"],
                                                        card["state"])),
        "loss_d": {k: abs(card["metrics"][k] - cpu["metrics"][k])
                   for k in cpu["metrics"]},
        "bn_d": bn_d,
        "kinks": len(cpu["kinks"].masks),
        "flips": flips,
    }


def _grad_gap(ref_state, state, net: str) -> float:
    """One network's first-step gradient distance, relative L2."""
    return first_step_agreement(
        p for p in state_pairs(ref_state, state)
        if p[0].startswith(net + "."))["grad_rel_l2"]


def device_step_parity(model, bf16_model, batch_np: Dict[str, np.ndarray],
                       device) -> Dict:
    """The card (``device``) against the CPU for one step from the same
    parameters and batch. Precision 32 (``model``): :func:`step_witness`.
    Precision bf16 (``bf16_model``, the same networks): each device's bf16
    step against the CPU's fp32 step, by network, and the two bf16 steps'
    loss differences."""
    with training_backends(torch.float32):
        start = model.init_state(0, "cpu")
        out = step_witness(model, start, batch_np, device)
        ref32, _ = run_step(model, start, batch_np, "cpu")
    with training_backends(torch.bfloat16):
        cpu_bf, cpu_met = run_step(bf16_model, start, batch_np, "cpu")
        card_bf, card_met = run_step(bf16_model, start, batch_np, device)
    out["bf16"] = {net: {"card": _grad_gap(ref32, card_bf, net),
                         "cpu": _grad_gap(ref32, cpu_bf, net)}
                   for net in ("G", "D")}
    out["bf16_loss_d"] = {k: abs(card_met[k] - cpu_met[k]) for k in cpu_met}
    return out


def assert_device_step_parity(r: Dict) -> None:
    """The limits on :func:`device_step_parity`, from card readings (an
    NVIDIA H100; chip_smoke.py prints them):

    - fp32 losses, card against CPU: 1e-5 (D) and 1e-4 (G), as against
      JAX; BatchNorm statistics 1e-5 (mean) and 1e-3 (variance);
    - each device against the fp64 step that takes its own branches:
      :func:`assert_first_step_close` at 5e-5 (measured at most 6.1e-6
      over a network and 9.2e-6 for one kernel), so that the branch
      flips, counted, are all that parts the card from the CPU;
    - bf16: each network's gradient on the card no further from the CPU's
      fp32 step than 1.25 times the CPU's own bf16 step is (measured for G
      0.22-0.31 on the card against 0.31-0.44 on the CPU at small widths,
      0.31-0.43 against 0.30-0.42 at full width), and the two bf16 steps'
      losses within 1e-2, about one bf16 ulp of a loss near 1.6 (measured
      2.9e-3 at most)."""
    bad = [k for k, v in r["loss_d"].items()
           if v > (1e-5 if k.startswith("d_") else 1e-4)]
    if bad:
        raise AssertionError(f"card vs CPU losses: {bad} {r['loss_d']}")
    for tag, summary in r["to_own_reference"].items():
        assert_first_step_close(summary, 5e-5, f"{tag} against its fp64")
    if r["bn_d"][0] > 1e-5 or r["bn_d"][1] > 1e-3:
        raise AssertionError(f"card vs CPU BatchNorm: {r['bn_d']}")
    if any(v > 1e-2 for v in r["bf16_loss_d"].values()) or any(
            v["card"] > 1.25 * v["cpu"] for v in r["bf16"].values()):
        raise AssertionError(f"bf16 card vs CPU: {r['bf16']} "
                             f"{r['bf16_loss_d']}")

