"""The GAN train step (counterpart of patch_toon_tpu/train/step.py:109-231).

One step, in the JAX package's order:

1. **One generator forward** in train mode with autograd (the smoother
   BatchNorm uses batch statistics and advances its running statistics
   once). The D phase takes ``gen.detach()``.
2. **D phase** (reference lightning_model.py:224-236, 294-321): real =
   post, fake = gen; loss ``0.5 * (adv(D(post), 1) + adv(D(gen), 0))``;
   clip and Adam.
3. **BatchNorm double advance**, when D exists: the reference runs the
   generator twice a step and each forward advances the statistics, so
   ``m2 = m1 + 0.9 * (m1 - m0)`` (JAX step.py:159-165).
4. **G phase** (lightning_model.py:239-292): ``rec(gen, post) * w_rec +
   perceptual MSE * w_perc + adv(D'(gen), 1) * w_adv`` against the UPDATED
   D'; gradients into G's parameters only.
5. Clip G's gradients, then Adam.

``two_forward`` is the reference's literal two forwards (a no-grad one for
the D phase, a fresh one with grad for the G phase; the statistics advance
in each). Guide dropout (``training.guide_dropout_p``): per sample, with
probability p, the trailing ``guide_dropout_depth`` input channels become
the first RGB bands. Every draw (guide dropout, the discriminator's input
noise) comes from the step's ``torch.Generator``; a caller may inject the
dropout mask instead (``guide_drop``), as the parity tests do.

Under bf16 the networks run in bf16; statistics, losses and the optimizer
stay fp32. InstanceNorm runs through kernel B1 and its backward kernel on
a card (``ops/instance_norm.InstanceNormAct``).

In a process group (``parallel/``) each data index runs the step on its
rows of the global batch, JAX's GSPMD step: the guide dropout mask and the
discriminator's noise are drawn for the global batch and cut to the data
index's rows; the smoother BatchNorm takes global statistics
(``models/layers.py::batch_norm_train_fp32``); each network's gradients
are averaged over the data group in one coalesced all-reduce
(``parallel.all_reduce_mean_``) before the optimizer clips them, so the
clip sees the global norm and every rank applies the same update; the
metrics are averaged too. The gradients come from
``torch.autograd.grad``, which no ``DistributedDataParallel`` hook sees,
hence the explicit reduction. Under tensor parallelism
(``parallel.mesh.model = m > 1``, ``parallel/tp.py``) the m ranks of a
model group take the same rows and draws and hold slices of the sharded
parameters; the networks' forward gathers over the model group, so a
rank's gradients are those of its slices, reduced over the data group
only, and the clip sums the sharded norms over the model group
(``train/optim.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from patch_toon_tpu_torch.models.perception import perceptual_mse
from patch_toon_tpu_torch.parallel import comm
from patch_toon_tpu_torch.train.losses import get_criterion
from patch_toon_tpu_torch.train.state import GANTrainState

Metrics = Dict[str, torch.Tensor]


def _bn_buffers(module: torch.nn.Module):
    return [b for n, b in module.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def make_train_step(model, two_forward: bool = False) -> Callable[..., Metrics]:
    """-> ``step(state, batch, generator, guide_drop=None) -> metrics``.

    ``batch``: ``pre`` (B, H, W, 3), ``post`` and optionally ``channels``,
    on the state's device. ``generator``: the step's ``torch.Generator``
    on that device. ``guide_drop``: an optional (B,) bool mask that
    replaces the guide-dropout draw. The state is updated in place and its
    ``step`` bumped; the metrics are 0-d fp32 tensors on the device. In a
    process group ``batch`` is this data index's rows and ``guide_drop``,
    when given, the global batch's mask; the data x model layout is the
    generator's ``tp`` (``parallel.comm.data_layout``)."""
    tc = model.training_config
    rec_crit = get_criterion(tc["reconstruction_criterion"])
    adv_crit = get_criterion(tc["adversarial_criterion"])
    rec_w = float(tc["reconstruction_weight"])
    adv_w = float(tc["adversarial_weight"])
    use_image_loss = bool(tc.get("use_image_loss", True))
    gd_p = float(tc.get("guide_dropout_p", 0.0) or 0.0)
    gd_depth = int(tc.get("guide_dropout_depth", 3) or 3)
    pw = model.perception_weight
    dt = model.dtype
    def step(state: GANTrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator,
             guide_drop: Optional[torch.Tensor] = None) -> Metrics:
        G, D, P = state.generator, state.discriminator, state.perception
        data, index, group = comm.data_layout(G.tp)
        shard = (index, data)

        def grads_of(loss, params):
            grads = list(torch.autograd.grad(loss, params))
            comm.all_reduce_mean_(grads, group)
            return grads

        forward_twice = two_forward and D is not None
        x = batch["pre"]
        if "channels" in batch:
            x = torch.cat([x, batch["channels"]], dim=-1)
        x = x.to(dt)
        if gd_p > 0.0 and x.shape[-1] > gd_depth:
            b, (r, n) = x.shape[0], shard
            drop = guide_drop if guide_drop is not None else torch.rand(
                (n * b,), generator=generator, device=x.device) < gd_p
            drop = drop[r * b:(r + 1) * b]
            x = torch.cat([x[..., :-gd_depth], torch.where(
                drop.view(-1, 1, 1, 1), x[..., :gd_depth],
                x[..., -gd_depth:])], dim=-1)
        post = batch["post"]
        metrics: Metrics = {}

        double_advance = D is not None and not forward_twice
        m0 = [b.clone() for b in _bn_buffers(G)] if double_advance else []
        if forward_twice:
            with torch.no_grad():  # forward 1: the D phase's fake batch
                gen_value = G(x)
        else:
            gen = G(x)
            gen_value = gen.detach()

        if D is not None:
            real = D(post.to(dt), generator, shard)
            fake = D(gen_value.to(dt), generator, shard)
            real_loss = adv_crit(real, torch.ones_like(real))
            fake_loss = adv_crit(fake, torch.zeros_like(fake))
            d_loss = (real_loss + fake_loss) * 0.5
            state.d_opt.step(grads_of(d_loss, state.d_opt.params))
            metrics.update(d_real_loss=real_loss.detach(),
                           d_fake_loss=fake_loss.detach(),
                           d_total_loss=d_loss.detach())
        if double_advance:  # m2 = 0.9 m1 + 0.1 b == m1 + 0.9 (m1 - m0)
            with torch.no_grad():
                for b, old in zip(_bn_buffers(G), m0):
                    b.copy_(b + 0.9 * (b - old))
        if forward_twice:  # forward 2, with grad, from the advanced stats
            gen = G(x)

        losses: Metrics = {}
        if use_image_loss:
            losses["g_image_loss"] = rec_crit(gen, post) * rec_w
        if P is not None:
            with torch.no_grad():
                target = P(post.to(dt))
            losses["g_perception_loss"] = perceptual_mse(
                P(gen.to(dt)), target) * pw
        if D is not None:
            logits = D(gen.to(dt), generator, shard)
            losses["g_adversarial_loss"] = adv_crit(
                logits, torch.ones_like(logits)) * adv_w
        g_total = sum(losses.values())
        state.g_opt.step(grads_of(g_total, state.g_opt.params))

        metrics.update({k: v.detach() for k, v in losses.items()})
        metrics["g_total_loss"] = g_total.detach()
        if shard[1] > 1:  # global means
            vals = torch.stack(list(metrics.values()))
            comm.all_reduce_mean_([vals], group)
            metrics = dict(zip(metrics, vals.unbind()))
        state.step += 1
        return metrics

    return step
