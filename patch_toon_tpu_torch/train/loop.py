"""The training loop: epochs, logging, checkpoints, early stopping
(counterpart of patch_toon_tpu/train/loop.py:34-295).

Per epoch ``dataset.steps_per_epoch(batch_size)`` steps, cut by the global
``training.max_steps``; scalars every ``log_every_n_steps`` steps; after
each epoch ``last.ckpt`` and ``epoch_<n>.ckpt`` with top-3 retention by
``training.checkpoint_score`` (``last_step``: the epoch's last
g_total_loss, the reference's; ``epoch_mean``; ``epoch_min``), which also
drives early stopping (patience in epochs). A resumed run continues the
epoch numbering from the checkpoint's own epoch.

The batch is drawn on the device (``data.sampling`` uniform or
permutation, ``dataset.make_sampler``) and the step runs there; the host
reads the losses back only at a logging step and at the end of an epoch.
Every ``image_log_freq`` steps the ``training/comparison_grid`` image is
built on the host from the step's batch and an eval-mode, no-grad
generator forward with the parameters after the step (JAX
``loop.py:222-235``); the generator goes back to train mode with its
BatchNorm statistics untouched. ``training.profile_dir`` traces epoch 0
with ``torch.profiler`` (CPU and, on a card, CUDA activity) and writes it
there as a Chrome trace (JAX ``loop.py:144-148, 243-247``).

In a process group (``parallel/``, one rank a card) the ranks are laid
out as data x model (``parallel.comm.set_layout`` with the model's
``parallel.mesh.model``; JAX's ``('data', 'model')`` mesh): every rank
runs this loop on its data index's rows of the global ``batch_size`` (the
step reduces the gradients and metrics over the data group): the ranks
draw the same global batches from the same seeded generator, so they
train on the one-device batches. Under tensor parallelism (model m > 1)
the state is built whole, a resume loaded whole, and then cut to the
rank's shards (``train/state.py::shard_state_``); the m ranks of a data
index take the same rows. Rank 0 alone writes the checkpoints (whole:
gathered over the model group, ``checkpoints.whole_state``), the
TensorBoard events and the grid (built from the first rows of the global
batch, gathered over the data group) and prints; the other ranks wait for
each checkpoint at a barrier. A resume loads on every rank.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from patch_toon_tpu_torch.parallel import comm
from patch_toon_tpu_torch.parallel.tp import model_shard
from patch_toon_tpu_torch.train.checkpoints import (
    CheckpointManager,
    whole_state,
)
from patch_toon_tpu_torch.train.logging import (
    MetricsLogger,
    build_comparison_grid,
)
from patch_toon_tpu_torch.train.model import training_backends
from patch_toon_tpu_torch.train.state import GANTrainState, shard_state_
from patch_toon_tpu_torch.train.step import make_train_step


def comparison_grid(model, state: GANTrainState, dataset,
                    batch: Dict[str, torch.Tensor]) -> np.ndarray:
    """The comparison grid of ``batch``: Input | Generated | Target | each
    guide channel, the generator run in eval mode without gradients and
    put back in train mode."""
    gen_net = state.generator
    gen_net.eval()
    try:
        with torch.no_grad():
            generated = gen_net(dataset.model_input(batch).to(model.dtype))
    finally:
        gen_net.train()

    group = comm.data_layout(gen_net.tp)[2]

    def host(t: torch.Tensor) -> np.ndarray:  # the global batch's rows
        return comm.gather_rows(t.float(), group).cpu().numpy()

    return build_comparison_grid(
        host(batch["pre"]), host(generated), host(batch["post"]),
        host(batch["channels"]) if "channels" in batch else None,
        dataset.channel_depths)


def _start_profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def fit(model, dataset, run_dir: str, seed: int = 0,
        max_epochs: Optional[int] = None, resume_from: Optional[str] = None,
        progress: bool = True, device: Any = None,
        on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]]
        = None) -> GANTrainState:
    """Train ``model`` on ``dataset`` (on ``dataset.device`` unless
    ``device`` is given); -> the final state. ``on_step(global_step,
    metrics)`` is called after each step and its logging, with the step's
    metrics still on the device (a caller may time a window of steps). In
    a process group, this rank's share (see the module's docstring)."""
    tc = model.training_config
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device(device) if device is not None else dataset.device
    batch_size = int(tc["batch_size"])
    max_epochs = int(max_epochs if max_epochs is not None
                     else tc.get("max_epochs", 50))
    log_every = int(tc.get("log_every_n_steps", 10))
    image_log_freq = int(tc.get("image_log_freq", 100))
    early_stopping = bool(tc.get("early_stopping", False))
    patience = int(tc.get("early_stopping_patience", 2))
    max_steps = int(tc.get("max_steps") or 0)
    score_mode = str(tc.get("checkpoint_score", "last_step"))
    if score_mode not in ("last_step", "epoch_mean", "epoch_min"):
        raise ValueError(f"training.checkpoint_score={score_mode!r}: "
                         "expected last_step, epoch_mean or epoch_min")

    world = comm.world()
    lay = comm.set_layout(model.model_parallel if world > 1 else 1)
    rows = comm.shard_rows(batch_size, lay.data_index, lay.data)
    primary = comm.rank() == 0
    progress = progress and primary
    shard = model_shard(lay)

    with training_backends(model.dtype):
        state = model.init_state(seed, dev)
        start_epoch = 0
        steps_per_epoch = dataset.steps_per_epoch(batch_size)
        if resume_from:
            CheckpointManager.restore(resume_from, state)
            meta = CheckpointManager.read_meta(resume_from)
            start_epoch = (int(meta["epoch"]) + 1 if "epoch" in meta
                           else state.step // steps_per_epoch)
            if primary:
                print(f"Resumed from {resume_from} at step {state.step}")
        if shard is not None:
            shard_state_(state, shard)
        step_fn = make_train_step(model, bool(tc.get("two_forward", False)))
        sample = dataset.make_sampler(batch_size, rows)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        ckpt = CheckpointManager(run_dir / "checkpoints", keep_top_k=3, meta={
            "input_channels": model.input_channels,
            "generator_args": model.generator_args,
            "discriminator_args": model.discriminator_args,
            "patch_size": dataset.patch_size}) if primary else None
        logger = MetricsLogger(str(run_dir / "tb") if primary else None)
        lr = float(model.optimizer_config["generator"].get("lr", 0.0) or 0.0)
        if primary:
            print(f"Training: {max_epochs} epochs x {steps_per_epoch} "
                  f"steps, batch {batch_size}"
                  + (f" over {world} ranks (data {lay.data} x model "
                     f"{lay.model})" if world > 1 else "")
                  + f", {dataset.num_images} keyframes, {len(dataset)} "
                  f"patch centers, on {dev}")

        best, stale, global_step = float("inf"), 0, state.step
        profile_dir = tc.get("profile_dir") if primary else None
        prof = _start_profiler(dev) if profile_dir else None
        try:
            for epoch in range(start_epoch, max_epochs):
                n_steps = steps_per_epoch
                if max_steps:
                    n_steps = min(n_steps, max(0, max_steps - global_step))
                    if n_steps == 0:
                        break
                loss_sum = torch.zeros((), device=dev)
                loss_min = torch.full((), float("inf"), device=dev)
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    batch = sample(gen)
                    metrics = step_fn(state, batch, gen)
                    global_step += 1
                    loss_sum += metrics["g_total_loss"]
                    loss_min = torch.minimum(loss_min,
                                             metrics["g_total_loss"])
                    if global_step % log_every == 0:
                        names = list(metrics)
                        vals = torch.stack([metrics[k] for k in names]).tolist()
                        logger.log_scalars({**dict(zip(names, vals)),
                                            "lr-Adam": lr}, global_step)
                    if global_step % image_log_freq == 0:
                        grid = comparison_grid(model, state, dataset, batch)
                        logger.log_image("training/comparison_grid", grid,
                                         global_step)
                    if on_step is not None:
                        on_step(global_step, metrics)
                if prof is not None:  # the trace covers the first epoch
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    prof.stop()
                    Path(profile_dir).mkdir(parents=True, exist_ok=True)
                    prof.export_chrome_trace(str(
                        Path(profile_dir) / f"epoch_{epoch}.pt.trace.json"))
                    prof = None
                    print(f"Profiler trace of epoch {epoch} written to "
                          f"{profile_dir}")
                s, m, last = torch.stack(
                    [loss_sum, loss_min, metrics["g_total_loss"]]).tolist()
                mean_loss = s / n_steps
                score = {"last_step": last, "epoch_mean": mean_loss,
                         "epoch_min": m}[score_mode]
                dt = time.perf_counter() - t0
                pps = n_steps * batch_size / dt
                if progress:
                    print(f"epoch {epoch}: g_total_loss={mean_loss:.4f} "
                          f"({dt:.1f}s, {pps:,.0f} patches/s)")
                logger.log_scalars({"epoch_g_total_loss": mean_loss,
                                    "patches_per_sec": pps}, global_step)
                if ckpt is not None or shard is not None:
                    whole = whole_state(state)  # collective under TP
                if ckpt is not None:
                    ckpt.save(state, epoch, score, whole)
                comm.barrier()
                if max_steps and global_step >= max_steps:
                    if primary:
                        print(f"Reached training.max_steps={max_steps}; "
                              "stopping")
                    break
                if score < best - 1e-12:
                    best, stale = score, 0
                else:
                    stale += 1
                    if early_stopping and stale >= patience:
                        if primary:
                            print(f"Early stopping at epoch {epoch} (no "
                                  f"improvement for {patience} epochs)")
                        break
        finally:
            if prof is not None:
                prof.stop()
            logger.close()
    return state
