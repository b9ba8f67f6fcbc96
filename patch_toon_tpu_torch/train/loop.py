"""The training loop: epochs, logging, checkpoints, early stopping
(counterpart of patch_toon_tpu/train/loop.py:34-295).

Per epoch ``dataset.steps_per_epoch(batch_size)`` steps, cut by the global
``training.max_steps``; scalars every ``log_every_n_steps`` steps; after
each epoch ``last.ckpt`` and ``epoch_<n>.ckpt`` with top-3 retention by
``training.checkpoint_score`` (``last_step``: the epoch's last
g_total_loss, the reference's; ``epoch_mean``; ``epoch_min``), which also
drives early stopping (patience in epochs). A resumed run continues the
epoch numbering from the checkpoint's own epoch.

The batch is drawn on the device and the step runs there; the host reads
the losses back only at a logging step and at the end of an epoch. The
comparison-grid images (``image_log_freq``) are not ported yet and are
skipped.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from patch_toon_tpu_torch.train.checkpoints import CheckpointManager
from patch_toon_tpu_torch.train.logging import MetricsLogger
from patch_toon_tpu_torch.train.model import training_backends
from patch_toon_tpu_torch.train.state import GANTrainState
from patch_toon_tpu_torch.train.step import make_train_step


def fit(model, dataset, run_dir: str, seed: int = 0,
        max_epochs: Optional[int] = None, resume_from: Optional[str] = None,
        progress: bool = True, device: Any = None,
        on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]]
        = None) -> GANTrainState:
    """Train ``model`` on ``dataset`` (on ``dataset.device`` unless
    ``device`` is given); -> the final state. ``on_step(global_step,
    metrics)`` is called after each step and its logging, with the step's
    metrics still on the device (a caller may time a window of steps)."""
    tc = model.training_config
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device(device) if device is not None else dataset.device
    batch_size = int(tc["batch_size"])
    max_epochs = int(max_epochs if max_epochs is not None
                     else tc.get("max_epochs", 50))
    log_every = int(tc.get("log_every_n_steps", 10))
    early_stopping = bool(tc.get("early_stopping", False))
    patience = int(tc.get("early_stopping_patience", 2))
    max_steps = int(tc.get("max_steps") or 0)
    score_mode = str(tc.get("checkpoint_score", "last_step"))
    if score_mode not in ("last_step", "epoch_mean", "epoch_min"):
        raise ValueError(f"training.checkpoint_score={score_mode!r}: "
                         "expected last_step, epoch_mean or epoch_min")

    with training_backends(model.dtype):
        state = model.init_state(seed, dev)
        start_epoch = 0
        steps_per_epoch = dataset.steps_per_epoch(batch_size)
        if resume_from:
            CheckpointManager.restore(resume_from, state)
            meta = CheckpointManager.read_meta(resume_from)
            start_epoch = (int(meta["epoch"]) + 1 if "epoch" in meta
                           else state.step // steps_per_epoch)
            print(f"Resumed from {resume_from} at step {state.step}")
        step_fn = make_train_step(model, bool(tc.get("two_forward", False)))
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        ckpt = CheckpointManager(run_dir / "checkpoints", keep_top_k=3, meta={
            "input_channels": model.input_channels,
            "generator_args": model.generator_args,
            "discriminator_args": model.discriminator_args,
            "patch_size": dataset.patch_size})
        logger = MetricsLogger(str(run_dir / "tb"))
        lr = float(model.optimizer_config["generator"].get("lr", 0.0) or 0.0)
        print(f"Training: {max_epochs} epochs x {steps_per_epoch} steps, "
              f"batch {batch_size}, {dataset.num_images} keyframes, "
              f"{len(dataset)} patch centers, on {dev}")

        best, stale, global_step = float("inf"), 0, state.step
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
                    batch = dataset.sample_batch(gen, batch_size)
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
                    if on_step is not None:
                        on_step(global_step, metrics)
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
                ckpt.save(state, epoch, score)
                if max_steps and global_step >= max_steps:
                    print(f"Reached training.max_steps={max_steps}; stopping")
                    break
                if score < best - 1e-12:
                    best, stale = score, 0
                else:
                    stale += 1
                    if early_stopping and stale >= patience:
                        print(f"Early stopping at epoch {epoch} "
                              f"(no improvement for {patience} epochs)")
                        break
        finally:
            logger.close()
    return state
