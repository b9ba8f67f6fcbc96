"""Command line: GAN training of GeneratorJ on keyframe patches.

    python train_torch.py [key=value ...] [-m]

The same surface as the JAX package's ``train.py``: ``key=value``
overrides composed over ``config/config.yaml``, Hydra-style ``-m`` sweeps
over comma-separated values, the run directory
(``${training.output_dir}/<date>/<time>`` unless ``run.dir`` is given) with
the resolved config snapshotted into it, and a synthetic sample scene made
on first use when the configured scene lies under ``test_dataset/``
(``data/sample_scene.py``). ``training.accelerator=cpu`` trains on
the CPU; otherwise on the CUDA card, and a missing card raises. The config
is read and written by the port's own YAML code (``config/yamlio.py``):
neither PyYAML nor Pillow is needed.

Several devices (JAX ``train.py:77-144``), one rank a device, each
training on its rows of the global ``training.batch_size``
(``train/loop.py``):

- ``training.devices=N`` (or -1, every card this process owns; on the CPU
  N ranks): the ranks are spawned here (``parallel/launch.py``) and meet
  on a free localhost port; ``training.devices=1`` trains in this process;
- ``parallel.dcn.enabled=true`` with ``coordinator_address``,
  ``num_processes`` and ``process_id``: this process joins the cluster
  with its ``training.devices`` local ranks (spawned unless that is 1, in
  which case it is the rank), global rank ``process_id x local +
  local_rank``;
- ``parallel.dcn.enabled=true`` with those three null: torchrun started
  this process as one rank (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``; its card ``cuda:LOCAL_RANK``).

``parallel.mesh.model=m`` (tensor parallelism, ``parallel/tp.py``) lays the
ranks out as data x model, as JAX's ``train.py:123-141`` builds its mesh
(``parallel.comm.check_mesh``): ``training.devices=1`` ignores it (one
device); ``training.devices=d`` spawns d x m ranks; -1 takes every card
this process owns, ``owned // m`` data ranks, and raises ``ValueError``
when m does not divide them; too few cards raise ``ValueError``. A model
group never spans processes: under ``parallel.dcn`` the ranks a process
spawns (under torchrun the ranks of a node, ``LOCAL_WORLD_SIZE``) must
divide by m.

The first process prints and snapshots the config and makes the sample
scene (the others wait for it); a global batch the data ranks do not
divide is refused before any rank starts.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import time
from pathlib import Path
from typing import Any, Iterator, List

import torch

from patch_toon_tpu_torch import parallel
from patch_toon_tpu_torch.config import yamlio
from patch_toon_tpu_torch.config.compose import (
    _wrap,
    compose,
    save,
    to_container,
)
from patch_toon_tpu_torch.data.sample_scene import make_scene
from patch_toon_tpu_torch.utils.logging import configure_logging

REPO = Path(__file__).resolve().parents[1]
CONFIG_DIR = REPO / "config"


def ensure_sample_data(cfg: Any, primary: bool = True) -> None:
    """Make a synthetic scene where the configured one is missing and lies
    under a ``test_dataset`` directory (JAX ``train.py::_ensure_sample_data``);
    a missing user path still raises in the dataset. A process that is not
    ``primary`` waits for the first one to make it."""
    if isinstance(cfg.data.dir_pre, (list, tuple)):
        return
    dir_pre = Path(cfg.data.dir_pre)
    scene = dir_pre.parent
    sentinel = scene / ".complete"
    if dir_pre.exists() and (sentinel.exists() or any(dir_pre.iterdir())):
        return
    if "test_dataset" not in scene.parts:
        return
    if not primary:
        for _ in range(600):
            if sentinel.exists():
                return
            time.sleep(0.1)
        raise TimeoutError(f"waited for process 0 to generate {scene}")
    print(f"Sample scene {scene} not found — generating a synthetic one "
          f"(data/sample_scene.py)")
    make_scene(str(scene), frames=7)
    sentinel.touch()


def _model(cfg: Any):
    from patch_toon_tpu_torch.train.model import StyleTransferModel

    return StyleTransferModel(
        generator_config=cfg.model.generator,
        discriminator_config=cfg.model.get("discriminator"),
        training_config=cfg.training, optimizer_config=cfg.optimizer,
        data_config=cfg.data,
        perception_loss_config=cfg.model.get("perception_loss"),
        parallel_config=cfg.get("parallel"))


def train_rank(device: torch.device, cfg: Any, run_dir: str) -> None:
    """One rank's (or the only process's) training on ``device``: the
    keyframes decoded onto it, then ``fit``."""
    from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
    from patch_toon_tpu_torch.train.loop import fit

    cfg = _wrap(cfg)
    dataset = StyleTransferDataset.from_directories(
        cfg.data.dir_pre, cfg.data.dir_post, cfg.data.dir_mask,
        int(cfg.data.patch_size),
        int(cfg.data.get("augmentation_factor", 1)),
        to_container(cfg.data.get("additional_channels") or {}),
        str(cfg.data.get("sampling", "uniform")), device)
    fit(_model(cfg), dataset, run_dir, seed=int(cfg.training.get("seed", 0)),
        max_epochs=int(cfg.training.get("max_epochs", 50)),
        resume_from=cfg.training.get("resume_from"))


def train(cfg: Any) -> None:
    _model(cfg)  # the knobs are checked before any process starts
    tc = cfg.training
    cpu = str(tc.get("accelerator", "auto")) == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "training asked for a CUDA device and none is available "
            "(training.accelerator=cpu trains on the CPU)")
    n = int(tc.get("devices", 1) or 1)
    m = parallel.mesh_model(cfg.get("parallel"))
    dcn = (cfg.get("parallel") or {}).get("dcn") or {}
    where = [dcn.get(k) for k in ("coordinator_address", "num_processes",
                                  "process_id")]
    torchrun = bool(dcn.get("enabled", False)) and all(
        v is None for v in where)
    if torchrun:
        if n not in (1, -1):
            raise ValueError(
                f"training.devices={n} under torchrun: each process is one "
                "rank on its own card (start more with --nproc-per-node)")
        node = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        if node % m:
            raise ValueError(
                f"parallel.mesh.model={m} does not divide the {node} "
                "rank(s) of this node (LOCAL_WORLD_SIZE): a model group "
                "never spans nodes")
        devices = parallel.local_devices(1, cpu)
        processes, pid = int(os.environ.get("WORLD_SIZE", "0")), int(
            os.environ.get("RANK", "0"))
    elif dcn.get("enabled", False):
        if any(v is None for v in where):
            raise ValueError(
                "parallel.dcn: give coordinator_address, num_processes and "
                f"process_id together (got {where})")
        local = n
        if m > 1:  # JAX dcn.py:88-94: model inside each process
            local = n * m if n not in (1, -1) else len(
                parallel.local_devices(-1, cpu))
            if local % m:
                raise ValueError(
                    f"parallel.mesh.model={m} does not divide the {local} "
                    f"card(s) of process {where[2]} (training.devices={n} "
                    "under parallel.dcn): a model group never spans "
                    "processes")
        devices = parallel.local_devices(local, cpu)
        processes, pid = int(where[1]), int(where[2])
    else:
        owned = n * m if cpu and n != -1 else len(
            parallel.local_devices(-1, cpu))
        data, m = parallel.check_mesh(n, m, owned)
        devices = parallel.local_devices(data * m, cpu)
        processes, pid = 1, 0
    world = processes * len(devices)
    parallel.shard_rows(int(tc["batch_size"]), 0, world // m)

    run_dir = Path(cfg.get("run", {}).get("dir")
                   or tc.get("output_dir", "outputs"))
    primary = pid == 0
    if primary:
        run_dir.mkdir(parents=True, exist_ok=True)
        print("=== Resolved config ===")
        print(yamlio.dump(to_container(cfg)))
        save(cfg, run_dir / "config.yaml")
    ensure_sample_data(cfg, primary)
    args = (to_container(cfg), str(run_dir))
    if torchrun or (n == 1 and len(devices) == 1):  # this process: the rank
        if dcn.get("enabled", False):
            if not cpu:
                torch.cuda.set_device(devices[0])
            parallel.initialize_distributed(
                *where, backend="gloo" if cpu else "nccl",
                device=devices[0])
        train_rank(devices[0], *args)
    else:
        print(f"Training on {world} ranks: data {world // m} x model {m}, "
              f"{len(devices)} here ({', '.join(map(str, devices))})")
        parallel.spawn(train_rank, args, devices,
                       address=str(where[0]) if dcn.get("enabled", False)
                       else None, offset=pid * len(devices),
                       world_size=world)
    if primary:
        print(f"Training complete. Run dir: {run_dir}")


def expand_multirun(overrides: List[str]) -> Iterator[List[str]]:
    """``-m`` sweeps: comma-separated values expand into the cartesian
    product of runs (JAX ``train.py::_expand_multirun``)."""
    keys, values, fixed = [], [], []
    for ov in overrides:
        if "=" in ov and "," in ov.split("=", 1)[1]:
            k, v = ov.split("=", 1)
            keys.append(k)
            values.append(v.split(","))
        else:
            fixed.append(ov)
    for combo in itertools.product(*values):
        yield fixed + [f"{k}={v}" for k, v in zip(keys, combo)]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    configure_logging(logging.INFO)
    multirun = "-m" in argv or "--multirun" in argv
    argv = [a for a in argv if a not in ("-m", "--multirun")]
    if not multirun:
        train(compose(CONFIG_DIR, "config", overrides=argv))
        return 0
    for i, run_overrides in enumerate(expand_multirun(argv)):
        print(f"\n===== multirun job {i}: {run_overrides} =====")
        cfg = compose(CONFIG_DIR, "config", overrides=run_overrides)
        cfg.run.dir = str(Path(cfg.run.dir) / f"job_{i}")
        train(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
