"""Command line: GAN training of GeneratorJ on keyframe patches.

    python train_torch.py [key=value ...] [-m]

The same surface as the JAX package's ``train.py``: ``key=value``
overrides composed over ``config/config.yaml``, Hydra-style ``-m`` sweeps
over comma-separated values, the run directory
(``${training.output_dir}/<date>/<time>`` unless ``run.dir`` is given) with
the resolved config snapshotted into it, and a synthetic sample scene made
on first use when the configured scene lies under ``test_dataset/``
(``tools/make_sample_scene.py``). ``training.accelerator=cpu`` trains on
the CPU; otherwise on the CUDA card, and a missing card raises. Needs
PyYAML for the config and Pillow for the keyframes.
"""

from __future__ import annotations

import itertools
import sys
from pathlib import Path
from typing import Any, Iterator, List

import torch

from patch_toon_tpu_torch.config.compose import compose, save, to_container

REPO = Path(__file__).resolve().parents[1]
CONFIG_DIR = REPO / "config"


def ensure_sample_data(cfg: Any) -> None:
    """Make a synthetic scene where the configured one is missing and lies
    under a ``test_dataset`` directory (JAX ``train.py::_ensure_sample_data``);
    a missing user path still raises in the dataset."""
    if isinstance(cfg.data.dir_pre, (list, tuple)):
        return
    dir_pre = Path(cfg.data.dir_pre)
    scene = dir_pre.parent
    sentinel = scene / ".complete"
    if dir_pre.exists() and (sentinel.exists() or any(dir_pre.iterdir())):
        return
    if "test_dataset" not in scene.parts:
        return
    print(f"Sample scene {scene} not found — generating a synthetic one "
          f"(tools/make_sample_scene.py)")
    sys.path.insert(0, str(REPO / "tools"))
    from make_sample_scene import make_scene

    make_scene(str(scene), frames=7)
    sentinel.touch()


def resolve_device(cfg: Any) -> torch.device:
    if str(cfg.training.get("accelerator", "auto")) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "training asked for a CUDA device and none is available "
            "(training.accelerator=cpu trains on the CPU)")
    return torch.device("cuda", 0)


def train(cfg: Any) -> None:
    import yaml

    from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
    from patch_toon_tpu_torch.train.loop import fit
    from patch_toon_tpu_torch.train.model import StyleTransferModel

    model = StyleTransferModel(
        generator_config=cfg.model.generator,
        discriminator_config=cfg.model.get("discriminator"),
        training_config=cfg.training, optimizer_config=cfg.optimizer,
        data_config=cfg.data,
        perception_loss_config=cfg.model.get("perception_loss"),
        parallel_config=cfg.get("parallel"))
    device = resolve_device(cfg)
    run_dir = Path(cfg.get("run", {}).get("dir")
                   or cfg.training.get("output_dir", "outputs"))
    run_dir.mkdir(parents=True, exist_ok=True)
    print("=== Resolved config ===")
    print(yaml.safe_dump(to_container(cfg), sort_keys=False))
    save(cfg, run_dir / "config.yaml")

    ensure_sample_data(cfg)
    dataset = StyleTransferDataset.from_directories(
        cfg.data.dir_pre, cfg.data.dir_post, cfg.data.dir_mask,
        int(cfg.data.patch_size),
        int(cfg.data.get("augmentation_factor", 1)),
        to_container(cfg.data.get("additional_channels") or {}),
        str(cfg.data.get("sampling", "uniform")), device)
    fit(model, dataset, str(run_dir), seed=int(cfg.training.get("seed", 0)),
        max_epochs=int(cfg.training.get("max_epochs", 50)),
        resume_from=cfg.training.get("resume_from"))
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
