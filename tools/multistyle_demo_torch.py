#!/usr/bin/env python
"""Multi-style training with the PyTorch port: three styles, one run.

    python tools/multistyle_demo_torch.py [--steps 600] [--frames 5] \
        [--height 96] [--width 128] [--device cuda|cpu] \
        [--out docs/multistyle_torch]

The counterpart of ``tools/multistyle_demo.py``, through the port's own
entry points:

1. three synthetic scenes (``data/sample_scene.py``, seeds 10, 11, 12),
   each with its own hand stylization of its input frames: posterize and
   a warm tint (the scene's own), colour inversion, and gray, posterize
   and a cool tint;
2. ONE training of ``--steps`` steps over all three through
   ``train_cli.train(compose(...))``, with list-valued
   ``data.dir_pre`` / ``dir_post`` / ``dir_mask`` and a list of tracking
   directories (the JAX demo's overrides: 3 residual blocks, filters [16,
   32, 64, 64, 64, 32], D 8 filters, batch 48 of 32x32 patches);
3. every scene served back with the one checkpoint at precision 32
   through ``StyleTransferInference``, tiled;
4. the masked PSNR of each stylized scene against each style's rendering
   of that scene's content: the own style must win every row.

Writes ``multistyle.json`` and ``REPORT.md`` into ``--out``, the JAX
package's committed matrix (``docs/multistyle/multistyle.json``) beside
the port's; the scenes, the run and the frames go under ``--out`` too.
Wall seconds are given with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from temporal_demo_torch import DEMO_GENERATOR, card_line  # noqa: E402

from patch_toon_tpu_torch import train_cli  # noqa: E402
from patch_toon_tpu_torch.config.compose import compose  # noqa: E402
from patch_toon_tpu_torch.data.io import (  # noqa: E402
    decode_rgb_uint8,
    load_luma,
)
from patch_toon_tpu_torch.data.sample_scene import (  # noqa: E402
    make_scene,
    stylize,
)
from patch_toon_tpu_torch.infer.engine import (  # noqa: E402
    StyleTransferInference,
)
from patch_toon_tpu_torch.native.frameio import encode_png  # noqa: E402

CONFIG = REPO / "config"
JAX_RESULTS = REPO / "docs" / "multistyle" / "multistyle.json"
STYLES = ("warm_posterize", "invert", "gray_cool")


def render(x: np.ndarray, style: str) -> np.ndarray:
    """A style's rendering of RGB in [0, 1], as uint8."""
    if style == "invert":
        y = 1.0 - x
    elif style == "gray_cool":
        g = x.mean(axis=-1, keepdims=True)
        y = np.round(g * 5) / 5 * np.array([0.75, 0.9, 1.2], np.float32)
    else:
        y = stylize(x)
    return (np.clip(y, 0, 1) * 255).astype(np.uint8)


def restyle(scene: Path, style: str) -> None:
    """Overwrite the scene's targets with another style of its inputs."""
    for p in sorted((scene / "input").glob("*.png")):
        x = decode_rgb_uint8(p).astype(np.float32) / 255.0
        encode_png(scene / "output" / p.name, render(x, style))


def masked_psnr(a: Path, b: Path, mask: Path) -> float:
    x = decode_rgb_uint8(a).astype(np.float64)
    y = decode_rgb_uint8(b).astype(np.float64)
    m = load_luma(mask).astype(np.float32) > 127
    mse = ((x - y) ** 2)[m].mean()
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-9)))


def psnr_row(out: Path, name: str, scene: Path, styles=STYLES) -> dict:
    """{style: mean masked PSNR} of the scene's ``stylized_<name>`` frames
    against each ``xref_<name>_as_<style>``."""
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    return {style: round(float(np.mean([masked_psnr(
        out / f"stylized_{name}" / n, out / f"xref_{name}_as_{style}" / n,
        scene / "mask" / n) for n in names])), 2) for style in styles}


def report(payload: dict, jax: dict, args) -> str:
    def table(matrix):
        rows = [f"| {s} | " + " | ".join(
            f"**{matrix[s][t]}**" if s == t else f"{matrix[s][t]}"
            for t in STYLES) + " |" for s in STYLES]
        return ["| stylized scene \\ style ref | " + " | ".join(STYLES)
                + " |", "|---|" + "---|" * len(STYLES), *rows]

    lines = [
        "# Multi-style training on the PyTorch port: one run, three styles",
        "",
        f"`tools/multistyle_demo_torch.py --steps {payload['steps']} "
        f"--frames {args.frames}`: one model trained {payload['steps']} "
        "steps through `train_cli.train` jointly on three synthetic scenes "
        f"({args.height}x{args.width}) with three hand stylizations "
        "(list-valued `data.dir_pre/dir_post/dir_mask`), then each scene "
        "served back at precision 32 with the one checkpoint through "
        "`StyleTransferInference`. Masked PSNR (dB) of each stylization "
        "against each style's rendering of that scene's content; the "
        "diagonal must win its row.",
        "",
        "The port:",
        "",
        *table(payload["matrix"]),
        "",
        f"Own style wins every row on the port: "
        f"**{payload['own_style_wins_every_row']}**.",
    ]
    if jax:
        lines += ["", "The JAX package's committed run "
                  "(`docs/multistyle/multistyle.json`, same recipe, "
                  f"{jax['steps']} steps; quality figures only):", "",
                  *table(jax["matrix"]), "",
                  f"Own style wins every row in JAX's run: "
                  f"**{jax['own_style_wins_every_row']}**."]
    lines += ["", f"Wall time of the whole demo: {payload['wall_seconds']} "
              f"s on {payload['device']}."]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    ap.add_argument("--out", default=str(REPO / "docs" / "multistyle_torch"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cpu = torch.device(args.device).type == "cpu"
    t0 = time.time()

    scenes = []
    for i, name in enumerate(STYLES):
        scene = out / f"scene_{name}"
        if not (scene / "input").exists():
            make_scene(str(scene), frames=args.frames, height=args.height,
                       width=args.width, seed=10 + i)
            if name != "warm_posterize":
                restyle(scene, name)
        scenes.append(scene)

    run_dir = out / "run_joint"
    ckpt = run_dir / "checkpoints" / "last.ckpt"
    if not ckpt.exists():
        lists = {sub: ",".join(str(s / sub) for s in scenes)
                 for sub in ("input", "output", "mask", "tracking")}
        train_cli.train(compose(CONFIG, "config", overrides=[
            f"data.dir_pre=[{lists['input']}]",
            f"data.dir_post=[{lists['output']}]",
            f"data.dir_mask=[{lists['mask']}]",
            "data.patch_size=32",
            "data.additional_channels="
            f"{{point_vector: {{path: [{lists['tracking']}], depth: 3}}}}",
            "training.batch_size=48", "training.max_epochs=1000000",
            f"training.max_steps={args.steps}",
            "training.early_stopping=false",
            "training.image_log_freq=1000000",
            "training.log_every_n_steps=200",
            f"training.output_dir={run_dir}/out", f"run.dir={run_dir}",
            "model.discriminator.args.num_filters=8", *DEMO_GENERATOR,
            *(["training.accelerator=cpu"] if cpu else [])]))

    for name, scene in zip(STYLES, scenes):
        StyleTransferInference(compose(CONFIG, "inference", overrides=[
            f"paths.checkpoint={ckpt}", f"paths.input_dir={scene}/input",
            f"paths.mask_dir={scene}/mask",
            f"paths.output_dir={out / f'stylized_{name}'}",
            "paths.additional_channels="
            f"{{point_vector: {{path: {scene}/tracking, depth: 3}}}}",
            "data.patch_size=32", "inference.precision=32", *DEMO_GENERATOR,
            *(["inference.use_gpu=false"] if cpu else [])])
        ).process_directory()
        # each style's rendering of this scene's content
        for style in STYLES:
            xref = out / f"xref_{name}_as_{style}"
            xref.mkdir(exist_ok=True)
            for p in sorted((scene / "input").glob("*.png")):
                x = decode_rgb_uint8(p).astype(np.float32) / 255.0
                encode_png(xref / p.name, render(x, style))

    matrix = {name: psnr_row(out, name, scene)
              for name, scene in zip(STYLES, scenes)}
    for name, row in matrix.items():
        print(f"[multistyle] {name}: {row}", flush=True)
    payload = {"steps": args.steps, "matrix": matrix,
               "own_style_wins_every_row": all(
                   matrix[s][s] == max(row.values())
                   for s, row in matrix.items()),
               "wall_seconds": round(time.time() - t0, 1),
               "device": card_line(args.device)}
    jax = {}
    if JAX_RESULTS.exists():
        jax = json.loads(JAX_RESULTS.read_text())
    payload["jax_run"] = jax
    (out / "multistyle.json").write_text(json.dumps(payload, indent=1))
    text = report(payload, jax, args)
    (out / "REPORT.md").write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
