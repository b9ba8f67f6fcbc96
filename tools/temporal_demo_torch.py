#!/usr/bin/env python
"""The temporal-guide demonstration with the PyTorch port, end to end.

    python tools/temporal_demo_torch.py [--steps 1500] [--frames 12] \
        [--height 96] [--width 128] [--device cuda|cpu] \
        [--out docs/temporal_torch]

The counterpart of ``tools/temporal_demo.py``, through the port's own
entry points and tools:

1. a moving-blob scene (``data/sample_scene.py``, seed 5) and a copy of
   its inputs with per-frame sensor noise (numpy seed 99, sigma
   ``--noise``) for serving;
2. the flows of the clean frames (``tools/optical_flow_torch.py``) and
   the training-time temporal guides (``tools/temporal_guide_torch.py``);
3. three trainings through ``train_cli.train(compose(...))`` at the JAX
   demo's overrides (3 residual blocks, filters [16, 32, 64, 64, 64, 32],
   D 8 filters, batch 32 of 32x32 patches, ``--steps`` steps): PLAIN (RGB
   input), TEMPORAL (RGB + 3 temporal-guide channels) and TEMPORAL with
   guide dropout (``--guide_dropout_p``);
4. serving at precision 32 through ``StyleTransferInference``: plain,
   the temporal chain (its own previous output warped by the flows), both
   temporal checkpoints again with the chain broken (no flow directory:
   the guide is the frame's RGB on every frame);
5. inside the mask, per sequence: flicker = mean |out_i - warp(out_{i-1},
   flow_i)|, warped PSNR (the same comparison as PSNR) and target PSNR
   against the stylized targets, the warp being ``ops/flow.py``'s.

Writes ``temporal_demo.json`` and ``REPORT.md`` into ``--out``, the JAX
package's committed figures (``docs/temporal/temporal_demo.json``) beside
the port's; the scene, the runs and the stylized frames go under ``--out``
too. Wall seconds are given with the card's name and power limit
(``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from optical_flow_torch import OpticalFlowCalculator  # noqa: E402
from temporal_guide_torch import build_temporal_guides  # noqa: E402

from patch_toon_tpu_torch import train_cli  # noqa: E402
from patch_toon_tpu_torch.config.compose import compose  # noqa: E402
from patch_toon_tpu_torch.data.io import (  # noqa: E402
    decode_rgb_uint8,
    load_luma,
)
from patch_toon_tpu_torch.data.sample_scene import make_scene  # noqa: E402
from patch_toon_tpu_torch.infer.engine import (  # noqa: E402
    StyleTransferInference,
)
from patch_toon_tpu_torch.native.frameio import encode_png  # noqa: E402
from patch_toon_tpu_torch.ops.flow import warp_image  # noqa: E402

CONFIG = REPO / "config"
JAX_RESULTS = REPO / "docs" / "temporal" / "temporal_demo.json"
ROWS = ("input_floor", "plain", "temporal", "temporal_gd",
        "temporal_broken", "temporal_gd_broken")
# the JAX demo's generator (tools/temporal_demo.py:77-92); a .ckpt file
# carries no generator args for the engine, which takes them from the
# config, so serving names them too (JAX's Orbax directory carries them)
DEMO_GENERATOR = ["model.generator.args.resnet_blocks=3",
                  "model.generator.args.filters=[16,32,64,64,64,32]"]
DEMO_TRAINING = ["data.patch_size=32", "training.max_epochs=1000000",
                 "training.early_stopping=false",
                 "training.image_log_freq=1000000",
                 "training.log_every_n_steps=200",
                 "model.discriminator.args.num_filters=8", *DEMO_GENERATOR]


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build_scene(scene: Path, frames: int, h: int, w: int,
                noise: float) -> None:
    """The clean scene for training and flows; a noisy copy of its inputs
    for serving (tools/temporal_demo.py::build_scene)."""
    make_scene(str(scene), frames=frames, height=h, width=w, seed=5)
    (scene / "input_noisy").mkdir(exist_ok=True)
    rng = np.random.default_rng(99)
    for p in sorted((scene / "input").glob("*.png")):
        img = decode_rgb_uint8(p).astype(np.float32)
        img = img + rng.normal(0.0, noise * 255.0, img.shape)
        encode_png(scene / "input_noisy" / p.name,
                   np.clip(np.round(img), 0, 255).astype(np.uint8))


def train_ckpt(scene: Path, run_dir: Path, steps: int, temporal: bool,
               device: str, batch: int = 32, gd_p: float = 0.0) -> Path:
    ckpt = run_dir / "checkpoints" / "last.ckpt"
    if ckpt.exists():
        return ckpt
    over = [f"data.dir_pre={scene}/input", f"data.dir_post={scene}/output",
            f"data.dir_mask={scene}/mask", f"training.batch_size={batch}",
            f"training.max_steps={steps}",
            f"training.output_dir={run_dir}/out", f"run.dir={run_dir}",
            *DEMO_TRAINING]
    if torch.device(device).type == "cpu":
        over.append("training.accelerator=cpu")
    if temporal:
        over.append("data.additional_channels="
                    f"{{temporal: {{path: {scene}/temporal, depth: 3}}}}")
        if gd_p > 0.0:
            over.append(f"training.guide_dropout_p={gd_p}")
    else:
        over.append("data.additional_channels={}")
    train_cli.train(compose(CONFIG, "config", overrides=over))
    return ckpt


def stylize(scene: Path, ckpt: Path, out_dir: Path, temporal: bool,
            device: str, broken_chain: bool = False) -> None:
    """Serve the noisy inputs; ``broken_chain`` serves the temporal
    checkpoint with no flow directory, so the guide is the frame's RGB on
    every frame."""
    n_in = len(list((scene / "input_noisy").glob("*.png")))
    if len(list(out_dir.glob("*.png"))) == n_in:
        return
    over = [f"paths.checkpoint={ckpt}",
            f"paths.input_dir={scene}/input_noisy",
            f"paths.mask_dir={scene}/mask", f"paths.output_dir={out_dir}",
            "paths.additional_channels={}", "data.patch_size=32",
            "inference.precision=32", *DEMO_GENERATOR]
    if torch.device(device).type == "cpu":
        over.append("inference.use_gpu=false")
    if temporal:
        over += ["+inference.temporal.enabled=true",
                 "+inference.temporal.depth=3"]
        if not broken_chain:
            over.append(f"+inference.temporal.flow_dir={scene}/flow_bwd")
    StyleTransferInference(compose(CONFIG, "inference",
                                   overrides=over)).process_directory()


def sequence_metrics(frames_dir: Path, scene: Path, names) -> dict:
    """Flicker and stability of a stylized (or input) sequence, inside
    the mask; flows by the frame's position in the sorted stream."""
    flick, wpsnr, tpsnr = [], [], []
    prev = None
    for i, n in enumerate(names):
        cur = decode_rgb_uint8(frames_dir / n).astype(np.float32)
        msk = load_luma(scene / "mask" / n).astype(np.float32) > 127
        gt = decode_rgb_uint8(scene / "output" / n).astype(np.float32)
        mse_t = ((cur - gt) ** 2)[msk].mean()
        tpsnr.append(10 * np.log10(255.0 ** 2 / max(mse_t, 1e-9)))
        if prev is not None:
            flow = np.load(str(scene / "flow_bwd" / f"{i:03d}.npy"))
            warped = warp_image(torch.from_numpy(prev / 255.0),
                                torch.from_numpy(flow)).numpy() * 255.0
            diff = np.abs(cur - warped)[msk]
            flick.append(float(diff.mean()))
            mse = float((diff ** 2).mean())
            wpsnr.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-9)))
        prev = cur
    return {"flicker_mean_abs": round(float(np.mean(flick)), 3),
            "warped_psnr_db": round(float(np.mean(wpsnr)), 2),
            "target_psnr_db": round(float(np.mean(tpsnr)), 2)}


def report(r: dict, jax: dict, args) -> str:
    def cells(row, d):
        if row not in d:
            return "— | — | —"
        m = d[row]
        target = "—" if row == "input_floor" else m["target_psnr_db"]
        return f"{m['flicker_mean_abs']} | {m['warped_psnr_db']} | {target}"

    labels = {"input_floor": "input (noise floor)",
              "plain": "plain checkpoint",
              "temporal": "temporal checkpoint",
              "temporal_gd": "temporal + guide dropout "
                             f"p={r['guide_dropout_p']}",
              "temporal_broken": "temporal, chain broken",
              "temporal_gd_broken": "temporal + guide dropout, chain broken"}
    plain, temp = r["plain"]["flicker_mean_abs"], \
        r["temporal"]["flicker_mean_abs"]
    change = (temp / max(plain, 1e-9) - 1) * 100
    if temp < plain:
        verdict = (f"**On the port, temporal mode cuts flicker by "
                   f"{-change:.0f}%** ({plain} → {temp}; warped PSNR "
                   f"{r['plain']['warped_psnr_db']} → "
                   f"{r['temporal']['warped_psnr_db']} dB).")
    else:
        verdict = (f"**On the port, temporal mode does not cut flicker**: "
                   f"{plain} → {temp} ({change:+.0f}%; warped PSNR "
                   f"{r['plain']['warped_psnr_db']} → "
                   f"{r['temporal']['warped_psnr_db']} dB).")
    if jax:
        jp, jt = jax["plain"]["flicker_mean_abs"], \
            jax["temporal"]["flicker_mean_abs"]
        verdict += (f" The JAX package's run: {jp} → {jt} "
                    f"({(jt / jp - 1) * 100:+.0f}%).")
    lines = [
        "# Temporal-guide mode on the PyTorch port: flicker",
        "",
        f"`tools/temporal_demo_torch.py --steps {r['steps']} --frames "
        f"{r['frames']}`: a synthetic moving-blob scene ({r['frames']} "
        f"frames {args.height}x{args.width}, seed 5); training and flows on "
        "the clean frames, per-frame sensor noise (sigma "
        f"{r['noise_sigma']}) on the inputs at serving time. Three "
        f"checkpoints of {r['steps']} steps each through "
        "`train_cli.train` (the JAX demo's overrides: 3 residual blocks, "
        "filters [16, 32, 64, 64, 64, 32], batch 32 of 32x32 patches), "
        "served at precision 32 through `StyleTransferInference`; flows by "
        "`tools/optical_flow_torch.py`, guides by "
        "`tools/temporal_guide_torch.py`, the warp of the metrics "
        "`ops/flow.py::warp_image`.",
        "",
        "Flicker = mean |out_i − warp(out_{i−1}, flow_i)| inside the mask "
        "(lower is stabler); warped PSNR the same comparison as PSNR "
        "(higher is stabler); target PSNR against the stylized targets. "
        "Beside the port's figures, the JAX package's committed run "
        "(`docs/temporal/temporal_demo.json`, same scene recipe and "
        "budget; quality figures only).",
        "",
        "| sequence | port: flicker | port: warped PSNR (dB) | port: target "
        "PSNR (dB) | JAX's run: flicker | JAX's run: warped PSNR | JAX's "
        "run: target PSNR |",
        "|---|---|---|---|---|---|---|",
    ]
    lines += [f"| {labels[row]} | {cells(row, r)} | {cells(row, jax)} |"
              for row in ROWS]
    lines += ["", verdict, "",
              f"Wall time of the whole demo: {r['wall_seconds']} s on "
              f"{r['device']}."]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--guide_dropout_p", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    ap.add_argument("--out", default=str(REPO / "docs" / "temporal_torch"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    scene = out / "scene"
    dev = args.device

    t0 = time.time()
    if not (scene / "input").exists():
        build_scene(scene, args.frames, args.height, args.width, args.noise)
        OpticalFlowCalculator(scene / "input", scene / "flow_fwd",
                              scene / "flow_bwd", scene / "mask",
                              device=dev).calculate_flows()
        build_temporal_guides(str(scene / "input"), str(scene / "output"),
                              str(scene / "flow_bwd"),
                              str(scene / "temporal"), device=dev)
    names = sorted(p.name for p in (scene / "input").glob("*.png"))

    print("[demo] training PLAIN checkpoint ...", flush=True)
    ck_plain = train_ckpt(scene, out / "run_plain", args.steps, False, dev)
    print("[demo] training TEMPORAL checkpoint ...", flush=True)
    ck_temp = train_ckpt(scene, out / "run_temporal", args.steps, True, dev)
    print("[demo] training TEMPORAL+GUIDE-DROPOUT checkpoint ...", flush=True)
    ck_gd = train_ckpt(scene, out / "run_temporal_gd", args.steps, True, dev,
                       gd_p=args.guide_dropout_p)

    print("[demo] stylizing ...", flush=True)
    stylize(scene, ck_plain, out / "stylized_plain", False, dev)
    stylize(scene, ck_temp, out / "stylized_temporal", True, dev)
    stylize(scene, ck_gd, out / "stylized_temporal_gd", True, dev)
    stylize(scene, ck_temp, out / "stylized_temporal_broken", True, dev,
            broken_chain=True)
    stylize(scene, ck_gd, out / "stylized_temporal_gd_broken", True, dev,
            broken_chain=True)

    dirs = {"input_floor": scene / "input_noisy"}
    dirs.update({row: out / f"stylized_{row}" for row in ROWS[1:]})
    results = {row: sequence_metrics(d, scene, names)
               for row, d in dirs.items()}
    results.update({"steps": args.steps, "frames": args.frames,
                    "noise_sigma": args.noise,
                    "guide_dropout_p": args.guide_dropout_p,
                    "wall_seconds": round(time.time() - t0, 1),
                    "device": card_line(dev)})
    jax = {}
    if JAX_RESULTS.exists():
        committed = json.loads(JAX_RESULTS.read_text())
        jax = {row: committed[row] for row in ROWS if row in committed}
    results["jax_run"] = jax
    (out / "temporal_demo.json").write_text(json.dumps(results, indent=1))
    text = report(results, jax, args)
    (out / "REPORT.md").write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
