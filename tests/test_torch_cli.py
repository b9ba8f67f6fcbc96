"""The port's CLIs (``patch_toon_tpu_torch/cli.py``, ``train_cli.py``)
without PyYAML, and the watch branch with its SIGTERM handler.

The CLIs read ``config/`` through the port's own YAML reader: a subprocess
that cannot import yaml composes, config-group choices included, exactly
what ``compose`` gives here, and what ``config/defaults.py`` composed with
the same overrides gives; it serves a watched directory through
``generator_torch.py``'s ``main`` (files aged, poll 0.05 s, idle timeout
0.3 s: no wait on the clock). ``train_torch.py`` trains 2 steps on the CPU
from a sample scene it generates, with yaml, PIL and jax unimportable, and
``generator_torch.py model=default`` serves the checkpoint in the same way,
bitwise the in-process engine. No module of the port, nor either entry
point, imports a JAX-side file. The watch branch installs a SIGTERM
handler that raises ``KeyboardInterrupt`` (the graceful path), skips it
off the main thread, and puts the previous one back.
"""

import json
import logging
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu_torch import cli
from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.models.generator import GeneratorJ

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

OVERRIDES = [
    "paths.checkpoint=/data/run/last.ckpt", "paths.input_dir=/data/in",
    "paths.additional_channels={}", "inference.precision=32_fast",
    "inference.use_gpu=false", "inference.watch.enabled=true",
    "inference.watch.poll_seconds=0.1", "+inference.watch.max_attempts=5",
    "inference.watch.idle_timeout_seconds=2.5",
    "model.generator.args.filters=[4,8,8,8,8,4]",
    "inference.temporal.flow_dir=null", "inference.crop_readback=off",
    "inference.temporal.file_format='%04d'", "~inference.quantize",
    "inference.overlap_percent=25", "inference.xla_options={a: 1, b: x}",
    "+inference.note=yes", "data.patch_size=16"]

NO_YAML = "import sys; sys.modules['yaml'] = None\n"


def test_composition_without_yaml_equals_the_yaml_one():
    """A process where ``import yaml`` fails composes, through
    ``cli.load_config``, exactly what ``compose`` gives here from the YAML
    files, a config-group choice included; ``config/defaults.py`` with the
    same overrides gives the same tree."""
    argv = ["model=default", *OVERRIDES]
    code = NO_YAML + (
        "import json, logging\n"
        "logging.basicConfig(level=logging.INFO)\n"
        "from patch_toon_tpu_torch import cli\n"
        f"cfg = cli.load_config({argv!r})\n"
        "print(json.dumps(cfg, sort_keys=True))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    want = compose(REPO / "config", "inference", overrides=argv)
    assert got == json.loads(json.dumps(want, sort_keys=True))
    assert "PyYAML" not in res.stderr
    # config/defaults.py holds the same composition, its interpolations
    # the YAML's own
    import yaml

    from patch_toon_tpu_torch.config.compose import compose_without_yaml
    from patch_toon_tpu_torch.config.defaults import (
        INFERENCE,
        INFERENCE_LINKS,
    )

    assert compose_without_yaml(INFERENCE, OVERRIDES, INFERENCE_LINKS) \
        == want
    raw = yaml.safe_load((REPO / "config" / "inference.yaml").read_text())
    links = {f"{k}.{j}": v for k, sub in raw.items() if isinstance(sub, dict)
             for j, v in sub.items() if isinstance(v, str) and "${" in v}
    assert links == INFERENCE_LINKS
    with pytest.raises(ValueError, match="config group"):
        compose_without_yaml(INFERENCE, ["model=default"])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    make_scene(str(root / "scene"), frames=3, height=40, width=56, seed=17)
    t = time.time() - 10
    for f in (root / "scene").rglob("*"):
        os.utime(f, (t, t))
    torch.manual_seed(18)
    model = GeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}},
               root / "gen.ckpt")
    return root


def _args(root, out, *extra):
    s = root / "scene"
    return [f"paths.checkpoint={root / 'gen.ckpt'}",
            f"paths.input_dir={s / 'input'}", f"paths.mask_dir={s / 'mask'}",
            f"paths.output_dir={out}",
            f"paths.additional_channels.point_vector.path={s / 'tracking'}",
            "inference.use_gpu=false", "inference.precision=32",
            "model.generator.args.filters=[4,8,8,8,8,4]",
            "model.generator.args.resnet_blocks=1", "data.patch_size=16",
            *extra]


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


def test_watch_through_the_cli_without_yaml(scene, tmp_path):
    """``generator_torch.py``'s ``main`` with PyYAML unimportable, a
    config-group choice and ``inference.watch.enabled``: the watched
    directory is served until the idle timeout, the files equal a one-shot
    run's."""
    args = _args(scene, tmp_path / "watch", "model=default",
                 "inference.watch.enabled=true",
                 "inference.watch.poll_seconds=0.05",
                 "inference.watch.idle_timeout_seconds=0.3")
    code = NO_YAML + (
        "import runpy\n"
        f"sys.argv = ['generator_torch.py'] + {args!r}\n"
        "runpy.run_path('generator_torch.py', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Watch stopped" in res.stdout
    StyleTransferInference(compose(REPO / "config", "inference",
                                   overrides=_args(scene, tmp_path / "once"))
                           ).process_directory()
    got, want = _read(tmp_path / "watch"), _read(tmp_path / "once")
    assert len(got) == 3 and got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_watch_branch_installs_the_sigterm_handler(scene, tmp_path,
                                                   monkeypatch, caplog):
    """With ``inference.watch.enabled`` the CLI calls ``watch_directory``
    under a SIGTERM handler that raises ``KeyboardInterrupt`` (so a stop
    request takes Ctrl-C's path), and restores the previous handler after;
    off the main thread ``signal.signal`` raises ValueError, the handler is
    skipped and the watch still runs; without the knob it serves the
    directory once."""
    seen = []

    def fake_watch(self):
        seen.append(signal.getsignal(signal.SIGTERM))
        if threading.current_thread() is threading.main_thread():
            try:
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(5)  # the handler interrupts this
                seen.append("no interrupt")
            except KeyboardInterrupt:
                seen.append("interrupted")

    monkeypatch.setattr(StyleTransferInference, "watch_directory",
                        fake_watch)
    before = signal.getsignal(signal.SIGTERM)
    args = _args(scene, tmp_path / "w", "inference.watch.enabled=true")
    assert cli.main(args) == 0
    assert seen == [cli._sigterm, "interrupted"]
    assert signal.getsignal(signal.SIGTERM) is before
    seen.clear()
    worker = threading.Thread(target=lambda: seen.append(cli.main(args)))
    worker.start()
    worker.join(timeout=120)
    assert seen == [before, 0]  # no handler off the main thread
    with caplog.at_level(logging.INFO, "patch_toon_tpu_torch"):
        assert cli.main(_args(scene, tmp_path / "once")) == 0
    assert len(list((tmp_path / "once").glob("*.png"))) == 3


# a process that cannot import PyYAML, Pillow, jax or the JAX package; it
# runs an entry point as __main__, then names every module it loaded from
# tools/
BLOCKED = ("import sys\n"
           "for name in ('yaml', 'PIL', 'jax', 'patch_toon_tpu'):\n"
           "    sys.modules[name] = None\n")
TINY = ["model.generator.args.filters=[8,16,32,32,32,16]",
        "model.generator.args.resnet_blocks=2", "data.patch_size=32"]


def _entry_point(script, args, cwd):
    code = BLOCKED + (
        "import json, runpy\n"
        f"sys.argv = [{script!r}] + {args!r}\n"
        "try:\n"
        f"    runpy.run_path({str(REPO / script)!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "tools = [m.__file__ for m in list(sys.modules.values())\n"
        "         if '/tools/' in (getattr(m, '__file__', None) or '')]\n"
        "print('TOOLS ' + json.dumps(tools))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("TOOLS ")]
    assert json.loads(line[-1][len("TOOLS "):]) == []
    return res


def test_train_and_serve_through_the_clis_without_yaml_or_pil(tmp_path):
    """``train_torch.py`` from a directory without the sample scene: the
    CLI generates the 7-frame scene under ``test_dataset/``, trains 2 steps
    on the CPU and writes ``config.yaml`` (the bytes PyYAML writes for the
    resolved tree) and the ``.ckpt`` files; ``generator_torch.py
    model=default`` then serves the scene from ``last.ckpt``, every frame
    bitwise an in-process engine on the same config."""
    import yaml

    from patch_toon_tpu_torch.config.compose import to_container

    run = tmp_path / "run"
    train_args = ["training.accelerator=cpu", "training.max_steps=2",
                  "training.batch_size=4", "training.log_every_n_steps=1",
                  "model.discriminator.args.num_filters=8",
                  f"run.dir={run}", *TINY]
    res = _entry_point("train_torch.py", train_args, tmp_path)
    scene = tmp_path / "test_dataset" / "PlatinumChan_x0.5_train"
    assert "generating a synthetic one" in res.stdout
    assert "Training complete" in res.stdout
    for sub in ("input", "output", "mask", "tracking"):
        assert len(list((scene / sub).glob("*.png"))) == 7, sub
    assert sorted(p.name for p in (run / "checkpoints").glob("*.ckpt")) \
        == ["epoch_0000.ckpt", "last.ckpt"]
    tree = to_container(compose(REPO / "config", "config",
                                overrides=train_args))
    assert (run / "config.yaml").read_text() \
        == yaml.safe_dump(tree, sort_keys=False)

    serve = ["model=default",
             f"paths.checkpoint={run / 'checkpoints' / 'last.ckpt'}",
             f"paths.input_dir={scene / 'input'}",
             f"paths.mask_dir={scene / 'mask'}",
             f"paths.output_dir={tmp_path / 'served'}",
             f"paths.additional_channels.point_vector.path="
             f"{scene / 'tracking'}",
             "inference.use_gpu=false", "inference.precision=32", *TINY]
    res = _entry_point("generator_torch.py", serve, tmp_path)
    assert "Inference completed: 7 frames" in res.stdout
    once = serve[:4] + [f"paths.output_dir={tmp_path / 'once'}"] + serve[5:]
    StyleTransferInference(compose(REPO / "config", "inference",
                                   overrides=once)).process_directory()
    got, want = _read(tmp_path / "served"), _read(tmp_path / "once")
    assert len(got) == 7 and got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_no_port_module_imports_the_jax_side():
    """Every module of ``patch_toon_tpu_torch/``, the port's tools, both
    entry points and ``chip_smoke.py`` import neither yaml, jax, the JAX
    package nor a JAX-side file of ``tools/`` (read from their source)."""
    import ast

    jax_tools = {p.stem for p in (REPO / "tools").glob("*.py")
                 if not p.stem.endswith("_torch")}
    banned = {"yaml", "jax", "jaxlib", "flax", "optax", "orbax",
              "patch_toon_tpu"} | jax_tools
    files = [*sorted((REPO / "patch_toon_tpu_torch").rglob("*.py")),
             *sorted((REPO / "tools").glob("*_torch.py")),
             REPO / "train_torch.py", REPO / "generator_torch.py",
             REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            bad += [f"{f.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in banned]
    assert len(files) > 60 and not bad, bad
