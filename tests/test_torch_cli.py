"""The port's CLI (``patch_toon_tpu_torch/cli.py``): composition without
PyYAML, and the watch branch with its SIGTERM handler.

Without PyYAML the CLI composes ``config/defaults.py``'s inference defaults
with the same dotlist overrides; a subprocess that cannot import yaml must
give exactly what ``compose`` gives from the YAML files here, and serve a
watched directory through ``generator_torch.py``'s ``main`` (files aged,
poll 0.05 s, idle timeout 0.3 s: no wait on the clock). The watch branch
installs a SIGTERM handler that raises ``KeyboardInterrupt`` (the graceful
path), skips it off the main thread, and puts the previous one back.
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
    files, and says so in one log line."""
    code = NO_YAML + (
        "import json, logging\n"
        "logging.basicConfig(level=logging.INFO)\n"
        "from patch_toon_tpu_torch import cli\n"
        f"cfg = cli.load_config({OVERRIDES!r})\n"
        "print(json.dumps(cfg, sort_keys=True))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    want = compose(REPO / "config", "inference", overrides=OVERRIDES)
    assert got == json.loads(json.dumps(want, sort_keys=True))
    assert res.stderr.count("PyYAML is not installed") == 1
    # the interpolations put back are the YAML's own
    import yaml

    from patch_toon_tpu_torch.config.defaults import INFERENCE_LINKS

    raw = yaml.safe_load((REPO / "config" / "inference.yaml").read_text())
    links = {f"{k}.{j}": v for k, sub in raw.items() if isinstance(sub, dict)
             for j, v in sub.items() if isinstance(v, str) and "${" in v}
    assert links == INFERENCE_LINKS
    with pytest.raises(ValueError, match="config group"):
        from patch_toon_tpu_torch.config.compose import compose_without_yaml
        from patch_toon_tpu_torch.config.defaults import INFERENCE

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
    """``generator_torch.py``'s ``main`` with PyYAML unimportable and
    ``inference.watch.enabled``: the watched directory is served until the
    idle timeout, the files equal a one-shot run's."""
    args = _args(scene, tmp_path / "watch", "inference.watch.enabled=true",
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
    assert "PyYAML is not installed" in res.stderr
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
