"""The port's console logging (``utils/logging.py``) against the JAX
package's (``patch_toon_tpu/utils/logging.py``), on the CPU.

The same ``[HH:MM:SS][name][LEVEL] - msg`` lines, coloured and plain, for
every level and with a traceback; colour only on a TTY, ``NO_COLOR`` off
and ``FORCE_COLOR`` on as there; the handler that ``generator_torch.py``
and ``train_torch.py`` install; and the engine's DEBUG level under
``inference.debug_mode``, as JAX's ``infer/engine.py:263-266`` sets it.
"""

import io
import logging
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from patch_toon_tpu.utils import logging as jax_logging

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.utils import logging as port_logging

REPO = pathlib.Path(__file__).resolve().parents[1]
LINE = re.compile(r"^\[\d\d:\d\d:\d\d\]\[[\w.]+\]\[[A-Z]+\] - ")


@pytest.fixture
def root_logger():
    """The root logger's handlers and level, put back afterwards."""
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    yield root
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in saved[0]:
        root.addHandler(h)
    root.setLevel(saved[1])


def _record(level, msg="step %d done", exc=None):
    rec = logging.LogRecord("patch_toon_tpu_torch.infer", level, __file__, 1,
                            msg, (3,), exc)
    rec.created = 1_700_000_000.0
    return rec


@pytest.mark.parametrize("color", [False, True])
def test_lines_equal_the_jax_formatter(color):
    ours = port_logging.ColorFormatter(color)
    theirs = jax_logging.ColorFormatter(color)
    try:
        raise ValueError("boom")
    except ValueError:
        exc = sys.exc_info()
    for level in (logging.DEBUG, logging.INFO, logging.WARNING,
                  logging.ERROR, logging.CRITICAL):
        for e in (None, exc):
            got = ours.format(_record(level, exc=e))
            assert got == theirs.format(_record(level, exc=e))
            assert ("\033[" in got) == color
            if not color:
                assert LINE.match(got) and "step 3 done" in got


def test_colour_follows_tty_and_the_environment(monkeypatch):
    class Tty(io.StringIO):
        def isatty(self):
            return True

    for k in ("NO_COLOR", "FORCE_COLOR"):
        monkeypatch.delenv(k, raising=False)
    assert port_logging.use_color(Tty()) is True
    assert port_logging.use_color(io.StringIO()) is False
    monkeypatch.setenv("FORCE_COLOR", "1")
    assert port_logging.use_color(io.StringIO()) is True
    monkeypatch.setenv("NO_COLOR", "1")  # NO_COLOR wins, as in JAX
    assert port_logging.use_color(Tty()) is False


@pytest.mark.parametrize("env,colored", [({}, False),
                                         ({"FORCE_COLOR": "1"}, True),
                                         ({"NO_COLOR": "1",
                                           "FORCE_COLOR": "1"}, False)])
def test_configured_handler_in_a_process(env, colored):
    """configure_logging in a fresh process writing to a pipe (no TTY):
    one handler replaces basicConfig's, lines in the JAX format."""
    code = ("import logging; logging.basicConfig(); "
            "from patch_toon_tpu_torch.utils.logging import "
            "configure_logging as c; c(logging.DEBUG); "
            "assert len(logging.getLogger().handlers) == 1; "
            "logging.getLogger('patch_toon_tpu_torch.cli').debug('hi %s', 1)")
    base = {k: v for k, v in os.environ.items()
            if k not in ("NO_COLOR", "FORCE_COLOR")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env={**base, **env, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    line = res.stderr.strip().splitlines()[-1]
    assert line.endswith(" - hi 1")
    assert ("\033[" in line) == colored
    if not colored:
        assert LINE.match(line) and "[patch_toon_tpu_torch.cli][DEBUG]" in line


@pytest.mark.parametrize("debug", [False, True])
def test_debug_mode_sets_debug(tmp_path, root_logger, debug):
    """The engine's logger at DEBUG under debug_mode, INFO otherwise; the
    CLI installs the handler and the root level to match."""
    from patch_toon_tpu_torch import cli

    torch.manual_seed(0)
    gen = GeneratorJ(input_channels=3, filters=(4, 8, 8, 8, 8, 4),
                     resnet_blocks=1, use_bias=True)
    torch.save({"gen": gen.state_dict()}, tmp_path / "g.ckpt")
    over = [f"paths.checkpoint={tmp_path / 'g.ckpt'}",
            f"paths.input_dir={tmp_path}", f"paths.mask_dir={tmp_path}",
            f"paths.output_dir={tmp_path / 'out'}",
            "paths.additional_channels={}", "inference.use_gpu=false",
            "model.generator.args.filters=[4,8,8,8,8,4]",
            "model.generator.args.resnet_blocks=1",
            f"inference.debug_mode={str(debug).lower()}"]
    eng = StyleTransferInference(compose(REPO / "config", "inference",
                                         overrides=over))
    want = logging.DEBUG if debug else logging.INFO
    assert eng.logger.level == want
    assert cli.main(over) == 0  # an empty input directory: 0 frames
    assert root_logger.level == want
    (handler,) = root_logger.handlers
    assert isinstance(handler.formatter, port_logging.ColorFormatter)
