"""Coloured console logging (the port's copy of the JAX package's
``patch_toon_tpu/utils/logging.py``): ``[HH:MM:SS][name][LEVEL] - msg``,
the level coloured by severity and the logger's name in cyan, as the
reference's Hydra colorlog overrides print.

Plain ``logging``: colour only when the stream is a TTY, so piped and file
output stays clean; ``NO_COLOR`` (any value) forces it off and
``FORCE_COLOR`` forces it on. No colorlog or Hydra dependency.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVEL_COLORS = {
    logging.DEBUG: "\033[35m",     # magenta
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[1;31m",
}
_CYAN = "\033[36m"
_RESET = "\033[0m"


class ColorFormatter(logging.Formatter):
    """``[HH:MM:SS][name][LEVEL] - msg``, colorlog-style."""

    def __init__(self, use_color: bool):
        super().__init__(datefmt="%H:%M:%S")
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        t = self.formatTime(record, self.datefmt)
        name, level = record.name, record.levelname
        if self.use_color:
            c = _LEVEL_COLORS.get(record.levelno, "")
            name = f"{_CYAN}{name}{_RESET}"
            level = f"{c}{level}{_RESET}"
        msg = record.getMessage()
        if record.exc_info:
            msg = f"{msg}\n{self.formatException(record.exc_info)}"
        return f"[{t}][{name}][{level}] - {msg}"


def use_color(stream=None) -> bool:
    """``NO_COLOR`` off, else ``FORCE_COLOR`` on, else whether ``stream``
    (stderr by default) is a TTY."""
    if os.environ.get("NO_COLOR"):
        return False
    if os.environ.get("FORCE_COLOR"):
        return True
    stream = sys.stderr if stream is None else stream
    return hasattr(stream, "isatty") and stream.isatty()


def configure_logging(level: int = logging.INFO) -> None:
    """Install the coloured handler on the root logger at ``level``,
    replacing any handler installed before it (a library import may have
    put its own there first, which would swallow these lines)."""
    handler = logging.StreamHandler()
    handler.setFormatter(ColorFormatter(use_color(handler.stream)))
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(level)
