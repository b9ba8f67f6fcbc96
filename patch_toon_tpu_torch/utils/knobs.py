"""Validation of the transport and compiler knobs that change no output.

The JAX package acts on these knobs (crop windows, bit-packed masks, XLA
compiler options); the port has no such transport or compiler and keeps
them as no-ops, but refuses what the JAX package refuses, with its own
copies of the JAX rules: ``infer/common.py::_parse_crop_knob`` (:96-106),
the ``mask_upload`` rule of ``infer/engine.py`` (:226-233) and
``utils/xla_options.py::resolve_xla_options`` (:37-44).
"""

from __future__ import annotations

from typing import Any


def parse_crop_knob(value: Any, knob: str = "crop_readback") -> bool:
    """Strict allow-list: a typo such as 'of' or 'disable' raises rather
    than turning cropping on."""
    v = str(value).lower()
    if v in ("auto", "on", "true", "1", "yes"):
        return True
    if v in ("off", "false", "0", "no", "none", "disabled"):
        return False
    raise ValueError(
        f"inference.{knob}={value!r}: expected one of "
        "auto/on/true/1/yes or off/false/0/no/none/disabled")


def parse_mask_upload(value: Any) -> bool:
    """``inference.mask_upload`` -> whether binary masks would bit-pack."""
    v = str(value).lower()
    if v in ("packed", "auto", "bits"):
        return True
    if v == "plane":
        return False
    raise ValueError(f"inference.mask_upload={v!r}: expected packed/plane")


def check_xla_options(value: Any, knob: str) -> None:
    """auto/None/True, none/off/False, or a mapping of options; anything
    else raises (compared with ``==``, as the JAX rule's ``in`` does)."""
    if value in ("none", "off", False) or value in ("auto", None, True) \
            or isinstance(value, dict):
        return
    raise ValueError(f"{knob}={value!r}: Unknown xla_options value")


def check_transport_knobs(inf: dict) -> None:
    """The four inference knobs that change no output here, validated as
    the JAX engine validates them when it is built."""
    parse_crop_knob(inf.get("crop_readback", "auto"))
    cu = str(inf.get("crop_upload", "auto")).lower()
    if cu != "auto":  # "auto" follows crop_readback
        parse_crop_knob(cu, knob="crop_upload")
    parse_mask_upload(inf.get("mask_upload", "packed"))
    check_xla_options(inf.get("xla_options", "auto"), "inference.xla_options")
