"""The transport and compiler knobs: none of them changes an output.

``resolve_transport_knobs`` reads the three the engine acts on as the JAX
engine reads them (``infer/engine.py:180-233``): ``crop_readback`` (read
back only the mask's support box), ``crop_upload`` (``auto`` follows
``crop_readback``: upload only the window of a masked tiled frame) and
``mask_upload`` (``packed``: binary masks go up bit-packed). ``xla_options``
is validated and inert: the port has no XLA compiler. Each refuses what
the JAX package refuses, with the port's own copies of the JAX rules:
``infer/common.py::_parse_crop_knob`` (:96-106), the ``mask_upload`` rule
of ``infer/engine.py`` (:226-233) and
``utils/xla_options.py::resolve_xla_options`` (:37-44).
"""

from __future__ import annotations

from typing import Any, Dict


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
    """``inference.mask_upload`` -> whether binary masks bit-pack."""
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


def resolve_transport_knobs(inf: dict) -> Dict[str, bool]:
    """The four transport knobs, validated as the JAX engine validates
    them when it is built -> {"crop_readback", "crop_upload",
    "mask_packed"}, the engine attributes of the same names."""
    crop_readback = parse_crop_knob(inf.get("crop_readback", "auto"))
    cu = str(inf.get("crop_upload", "auto")).lower()
    crop_upload = crop_readback if cu == "auto" \
        else parse_crop_knob(cu, knob="crop_upload")
    mask_packed = parse_mask_upload(inf.get("mask_upload", "packed"))
    check_xla_options(inf.get("xla_options", "auto"), "inference.xla_options")
    return {"crop_readback": crop_readback, "crop_upload": crop_upload,
            "mask_packed": mask_packed}
