"""A cell's configuration and traffic as the program's own dotted config
overrides (``key.path=value``, values in YAML flow form)."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def flatten(tree: Dict[str, Any], prefix: str) -> List[str]:
    out: List[str] = []
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out += flatten(value, name)
        elif isinstance(value, str):
            out.append(f"{name}={value}")
        else:
            out.append(f"{name}={json.dumps(value)}")
    return out


def model_overrides(config: dict) -> List[str]:
    """The networks, losses and optimizer of a configuration."""
    ov = flatten(config["model"], "model")
    ov += flatten(config["optimizer"], "optimizer")
    ov += flatten(config["training"], "training")
    ov.append(f"data.patch_size={int(config['data']['patch_size'])}")
    return ov


def program_overrides(config: dict, traffic: dict, paths: Dict[str, str],
                      guide_dir: Optional[str]) -> List[str]:
    """Serving: the configuration, the traffic's ``inference`` settings and
    the shot's directories; every guide channel reads ``guide_dir``."""
    ov = model_overrides(config)
    ov += flatten(config.get("inference", {}), "inference")
    ov += flatten(traffic.get("inference", {}), "inference")
    ov += flatten(paths, "paths")
    for name, ch in (config["data"].get("additional_channels") or {}).items():
        ov.append(f"paths.additional_channels.{name}.path={guide_dir}")
        ov.append(f"paths.additional_channels.{name}.depth="
                  f"{int(ch['depth'])}")
    return ov
