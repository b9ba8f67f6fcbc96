"""Minimal Hydra-compatible config composition (the port's own copy).

Copy of ``patch_toon_tpu/config/compose.py``: a root YAML with a
``defaults:`` list of group configs and ``_self_`` positioning,
``${a.b.c}`` interpolation with the ``now:`` and ``oc.env:`` resolvers,
CLI dotlist overrides (``a.b=v``, ``+a.b=v``, ``~a.b``, ``group=name``) and
attribute access through :class:`ConfigNode`. The YAML files, the override
values and the run directory's snapshot are read and written by the port's
own :mod:`yamlio` (what PyYAML's ``safe_load`` and ``safe_dump`` give), so
nothing here needs PyYAML. ``defaults.INFERENCE`` holds the composed
inference defaults as a plain dict, which :func:`compose_without_yaml`
overrides as :func:`compose` does.
"""

from __future__ import annotations

import copy
import datetime
import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from patch_toon_tpu_torch.config import yamlio

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


class ConfigNode(dict):
    """A dict with attribute access, mimicking the DictConfig surface we use."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo: dict) -> "ConfigNode":
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(obj: Any) -> Any:
    """Recursively convert plain dicts to ConfigNodes."""
    if isinstance(obj, dict):
        return ConfigNode({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def to_container(obj: Any, resolve: bool = True) -> Any:  # noqa: ARG001
    """Convert ConfigNodes back to plain dicts/lists (values already resolved)."""
    if isinstance(obj, dict):
        return {k: to_container(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_container(v) for v in obj]
    return obj


def load_yaml(path: Union[str, Path]) -> ConfigNode:
    return _wrap(yamlio.load(Path(path).read_text()) or {})


def save(cfg: ConfigNode, path: Union[str, Path]) -> None:
    """Write the resolved config as YAML (the run directory's snapshot)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(yamlio.dump(to_container(cfg)))


def merge(base: ConfigNode, other: ConfigNode) -> ConfigNode:
    """Deep-merge ``other`` into a copy of ``base`` (other wins)."""
    out = copy.deepcopy(base)
    for k, v in other.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _select(cfg: Any, dotted: str) -> Any:
    node = cfg
    for part in dotted.split("."):
        if isinstance(node, list):
            node = node[int(part)]
        elif isinstance(node, dict):
            if part not in node:
                raise KeyError(f"Interpolation key not found: {dotted!r}")
            node = node[part]
        else:
            raise KeyError(f"Interpolation key not found: {dotted!r}")
    return node


def _resolve_value(value: Any, root: ConfigNode, stack: Tuple[str, ...]) -> Any:
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value.strip())
        if full:
            return _resolve_ref(full.group(1), root, stack)

        def sub(m: "re.Match[str]") -> str:
            return str(_resolve_ref(m.group(1), root, stack))

        return _INTERP_RE.sub(sub, value)
    return value


def _resolve_ref(expr: str, root: ConfigNode, stack: Tuple[str, ...]) -> Any:
    expr = expr.strip()
    if expr.startswith("now:"):
        return datetime.datetime.now().strftime(expr[len("now:"):])
    if expr.startswith("oc.env:"):
        import os

        parts = expr[len("oc.env:"):].split(",", 1)
        return os.environ.get(parts[0], parts[1] if len(parts) > 1 else None)
    if expr in stack:
        raise ValueError(f"Interpolation cycle: {' -> '.join(stack + (expr,))}")
    target = _select(root, expr)
    return _resolve_node(target, root, stack + (expr,))


def _resolve_node(node: Any, root: ConfigNode, stack: Tuple[str, ...]) -> Any:
    if isinstance(node, dict):
        return ConfigNode({k: _resolve_node(v, root, stack) for k, v in node.items()})
    if isinstance(node, list):
        return [_resolve_node(v, root, stack) for v in node]
    return _resolve_value(node, root, stack)


def resolve(cfg: ConfigNode) -> ConfigNode:
    """Eagerly resolve every interpolation in the tree."""
    return _resolve_node(cfg, cfg, ())


def _parse_override_value(text: str) -> Any:
    if text == "":
        return None
    return yamlio.load(text)


def apply_overrides(cfg: ConfigNode, overrides: List[str]) -> ConfigNode:
    """Apply dotlist overrides (``a.b=v``, ``+a.b=v``, ``~a.b``) to
    ``cfg`` in place, each value read as ``yaml.safe_load`` reads it; ->
    the resolved tree."""
    for ov in overrides:
        if ov.startswith("~"):
            _delete_dotted(cfg, ov[1:].split("=", 1)[0])
            continue
        allow_new = ov.startswith("+")
        body = ov[1:] if allow_new else ov
        if "=" not in body:
            raise ValueError(f"Malformed override (need key=value): {ov!r}")
        key, text = body.split("=", 1)
        _set_dotted(cfg, key, _parse_override_value(text),
                    allow_new=allow_new or True)
    return resolve(cfg)


def _set_dotted(cfg: ConfigNode, dotted: str, value: Any, allow_new: bool) -> None:
    parts = dotted.split(".")
    node: Any = cfg
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            if not allow_new and part not in node:
                raise KeyError(
                    f"Override key {dotted!r} not found (use +{dotted} to add)"
                )
            node[part] = ConfigNode()
        node = node[part]
    leaf = parts[-1]
    if not allow_new and leaf not in node:
        raise KeyError(f"Override key {dotted!r} not found (use +{dotted} to add)")
    node[leaf] = _wrap(value)


def _delete_dotted(cfg: ConfigNode, dotted: str) -> None:
    parts = dotted.split(".")
    node: Any = cfg
    for part in parts[:-1]:
        node = node[part]
    node.pop(parts[-1], None)


def _split_defaults(
    defaults: List[Any],
) -> Iterator[Tuple[Optional[str], Optional[str]]]:
    """Yield (group, name) pairs; (_self_, None) marks self-position."""
    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                yield ("_self_", None)
            continue  # bare string groups unsupported / ignored
        if isinstance(entry, dict):
            for key, name in entry.items():
                key = str(key)
                if key.startswith("override hydra") or key.startswith("hydra"):
                    continue  # hydra's own logging config: no-op here
                if key.startswith("override "):
                    key = key[len("override "):]
                yield (key, str(name) if name is not None else None)


def compose(
    config_dir: Union[str, Path],
    config_name: str = "config",
    overrides: Optional[List[str]] = None,
) -> ConfigNode:
    """Compose a config exactly the way the reference's Hydra tree expects.

    Reference semantics covered: config/config.yaml:2-9 (defaults with
    ``_self_`` first so group configs win over the root file's keys) and
    config/inference.yaml:2-7 (no ``_self_`` -> implicit ``_self_`` last, so
    the root file's inline keys win over group defaults).
    """
    config_dir = Path(config_dir)
    overrides = list(overrides or [])

    root_file = config_dir / f"{config_name}.yaml"
    root_cfg = load_yaml(root_file)
    defaults = list(_split_defaults(root_cfg.pop("defaults", [])))
    root_cfg.pop("hydra", None)  # run-dir policy handled by the caller

    # group selection overrides (no dot in the key, no +/~ prefix)
    group_choice: Dict[str, str] = {}
    value_overrides: List[str] = []
    for ov in overrides:
        if ov.startswith(("+", "~")) or "=" not in ov or "." in ov.split("=", 1)[0]:
            value_overrides.append(ov)
            continue
        key, name = ov.split("=", 1)
        if (config_dir / key).is_dir():
            group_choice[key] = name
        else:
            value_overrides.append(ov)

    if not any(g == "_self_" for g, _ in defaults):
        defaults.append(("_self_", None))  # Hydra's implicit-last behavior

    cfg = ConfigNode()
    seen_groups = set()
    for group, name in defaults:
        if group == "_self_":
            cfg = merge(cfg, root_cfg)
            continue
        seen_groups.add(group)
        name = group_choice.get(group, name)
        if name is None:
            continue
        group_file = config_dir / group / f"{name}.yaml"
        if not group_file.exists():
            raise FileNotFoundError(f"Config group file not found: {group_file}")
        sub = load_yaml(group_file)
        sub.pop("defaults", None)
        cfg = merge(cfg, ConfigNode({group: sub}))

    for group, name in group_choice.items():
        if group not in seen_groups:  # +group=name style addition
            sub = load_yaml(config_dir / group / f"{name}.yaml")
            cfg = merge(cfg, ConfigNode({group: sub}))

    return apply_overrides(cfg, value_overrides)


def compose_without_yaml(defaults: Dict[str, Any],
                         overrides: Optional[List[str]] = None,
                         links: Optional[Dict[str, str]] = None
                         ) -> ConfigNode:
    """A composed tree kept as Python (``config/defaults.py``) with the
    same dotlist overrides as :func:`compose`. ``links``
    (dotted key -> ``${...}``) puts the YAML's interpolations back first,
    so an override of their source carries through. A config-group choice
    (``group=name``) needs the YAML files and raises."""
    cfg = _wrap(copy.deepcopy(defaults))
    for key, ref in (links or {}).items():
        _set_dotted(cfg, key, ref, allow_new=False)
    for ov in overrides or []:
        if not ov.startswith(("+", "~")) and "=" in ov \
                and "." not in ov.split("=", 1)[0]:
            raise ValueError(f"{ov!r} chooses a config group, which needs "
                             "the YAML files (compose)")
    return apply_overrides(cfg, list(overrides or []))

