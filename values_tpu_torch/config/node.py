"""Attribute-access config tree with ${...} interpolation.

The port's copy of ``values_tpu/config/node.py``.

A minimal, dependency-free replacement for the OmegaConf/Hydra feature subset
the reference relies on (reference: uncertainty_modeling/main.py:33,64-81 and
all YAML configs under uncertainty_modeling/configs/):

- nested dict/list trees loaded from YAML,
- attribute access (``cfg.model.num_classes``) plus mapping access,
- ``${a.b.c}`` interpolation against the tree root,
- ``${oc.env:VAR}`` / ``${oc.env:VAR,default}`` environment interpolation.

Interpolations are resolved eagerly by :func:`resolve` after composition so
the rest of the framework only ever sees plain values.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, List, Optional

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config(dict):
    """A dict with attribute access; values are nested Configs/lists/leaves."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # AttributeError expected by hasattr()
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    # -- conversions ------------------------------------------------------
    def to_container(self) -> Dict[str, Any]:
        """Plain nested dicts/lists (for JSON/pickle serialization)."""
        return _unwrap(self)

    def copy(self) -> "Config":
        return _wrap(_unwrap(self))

    # -- convenience ------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key, default)

    def select(self, dotted: str, default: Any = None) -> Any:
        """Look up ``a.b.c``-style paths; returns default when missing."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            elif isinstance(node, list):
                try:
                    node = node[int(part)]
                except (ValueError, IndexError):
                    return default
            else:
                return default
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, list):
                node = node[int(part)]
                continue
            if part not in node or not isinstance(node[part], (dict, list)):
                node[part] = Config()
            node = node[part]
        if isinstance(node, list):
            node[int(parts[-1])] = _wrap(value)
        else:
            node[parts[-1]] = _wrap(value)


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def make_config(value: Optional[Dict[str, Any]] = None) -> Config:
    return _wrap(dict(value or {}))


def merge(base: Config, other: Any) -> Config:
    """Recursively merge ``other`` into ``base`` (other wins), in place."""
    for key, val in other.items():
        if key in base and isinstance(base[key], dict) and isinstance(val, dict):
            merge(base[key], val)
        else:
            base[key] = _wrap(val)
    return base


def _parse_scalar(text: str) -> Any:
    """Best-effort typed parse of an interpolated/override string."""
    low = text.lower()
    if low in ("null", "none", "~"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


def _resolve_expr(expr: str, root: Config, stack: List[str]) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        payload = expr[len("oc.env:"):]
        if "," in payload:
            var, default = payload.split(",", 1)
            return os.environ.get(var.strip(), _parse_scalar(default.strip()))
        var = payload.strip()
        if var not in os.environ:
            raise KeyError(f"Environment variable '{var}' is not set "
                           f"(required by interpolation ${{{expr}}})")
        return os.environ[var]
    if expr in stack:
        raise ValueError(f"Interpolation cycle through '{expr}'")
    value = root.select(expr, default=_MISSING)
    if value is _MISSING:
        raise KeyError(f"Interpolation key '{expr}' not found in config")
    return _resolve_value(value, root, stack + [expr])


class _Missing:
    pass


_MISSING = _Missing()


def _resolve_value(value: Any, root: Config, stack: List[str]) -> Any:
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value)
        if full:  # whole-string interpolation keeps the native type
            return _resolve_expr(full.group(1), root, stack)
        if "${" in value:
            return _INTERP_RE.sub(
                lambda m: str(_resolve_expr(m.group(1), root, stack)), value)
        return value
    if isinstance(value, dict):
        return Config({k: _resolve_value(v, root, stack) for k, v in value.items()})
    if isinstance(value, list):
        return [_resolve_value(v, root, stack) for v in value]
    return value


def resolve(cfg: Config) -> Config:
    """Return a copy of ``cfg`` with every ${...} interpolation resolved."""
    return _resolve_value(cfg, cfg, [])


def iter_leaves(cfg: Any, prefix: str = "") -> Iterator[tuple]:
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            yield from iter_leaves(v, f"{prefix}{k}.")
    elif isinstance(cfg, list):
        for i, v in enumerate(cfg):
            yield from iter_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], cfg
