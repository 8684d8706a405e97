"""YAML config composition: the Hydra feature subset used by the reference.

The port's copy of ``values_tpu/config/loader.py``; ``yaml`` is imported
where a file is parsed, not when the module is imported.

The reference composes a primary YAML with a ``defaults`` list of config
groups and applies command-line overrides (reference:
uncertainty_modeling/configs/softmax_config.yaml — ``defaults: [datamodule:
case1_config, model: unet3D_config]``; evaluation/configs/eval_config_*.yaml
use the same mechanism with ``datasets`` and ``tasks`` groups).

Composition rules implemented here:

- each ``defaults`` entry ``group: name`` loads ``<dir>/<group>/<name>.yaml``
  into ``cfg[group]`` (Hydra's default package = group path),
- entries with ``# @package _global_`` headers merge at the root,
- the primary config's own keys override defaults,
- overrides: ``group=name`` swaps a defaults group, ``a.b=v`` sets a value,
  ``+a.b=v`` adds one, ``~a.b`` deletes one,
- ``${...}`` interpolations are resolved after composition.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Sequence, Union

from .node import Config, make_config, merge, resolve

_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)\s*$", re.MULTILINE)


def _load_yaml(path: Path) -> tuple[Config, Optional[str]]:
    import yaml
    text = path.read_text()
    m = _PACKAGE_RE.search(text)
    package = m.group(1) if m else None
    data = yaml.safe_load(text)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ValueError(f"Top-level YAML in {path} must be a mapping")
    return make_config(data), package


def _find_config_file(config_dir: Path, name: str) -> Path:
    name = str(name)
    if not name.endswith((".yaml", ".yml")):
        for ext in (".yaml", ".yml"):
            cand = config_dir / f"{name}{ext}"
            if cand.exists():
                return cand
        raise FileNotFoundError(f"No config '{name}' under {config_dir}")
    cand = config_dir / name
    if not cand.exists():
        raise FileNotFoundError(f"No config '{name}' under {config_dir}")
    return cand


def _merge_at_package(cfg: Config, sub: Config, package: Optional[str],
                      default_pkg: Optional[str]) -> None:
    pkg = package if package is not None else default_pkg
    if pkg in (None, "_global_", ""):
        merge(cfg, sub)
        return
    target = cfg
    for part in pkg.replace("/", ".").split("."):
        if part not in target or not isinstance(target[part], dict):
            target[part] = Config()
        target = target[part]
    merge(target, sub)


def compose(config_dir: Union[str, Path], config_name: str,
            overrides: Sequence[str] = ()) -> Config:
    """Compose ``<config_dir>/<config_name>.yaml`` with its defaults list
    and apply dotted-path overrides. Returns a fully resolved Config."""
    config_dir = Path(config_dir)
    primary_path = _find_config_file(config_dir, config_name)
    primary, _ = _load_yaml(primary_path)

    defaults = primary.pop("defaults", [])

    # Group overrides (``group=name`` where the group exists as a directory
    # or appears in the defaults list) swap out defaults entries.
    group_names = set()
    norm_defaults: List[tuple] = []  # (group|None, name)
    for entry in defaults:
        if isinstance(entry, dict):
            for group, name in entry.items():
                norm_defaults.append((str(group), name))
                group_names.add(str(group))
        elif entry == "_self_":
            norm_defaults.append((None, "_self_"))
        else:
            norm_defaults.append((None, str(entry)))

    value_overrides: List[tuple] = []
    for ov in overrides:
        if ov.startswith("~"):
            value_overrides.append(("del", ov[1:], None))
            continue
        add = ov.startswith("+")
        if add:
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' must look like key=value")
        key, val = ov.split("=", 1)
        key = key.strip()
        is_group = key in group_names or (config_dir / key).is_dir()
        if is_group and "." not in key:
            replaced = False
            for i, (group, _name) in enumerate(norm_defaults):
                if group == key:
                    norm_defaults[i] = (group, val.strip())
                    replaced = True
            if not replaced:
                norm_defaults.append((key, val.strip()))
            continue
        value_overrides.append(("add" if add else "set", key, val))

    def _split_at_package(name: str):
        """Hydra's ``name@package`` defaults syntax."""
        if "@" in name:
            file_name, _, pkg = name.partition("@")
            return file_name, pkg
        return name, None

    cfg = make_config({})
    self_merged = False
    for group, name in norm_defaults:
        if name is None:
            continue
        if group is None and name == "_self_":
            merge(cfg, primary)
            self_merged = True
            continue
        name, at_package = _split_at_package(str(name))
        group_clean, group_at = (_split_at_package(group)
                                 if group else (group, None))
        at_package = at_package or group_at
        sub_dir = config_dir / group_clean if group_clean else config_dir
        sub_path = _find_config_file(sub_dir, name)
        sub, package = _load_yaml(sub_path)
        sub_defaults = sub.pop("defaults", None)
        if sub_defaults:
            # one level of nested defaults (used by eval task bundles);
            # relative entries resolve against the sub config's own dir.
            # ``# @package _global_`` entries merge at the TRUE root (Hydra
            # semantics), everything else inside the sub config.
            nested_dir = sub_path.parent
            # nested defaults compose FIRST; the sub config's own body
            # merges over them (Hydra's implicit trailing _self_), so e.g.
            # toy_seed123's seed override beats toy_defaults' seed list
            pre = make_config({})

            def _nested(target_name, target_group):
                n2, p2_at = _split_at_package(str(target_name))
                g2_clean, g2_at = (_split_at_package(str(target_group))
                                   if target_group else (None, None))
                d2 = nested_dir / g2_clean if g2_clean else nested_dir
                s2, p2 = _load_yaml(_find_config_file(d2, n2))
                pkg = p2_at or g2_at or p2
                target = cfg if pkg == "_global_" else pre
                _merge_at_package(target, s2, pkg, g2_clean)

            for entry in sub_defaults:
                if isinstance(entry, dict):
                    for g2, n2 in entry.items():
                        _nested(n2, g2)
                elif entry != "_self_":
                    _nested(entry, None)
            merge(pre, sub)
            sub = pre
        _merge_at_package(cfg, sub, at_package or package, group_clean)
    if not self_merged:
        merge(cfg, primary)  # primary values take precedence (Hydra 1.0 style)

    import yaml
    for action, key, val in value_overrides:
        if action == "del":
            parts = key.split(".")
            node = cfg.select(".".join(parts[:-1])) if len(parts) > 1 else cfg
            if isinstance(node, dict):
                node.pop(parts[-1], None)
        else:
            parsed = yaml.safe_load(val) if val != "" else None
            cfg.set_dotted(key, parsed)

    return resolve(cfg)


def load_config_file(path: Union[str, Path]) -> Config:
    """Load a single YAML file (no defaults composition) and resolve it."""
    cfg, _ = _load_yaml(Path(path))
    cfg.pop("defaults", None)
    return resolve(cfg)
