"""Config system: yaml files with hydra-like group composition. The port's
own copy of ``dad3dheads_tpu/train/config.py`` (pure yaml): a root file's
``defaults`` list pulls group files (backend, dataset, constants, model,
loss, optimizer, scheduler, train_stage), deep-merged into one dict, then
dotted ``key=value`` overrides, ``${...}`` interpolation, and a timestamped
experiment dir with the resolved config saved in it.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Any, Dict, List, Optional

import yaml

_INTERP = re.compile(r"\$\{([^}]+)\}")


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _lookup(config: Dict[str, Any], dotted: str) -> Any:
    node: Any = config
    for part in dotted.split("."):
        node = node[part]
    return node


def resolve_interpolations(config: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ${a.b.c} references (repeatedly, up to a small depth)."""

    def resolve(node):
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            m = _INTERP.fullmatch(node)
            if m:
                return _lookup(config, m.group(1))
            return _INTERP.sub(lambda mm: str(_lookup(config, mm.group(1))), node)
        return node

    for _ in range(4):
        new = resolve(config)
        if new == config:
            break
        config = new
    return config


def set_dotted(config: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = config
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = yaml.safe_load(value) if isinstance(value, str) else value


def load_config(
    path: str,
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Load a root yaml, compose its ``defaults`` group list, apply
    ``key=value`` overrides, resolve interpolations."""
    config_dir = config_dir or os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        root = yaml.safe_load(f) or {}

    config: Dict[str, Any] = {}
    for entry in root.pop("defaults", []):
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            group_path = os.path.join(config_dir, group, f"{name}.yaml")
        else:
            group_path = os.path.join(config_dir, f"{entry}.yaml")
        with open(group_path) as f:
            config = deep_merge(config, yaml.safe_load(f) or {})
    config = deep_merge(config, root)

    for ov in overrides or []:
        key, _, value = ov.partition("=")
        set_dotted(config, key, value)

    return resolve_interpolations(config)


def prepare_experiment_dir(config: Dict[str, Any], base: str = "experiments/train") -> str:
    """Timestamped run dir with the resolved config snapshot saved in it."""
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    exp_dir = config.get("experiment_dir") or os.path.join(base, stamp)
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    config["experiment_dir"] = exp_dir
    return exp_dir
