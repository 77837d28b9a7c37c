"""Tiny nested-config system: attribute access, deep merge, YAML inheritance.

The same files and rules as the JAX package's loader: a YAML file may
declare ``extends: <path|LAGRANGEBENCH_DEFAULTS>``, resolved recursively down
to the built-in defaults and merged bottom-up; CLI arguments use the
``a.b.c=value`` dotlist syntax. PyYAML is imported only inside the functions
that parse YAML.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Iterator, List, Optional

DEFAULTS_SENTINEL = "LAGRANGEBENCH_DEFAULTS"


class Config:
    """A nested dict with attribute access."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self[k] = v

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict):
            value = Config(value)
        self._data[key] = value

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(f"Config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
            for k, v in self._data.items()
        }

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def merge(*configs) -> Config:
    """Deep-merge configs left to right; later values win.

    Nested dicts merge recursively; any other type (lists included) is
    replaced wholesale.
    """
    out = Config()
    for cfg in configs:
        if cfg is None:
            continue
        for k, v in cfg.items():
            if isinstance(v, (Config, dict)) and isinstance(out.get(k), Config):
                out[k] = merge(out[k], v)
            elif isinstance(v, (Config, dict)):
                out[k] = merge(Config(), v)
            else:
                out[k] = copy.deepcopy(v)
    return out


def _parse_value(raw: str) -> Any:
    """Parse a CLI value string via YAML (int/float/bool/list/null)."""
    import yaml

    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def from_dotlist(args: List[str]) -> Config:
    """Build a Config from ``a.b.c=value`` strings."""
    cfg = Config()
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"CLI argument {arg!r} is not of the form key=value")
        dotted, raw = arg.split("=", 1)
        node = cfg
        keys = dotted.strip().split(".")
        for k in keys[:-1]:
            if not isinstance(node.get(k), Config):
                node[k] = Config()
            node = node[k]
        node[keys[-1]] = _parse_value(raw)
    return cfg


def load_yaml(path: str) -> Config:
    """Load one YAML file into a Config (no inheritance resolution)."""
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    return Config(data)


def load_with_extends(path: str, defaults: Config) -> Config:
    """Load a YAML config, resolving its ``extends:`` chain down to defaults.

    Each file may name a parent config path (relative to its own directory,
    else to the working directory) or the sentinel
    ``LAGRANGEBENCH_DEFAULTS`` that ends the chain.
    """
    chain = []
    seen = set()
    current = path
    while True:
        current = os.path.normpath(current)
        if current in seen:
            raise ValueError(f"Circular `extends:` chain at {current}")
        seen.add(current)
        cfg = load_yaml(current)
        parent = cfg.get("extends")
        if "extends" in cfg:
            del cfg["extends"]
        chain.append(cfg)
        if parent is None or parent == DEFAULTS_SENTINEL:
            break
        candidate = os.path.join(os.path.dirname(current), parent)
        current = candidate if os.path.exists(candidate) else parent

    chain.append(defaults)
    return merge(*reversed(chain))


def check_subset(superset: Config, subset: Config, prefix: str = "") -> None:
    """Raise ValueError for a key of ``subset`` that ``superset`` lacks (a
    mistyped CLI argument)."""
    for k, v in subset.items():
        full = f"{prefix}{k}"
        if k not in superset:
            raise ValueError(f"Unknown config key: {full}")
        if isinstance(v, Config) and isinstance(superset[k], Config):
            check_subset(superset[k], v, prefix=full + ".")


def save_yaml(cfg: Config, path: str) -> None:
    """Write a Config to a YAML file (keys in their order)."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, default_flow_style=False, sort_keys=False)
