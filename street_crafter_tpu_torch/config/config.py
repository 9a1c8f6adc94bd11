"""Declarative config: a dict-backed tree with attribute access.

Copy of ``street_crafter_tpu/config/config.py`` that runs without PyYAML: a
config file may be ``.json`` (JSON is a subset of YAML, so the same file
also loads in the JAX package) or ``.yaml``, and ``yaml`` is imported only
to read or write a YAML file. CLI overrides are parsed as JSON scalars and
lists, with bare words kept as strings.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Iterable, Mapping


class Config(dict):
    """Dict with attribute access, deep merge, and freeze support."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        object.__setattr__(self, Config._FROZEN_KEY, False)
        merged: dict[str, Any] = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = _wrap(value)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, Config._FROZEN_KEY):
            raise AttributeError(f"config is frozen; cannot set {name!r}")
        self[name] = _wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, Config._FROZEN_KEY):
            raise AttributeError(f"config is frozen; cannot set {key!r}")
        super().__setitem__(key, _wrap(value))

    def __deepcopy__(self, memo: dict) -> "Config":
        out = Config()
        for key, value in self.items():
            out[key] = copy.deepcopy(value, memo)
        return out

    # -- operations ---------------------------------------------------------
    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Recursively merge ``other`` into self (other wins). Returns self."""
        for key, value in other.items():
            if (
                key in self
                and isinstance(self[key], Config)
                and isinstance(value, Mapping)
            ):
                self[key].merge(value)
            else:
                self[key] = _wrap(copy.deepcopy(value))
        return self

    def freeze(self, frozen: bool = True) -> "Config":
        object.__setattr__(self, Config._FROZEN_KEY, frozen)
        for value in self.values():
            if isinstance(value, Config):
                value.freeze(frozen)
        return self

    def clone(self) -> "Config":
        return copy.deepcopy(self)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Config = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def to_dict(cfg: Any) -> Any:
    """Convert a Config tree back to plain python containers."""
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def _parse_value(text: str) -> Any:
    """Parse a CLI value ('1'->int, 'true'->bool, '[0, 1]'->list, else
    the string itself)."""
    words = {"true": True, "false": False, "null": None, "none": None,
             "~": None}
    if text.strip().lower() in words:
        return words[text.strip().lower()]
    try:
        return json.loads(text)
    except ValueError:
        return text


def merge_dotlist(cfg: Config, dotlist: Iterable[str]) -> Config:
    """Apply ``key.path=value`` overrides. Also accepts alternating
    ["key.path", "value", ...] pairs (yacs ``opts`` style)."""
    items = list(dotlist)
    pairs: list[tuple[str, str]] = []
    i = 0
    while i < len(items):
        token = str(items[i])
        if "=" in token:
            key, _, val = token.partition("=")
            pairs.append((key.strip(), val))
            i += 1
        else:
            if i + 1 >= len(items):
                raise ValueError(f"dangling config override key: {token!r}")
            pairs.append((token.strip(), str(items[i + 1])))
            i += 2
    for key, val in pairs:
        cfg.set_path(key, _parse_value(val))
    return cfg


def _is_json(path: str) -> bool:
    return path.lower().endswith(".json")


def load_config(path: str | os.PathLike, overrides: Iterable[str] = ()) -> Config:
    """Load a JSON or YAML config with recursive ``parent_config``
    inheritance (parents load first, children deep-merge on top)."""
    path = os.fspath(path)
    with open(path) as f:
        if _is_json(path):
            raw = json.load(f) or {}
        else:
            import yaml
            raw = yaml.safe_load(f) or {}
    parent_rel = raw.pop("parent_config", None)
    if parent_rel is not None:
        parent_path = parent_rel
        if not os.path.isabs(parent_path):
            parent_path = os.path.join(os.path.dirname(path), parent_path)
        cfg = load_config(parent_path)
    else:
        cfg = Config()
    cfg.merge(raw)
    if overrides:
        merge_dotlist(cfg, overrides)
    return cfg


def save_config(cfg: Config, path: str | os.PathLike) -> None:
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if _is_json(path):
            json.dump(to_dict(cfg), f, indent=1)
        else:
            import yaml
            yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
