"""Hierarchical YAML config system, schema-compatible with the reference confs.

The port's own copy of `multiply_tpu/config.py`: the same three-file layout
(`<seq>_base.yaml` + `model/<name>.yaml` + `dataset/<name>.yaml`), the same key
schema and the same `${a.b}` interpolation subset, with no JAX anywhere.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterator, Mapping

import yaml


class Config(Mapping):
    """Read-only-ish attribute/dict hybrid over nested config data.

    Mirrors the subset of omegaconf used by the reference (`opt.key`,
    `opt.get(key, default)`, iteration) so configs written against the
    reference schema drive this framework unchanged.
    """

    def __init__(self, data: dict | None = None):
        # Wrap the dict by reference (no copy): nested item assignment through
        # a wrapped view must mutate the underlying config.
        if data is None:
            data = {}
        elif not isinstance(data, dict):
            data = dict(data)
        object.__setattr__(self, "_data", data)

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):  # copy/pickle probe private names before __init__ runs
            raise AttributeError(key)
        try:
            return Config._wrap(self._data[key])
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        return Config._wrap(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        return Config._wrap(self._data.get(key, default))

    def keys(self):
        return self._data.keys()

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, Config):
                return v.to_dict()
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return {k: unwrap(v) for k, v in self._data.items()}

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _deep_update(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def load_config(base_path: str, overrides: dict | None = None) -> Config:
    """Load a composed experiment config.

    `base_path` points at a `<seq>_base.yaml` with a hydra-style `defaults:` list
    naming a model conf and a dataset conf (resolved relative to the base file's
    directory under `model/` and `dataset/`), or at a fully self-contained yaml.
    """
    base_dir = os.path.dirname(os.path.abspath(base_path))
    raw = _load_yaml(base_path)
    raw.pop("hydra", None)

    composed: dict = {}
    defaults = raw.pop("defaults", [])
    for entry in defaults:
        if not isinstance(entry, dict):
            continue  # `_self_` marker and friends
        for group, name in entry.items():
            if group == "_self_" or name is None:
                continue
            sub_path = os.path.join(base_dir, group, f"{name}.yaml")
            composed[group] = _load_yaml(sub_path)
    composed = _deep_update(composed, raw)
    if overrides:
        composed = _deep_update(composed, overrides)

    composed = _resolve_interpolations(composed)
    return Config(composed)


def _resolve_interpolations(data: dict) -> dict:
    """Resolve the small `${a.b.c}` interpolation subset the reference confs use."""

    def lookup(root: dict, dotted: str) -> Any:
        cur: Any = root
        for part in dotted.split("."):
            cur = cur[part]
        return cur

    def resolve(value: Any) -> Any:
        if isinstance(value, str) and value.startswith("${") and value.endswith("}"):
            try:
                return lookup(data, value[2:-1])
            except (KeyError, TypeError):
                return value
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v) for v in value]
        return value

    # two passes so interpolations may reference each other one level deep
    data = resolve(data)
    return resolve(data)
