"""A read-only view of a YAML configuration with attribute access (the
subset of omegaconf the configurations use)."""

from __future__ import annotations

from typing import Any, Iterator, Mapping


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
