"""Config with attribute access (copy of moldiff_tpu/utils/config.py).

A ``Config`` is a plain dict subclass, so checkpoints written by the JAX
package unpickle into it (utils/checkpoint.py maps the class). ``yaml`` is
imported only inside :func:`load_config`: the card machine may not have
PyYAML, and nothing on the sampling path needs it.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping, Optional


class Config(dict):
    """dict with recursive attribute access: cfg.model.diff.num_timesteps."""

    def __init__(self, data: Optional[Mapping] = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for k, v in data.items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def merged(self, other: Mapping) -> "Config":
        """Deep-merge ``other`` over self, returning a new Config."""
        out = Config(self)
        for k, v in other.items():
            if k in out and isinstance(out[k], Config) and isinstance(v, Mapping):
                out[k] = out[k].merged(v)
            else:
                out[k] = _wrap(v)
        return out


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def load_config(path: str) -> Config:
    """YAML file -> Config."""
    import yaml

    with open(path, "r") as f:
        return Config(yaml.safe_load(f))


