"""YAML config handling — attribute-access dicts mirroring the reference's
yaml+Munch scheme (`tools/train.py:149-150`) without the munch dependency,
plus the TPU-specific static-capacity block."""

from __future__ import annotations

import copy

import yaml


class Config(dict):
    """dict with attribute access, recursive over nested dicts."""

    def __init__(self, d=None, **kw):
        super().__init__()
        d = dict(d or {}, **kw)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def get(self, k, default=None):
        return super().get(k, default)

    def copy(self):
        return copy.deepcopy(self)

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = [x.to_dict() if isinstance(x, Config) else x for x in v]
            out[k] = v
        return out


def load_config(path: str) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f))


def getattr_or(cfg, key, default=None):
    """`getattr(cfg, key, default)` for optional config keys — the reference
    reads optional fields the same way (`softgroup.py:211-212,310,427-429`)."""
    if cfg is None:
        return default
    return cfg.get(key, default) if isinstance(cfg, dict) else getattr(cfg, key, default)
