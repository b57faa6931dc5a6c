"""Python-file config system with ``_base_`` inheritance.

A copy of ``gaiaseg_tpu/utils/config.py``: the port reads the same config
files and must not import the JAX package to do so.

Re-creates the slice of the mmcv ``Config`` contract that GAIA-seg's tools
depend on (SURVEY.md §5 "Config / flag system"): ``Config.fromfile`` executes
a Python file, resolves a ``_base_`` list of parent configs with deep merge,
honors ``_delete_=True`` to replace instead of merge, supports dot-keyed
``merge_from_dict`` for ``--cfg-options``, attribute access, and ``dump``.

No mmcv code is used; this is a fresh minimal implementation.
"""
from __future__ import annotations

import copy
import json
import os
import os.path as osp
import types
from typing import Any, Dict, Optional

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"
RESERVED_KEYS = ("filename",)


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

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

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __deepcopy__(self, memo):
        return ConfigDict({copy.deepcopy(k, memo): copy.deepcopy(v, memo)
                           for k, v in self.items()})


def _merge_a_into_b(a: Dict, b: Dict) -> Dict:
    """Deep-merge dict ``a`` (child, wins) into ``b`` (base)."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and not v.pop(DELETE_KEY, False):
            if not isinstance(b[k], dict):
                raise TypeError(
                    f"Cannot merge dict into non-dict for key '{k}' "
                    f"({type(b[k]).__name__}); add `{DELETE_KEY}=True` to replace")
            b[k] = _merge_a_into_b(v, b[k])
        else:
            b[k] = copy.deepcopy(v)
    return b


def _file_to_dict(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(filename)
    if filename.endswith(".json"):
        with open(filename) as f:
            cfg_dict = json.load(f)
    elif filename.endswith(".py"):
        mod = types.ModuleType("_gaiaseg_cfg")
        mod.__file__ = filename
        with open(filename) as f:
            code = compile(f.read(), filename, "exec")
        exec(code, mod.__dict__)
        cfg_dict = {k: v for k, v in mod.__dict__.items()
                    if not k.startswith("__")
                    and not isinstance(v, (types.ModuleType, types.FunctionType, type))}
    else:
        raise ValueError(f"Unsupported config type: {filename}")

    base_files = cfg_dict.pop(BASE_KEY, [])
    if isinstance(base_files, str):
        base_files = [base_files]
    base_dict: Dict[str, Any] = {}
    for bf in base_files:
        parent = _file_to_dict(osp.join(osp.dirname(filename), bf))
        dup = set(base_dict) & set(parent)
        base_dict.update({k: v for k, v in parent.items() if k not in dup})
        for k in dup:
            base_dict[k] = _merge_a_into_b(parent[k], base_dict[k]) \
                if isinstance(parent[k], dict) and isinstance(base_dict[k], dict) \
                else parent[k]
    if base_dict:
        cfg_dict = _merge_a_into_b(cfg_dict, base_dict)
    return cfg_dict


class Config:
    """Facade over a ConfigDict with file loading and dot-key merging."""

    def __init__(self, cfg_dict: Optional[Dict] = None, filename: Optional[str] = None):
        object.__setattr__(self, "_cfg_dict", ConfigDict._wrap(cfg_dict or {}))
        object.__setattr__(self, "_filename", filename)

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_file_to_dict(filename), filename=filename)

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._cfg_dict[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._cfg_dict[key] = ConfigDict._wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> Dict[str, Any]:
        def _plain(v):
            if isinstance(v, dict):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_plain(x) for x in v)
            return v
        return _plain(self._cfg_dict)

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge dot-keyed options, e.g. ``{'model.backbone.depth': [2,2,2,2]}``.

        Mirrors the reference's ``--cfg-options`` deep merge
        (reference tools/train_supernet.py:72-77).
        """
        nested: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = nested
            parts = full_key.split(".")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        merged = _merge_a_into_b(nested, dict(self._cfg_dict))
        object.__setattr__(self, "_cfg_dict", ConfigDict._wrap(merged))

    def dump(self, path: str) -> None:
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            if path.endswith(".json"):
                json.dump(self.to_dict(), f, indent=2, default=repr)
            else:
                f.write(self.pretty_text)

    @property
    def pretty_text(self) -> str:
        lines = []
        for k, v in self._cfg_dict.items():
            lines.append(f"{k} = {v!r}")
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        return f"Config(file={self._filename}):\n{self.pretty_text}"
