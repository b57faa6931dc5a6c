"""String-keyed registries resolving ``type=`` config dicts to classes.

A copy of ``gaiaseg_tpu/utils/registry.py``: the mmcv registry contract the
reference relies on (every buildable object in GAIA-seg configs is a
``dict(type='Name', ...)`` resolved against a named registry). Self-contained:
no parent/child scoping, no location-based lazy import — just a dict with
build semantics, which is all the reference surface uses.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class map with mmcv-compatible ``build`` semantics."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Any] = None,
                        force: bool = False) -> Callable:
        """Register a class/function, usable as decorator or direct call."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool) -> None:
        if name is None:
            names = [module.__name__]
        elif isinstance(name, (list, tuple)):
            names = list(name)
        else:
            names = [name]
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} is already registered in {self._name}")
            self._module_dict[n] = module

    def build(self, cfg: Dict[str, Any], **default_kwargs) -> Any:
        """Instantiate from ``dict(type='Name', **kwargs)``."""
        return build_from_cfg(cfg, self, default_kwargs or None)


def build_from_cfg(cfg: Dict[str, Any], registry: Registry,
                   default_args: Optional[Dict[str, Any]] = None) -> Any:
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {registry.name} "
                           f"(available: {sorted(registry.module_dict)})")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    return obj_cls(**args)


# The port's own registries: ``type=`` strings in the shared config files
# resolve to torch classes here (the JAX package keeps its own instances).
BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
SEGMENTORS = Registry("segmentor")
LOSSES = Registry("loss")
DATASETS = Registry("dataset")
SAMPLERS = Registry("model_sampler")
