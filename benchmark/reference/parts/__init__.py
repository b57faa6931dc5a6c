"""The model components the reference and the MAC counter know, one file
each, found by the config's ``type``.

Every ``parts/<name>.py`` (but those whose name starts with ``_``)
declares ``TYPES``, the config ``type`` strings it serves, and ``ROLE``,
where it sits in a segmentor. By role it gives:

- ``"backbone"``: ``max_arch(cfg)``, its MAX arch (the ``backbone`` entry
  of an arch); ``specs(cfg, S) -> channels`` of its outputs;
  ``forward(nm, P, img, arch, cfg, train, stats) -> feats``;
  ``macs(cfg, arch, hw) -> (MACs, [(channels, (h, w))])``.
- ``"neck"``: ``specs(cfg, chans, S) -> channels``;
  ``forward(nm, P, feats, cfg, train, stats) -> feats``;
  ``macs(cfg, levels) -> (MACs, levels)``.
- ``"head"``: ``specs(cfg, chans, S, name)``;
  ``forward(nm, P, feats, cfg, train, stats, gen, name) -> logits``;
  ``macs(cfg, levels) -> MACs``.

``S`` is a ``nets.Specs``: the parameters' names and MAX shapes in order,
and which of them are batch norms with running statistics. ``nm`` is a
``nets.Numerics``, ``P`` the MAX-shape tensors by name, ``stats`` where
batch norms record their batch statistics (or None), ``gen`` the step's
dropout generator. A new component is one new file here.
"""
from __future__ import annotations

import glob
import hashlib
import importlib
import importlib.util
import os
from types import ModuleType
from typing import Dict, Optional

PARTS_DIR = os.path.dirname(os.path.abspath(__file__))
ROLES = ("backbone", "neck", "head")

_loaded: Dict[str, Dict[str, ModuleType]] = {}


def _module(directory: str, stem: str) -> ModuleType:
    if directory == PARTS_DIR:
        return importlib.import_module(f"{__name__}.{stem}")
    tag = hashlib.sha1(directory.encode()).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(
        f"_parts_{tag}_{stem}", os.path.join(directory, stem + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(directory: Optional[str] = None) -> Dict[str, ModuleType]:
    """``{type: module}`` of every part file in ``directory`` (this one
    by default), each file loaded once. A type claimed twice raises."""
    directory = os.path.abspath(directory or PARTS_DIR)
    if directory not in _loaded:
        found: Dict[str, ModuleType] = {}
        for path in sorted(glob.glob(os.path.join(directory, "*.py"))):
            stem = os.path.basename(path)[:-3]
            if stem.startswith("_"):
                continue
            mod = _module(directory, stem)
            if mod.ROLE not in ROLES:
                raise ValueError(f"{path}: ROLE {mod.ROLE!r} is not one of "
                                 f"{ROLES}")
            for t in mod.TYPES:
                if t in found:
                    raise ValueError(f"part type {t!r} is claimed by both "
                                     f"{found[t].__file__} and {path}")
                found[t] = mod
        _loaded[directory] = found
    return _loaded[directory]


def get(type_name: str, role: str,
        directory: Optional[str] = None) -> ModuleType:
    """The part serving ``type_name`` in ``role``."""
    mod = load(directory).get(type_name)
    if mod is None:
        raise ValueError(f"no part serves type {type_name!r}: no file in "
                         f"{os.path.abspath(directory or PARTS_DIR)} "
                         f"lists it in TYPES")
    if mod.ROLE != role:
        raise ValueError(f"type {type_name!r} ({mod.__file__}) is a "
                         f"{mod.ROLE}, not a {role}")
    return mod
