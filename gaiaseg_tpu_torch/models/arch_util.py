"""Arch encoding: sampler meta -> nested arch dict of Python ints.

Port of ``model_max_arch``, ``canonical_arch`` and ``encode_arch`` from
``gaiaseg_tpu/models/arch_util.py``. The JAX package turns the arch into a
traced int32 pytree so one program serves every subnet; the port runs
eagerly and slices by Python ints, so the encoded arch stays plain ints.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from ..archspace.meta import unfold_dict
from ..utils.registry import BACKBONES


def backbone_max_arch(backbone_cfg: Dict[str, Any]) -> Dict[str, Any]:
    cls = BACKBONES.get(backbone_cfg["type"])
    if cls is None or not hasattr(cls, "max_arch_of"):
        return {}
    return cls.max_arch_of(backbone_cfg)


def model_max_arch(model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Template for a whole segmentor: only the backbone is elastic."""
    return {"backbone": backbone_max_arch(model_cfg["backbone"])}


def _merge(template: Any, value: Any) -> Any:
    if isinstance(template, dict):
        return {k: _merge(tv, value.get(k) if isinstance(value, dict)
                          else None)
                for k, tv in template.items()}
    return template if value is None else value


def canonical_arch(max_arch: Dict[str, Any],
                   meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Merge a meta's arch over the MAX template.

    ``meta`` may be a flat dot-keyed sampler draw (``'arch.backbone...'``),
    a nested meta with an ``'arch'`` key, or a bare arch dict."""
    if meta is None:
        return copy.deepcopy(max_arch)
    meta = unfold_dict(meta) if any("." in str(k) for k in meta) else meta
    return _merge(max_arch, meta.get("arch", meta))


def encode_arch(max_arch: Dict[str, Any],
                meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``canonical_arch`` with every leaf an int or a list of ints."""
    def _ints(v):
        if isinstance(v, dict):
            return {k: _ints(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [int(x) for x in v]
        return int(v)
    return _ints(canonical_arch(max_arch, meta))
