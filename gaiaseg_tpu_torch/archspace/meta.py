"""Architecture-meta plumbing: flat<->nested dicts, DL<->LD transpose, naming.

A copy of ``gaiaseg_tpu/archspace/meta.py``.

Behavioral contract reconstructed from reference use sites (SURVEY.md §2.9):
- ``fold_dict`` / ``unfold_dict`` convert flat dot-keyed metas
  (``'arch.backbone.body.depth': [...]``) to nested dicts and back
  (reference gaiaseg/core/evaluation/cross_arch_eval_hooks.py:18,
  tools/extract_subnet.py:30,113).
- "DL to LD": a dict-of-lists arch meta per model-level is transposed into a
  list of per-stage dicts before fan-out to stages
  (reference gaiaseg/models/backbones/dynamic_resnet.py:390,400).
- Subnet checkpoints are named ``md5(json(meta))[:8]``
  (reference tools/extract_subnet.py:131-133).
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List


def unfold_dict(flat: Dict[str, Any], sep: str = ".") -> Dict[str, Any]:
    """``{'a.b.c': 1}`` -> ``{'a': {'b': {'c': 1}}}``. Non-flat keys pass through."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(sep)
        d = out
        for p in parts[:-1]:
            nxt = d.setdefault(p, {})
            if not isinstance(nxt, dict):
                raise ValueError(f"key collision unfolding {key!r}: {p!r} is a leaf")
            d = nxt
        leaf = parts[-1]
        if isinstance(value, dict):
            sub = unfold_dict(value, sep)
            existing = d.get(leaf)
            if isinstance(existing, dict):
                _deep_update(existing, sub)
            else:
                d[leaf] = sub
        else:
            if isinstance(d.get(leaf), dict):
                raise ValueError(f"key collision unfolding {key!r}")
            d[leaf] = value
    return out


def fold_dict(nested: Dict[str, Any], sep: str = ".", prefix: str = "") -> Dict[str, Any]:
    """``{'a': {'b': 1}}`` -> ``{'a.b': 1}``."""
    out: Dict[str, Any] = {}
    for key, value in nested.items():
        full = f"{prefix}{sep}{key}" if prefix else str(key)
        if isinstance(value, dict) and value:
            out.update(fold_dict(value, sep, full))
        else:
            out[full] = value
    return out


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def dl_to_ld(dict_of_lists: Dict[str, List[Any]]) -> List[Dict[str, Any]]:
    """Transpose ``{'depth': [4,6], 'width': [80,160]}`` ->
    ``[{'depth': 4, 'width': 80}, {'depth': 6, 'width': 160}]``.

    Keys whose value is not a list/tuple broadcast to every stage.
    """
    list_keys = [k for k, v in dict_of_lists.items() if isinstance(v, (list, tuple))]
    if not list_keys:
        return [dict(dict_of_lists)]
    n = len(dict_of_lists[list_keys[0]])
    for k in list_keys:
        if len(dict_of_lists[k]) != n:
            raise ValueError(f"ragged dict-of-lists: {k} has {len(dict_of_lists[k])} "
                             f"entries, expected {n}")
    out = []
    for i in range(n):
        out.append({k: (v[i] if isinstance(v, (list, tuple)) else v)
                    for k, v in dict_of_lists.items()})
    return out


def ld_to_dl(list_of_dicts: List[Dict[str, Any]]) -> Dict[str, List[Any]]:
    """Inverse of :func:`dl_to_ld` for homogeneous dicts."""
    if not list_of_dicts:
        return {}
    keys = list_of_dicts[0].keys()
    return {k: [d[k] for d in list_of_dicts] for k in keys}


def _canonical(obj: Any) -> Any:
    """Make a meta JSON-serializable deterministically (tuples->lists, sort keys)."""
    if isinstance(obj, dict):
        return {str(k): _canonical(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    return obj


def meta_json(meta: Dict[str, Any]) -> str:
    return json.dumps(_canonical(meta), sort_keys=True, separators=(",", ":"))


def meta_hash(meta: Dict[str, Any], length: int = 8) -> str:
    """Deterministic md5-prefix name for a subnet meta
    (reference tools/extract_subnet.py:131-133 names ckpts md5(json(meta))[:8])."""
    return hashlib.md5(meta_json(meta).encode()).hexdigest()[:length]
