"""Builders translating mmcv-style config dicts into torch modules.

Port of ``gaiaseg_tpu/models/builder.py``. A config is filtered to the
keyword arguments of the registered class; torch/mmcv plumbing keys
(``conv_cfg``, ``norm_cfg``, ``style`` ...) are dropped with a debug log,
any other unknown key with a warning, so nothing disappears silently.
"""
from __future__ import annotations

import copy
import inspect
import logging
from typing import Any, Dict, Optional, Sequence

from ..ops.dynamic_layers import DynBatchNorm
from ..utils.registry import BACKBONES, HEADS, LOSSES, NECKS, SEGMENTORS

logger = logging.getLogger("gaiaseg_tpu_torch")

_IGNORED_KEYS = {
    "conv_cfg", "norm_cfg", "act_cfg", "style", "pretrained", "init_cfg",
    "with_cp", "contract_first_dilation", "zero_init_residual", "num_stages",
    "base_channels", "loss_decode", "sampler",
}


def _init_args(cls) -> set:
    """Keyword arguments ``cls`` takes, following ``**kw`` into the bases."""
    names = set()
    for klass in cls.__mro__:
        if "__init__" not in vars(klass):
            continue
        params = inspect.signature(klass.__init__).parameters.values()
        names.update(p.name for p in params if p.kind in (
            p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY))
        if not any(p.kind == p.VAR_KEYWORD for p in params):
            break
    return names


def _build_filtered(registry, cfg: Dict[str, Any], **extra) -> Any:
    cfg = copy.deepcopy(dict(cfg))
    cfg.update(extra)
    obj_type = cfg.pop("type")
    cls = registry.get(obj_type)
    if cls is None:
        raise KeyError(f"{obj_type!r} not registered in {registry.name} "
                       f"(available: {sorted(registry.module_dict)})")
    accepted = _init_args(cls)
    kept = {}
    for k, v in cfg.items():
        if k in accepted:
            kept[k] = v
        else:
            level = logging.DEBUG if k in _IGNORED_KEYS else logging.WARNING
            logger.log(level, "%s: dropping config key %r (no argument of "
                       "%s)", registry.name, k, cls.__name__)
    return cls(**kept)


def _with_stat_groups(module, cfg: Dict[str, Any]):
    """Every ``DynBatchNorm`` of ``module`` takes ``norm_cfg.stat_groups``
    (JAX ``builder.py:59-69`` passes it as ``bn_groups``); the reference's
    ``group_size`` is accepted for config parity and keeps global
    statistics."""
    nc = cfg.get("norm_cfg")
    groups = int(nc.get("stat_groups", 1) or 1) if isinstance(nc, dict) \
        else 1
    if groups > 1:
        for m in module.modules():
            if isinstance(m, DynBatchNorm):
                m.stat_groups = groups
    return module


def build_backbone(cfg: Dict[str, Any]):
    return _with_stat_groups(_build_filtered(BACKBONES, cfg), cfg)


def _in_channels(cfg: Dict[str, Any], channels: Sequence[int],
                 idx) -> Any:
    """The MAX input channels at ``idx`` (an int or a list) of the
    producer's outputs; a config value that disagrees raises."""
    in_ch = [int(channels[i]) for i in idx] \
        if isinstance(idx, (list, tuple)) else int(channels[idx])
    given = cfg.get("in_channels")
    if given is not None:
        given = [int(c) for c in given] if isinstance(given, (list, tuple)) \
            else int(given)
        if given != in_ch:
            raise ValueError(f"{cfg.get('type')} in_channels={given} but its "
                             f"input gives {in_ch} channels at {idx}")
    return in_ch


def build_neck(cfg: Dict[str, Any], backbone_channels: Sequence[int]):
    """Build a neck over all of the backbone's outputs."""
    return _build_filtered(NECKS, cfg, in_channels=_in_channels(
        cfg, backbone_channels, list(range(len(backbone_channels)))))


def build_head(cfg: Dict[str, Any], backbone_channels: Sequence[int]):
    """Build a decode head; its MAX ``in_channels`` follow from the
    backbone's (or neck's) output channels at ``in_index`` (a list of them
    under an ``input_transform``; ``resize_concat`` heads sum it), and a
    DeepLabV3+ head's ``c1_in_channels`` from those at ``c1_in_index``."""
    idx = cfg.get("in_index", -1)
    if cfg.get("input_transform") in ("multiple_select", "resize_concat"):
        idx = [int(i) for i in (idx if isinstance(idx, (list, tuple))
                                else [idx])]
    extra = {}
    if "c1_in_channels" in _init_args(HEADS.get(cfg["type"]) or object):
        c1 = int(cfg.get("c1_in_index", 0))
        extra["c1_in_channels"] = _in_channels(
            {"type": cfg["type"], "in_channels": cfg.get("c1_in_channels")},
            backbone_channels, c1)
    return _with_stat_groups(_build_filtered(
        HEADS, cfg, in_index=idx,
        in_channels=_in_channels(cfg, backbone_channels, idx), **extra), cfg)


def build_loss(cfg: Dict[str, Any]):
    return LOSSES.build(dict(cfg))


def build_segmentor(cfg: Dict[str, Any], train_cfg: Optional[Dict] = None,
                    test_cfg: Optional[Dict] = None):
    cfg = copy.deepcopy(dict(cfg))
    if train_cfg is not None:
        cfg["train_cfg"] = train_cfg
    if test_cfg is not None:
        cfg["test_cfg"] = test_cfg
    return _build_filtered(SEGMENTORS, cfg)
