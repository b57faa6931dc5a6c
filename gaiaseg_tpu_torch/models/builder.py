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

from ..utils.registry import BACKBONES, HEADS, LOSSES, SEGMENTORS

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


def _check_norm_cfg(cfg: Dict[str, Any]) -> None:
    nc = cfg.get("norm_cfg")
    if isinstance(nc, dict) and int(nc.get("stat_groups", 1) or 1) > 1:
        raise NotImplementedError(
            "norm_cfg.stat_groups > 1 (per-group BN statistics) waits for "
            "the DDP/SyncBN slice of the port")


def build_backbone(cfg: Dict[str, Any]):
    _check_norm_cfg(cfg)
    return _build_filtered(BACKBONES, cfg)


def build_head(cfg: Dict[str, Any], backbone_channels: Sequence[int]):
    """Build a decode head; its MAX ``in_channels`` follow from the
    backbone's output channels at ``in_index`` (a config value that
    disagrees raises)."""
    _check_norm_cfg(cfg)
    idx = cfg.get("in_index", -1)
    if not isinstance(idx, int) or cfg.get("input_transform"):
        raise NotImplementedError(
            "heads with input_transform / a list in_index wait for a later "
            "slice of the port")
    in_ch = int(backbone_channels[idx])
    given = cfg.get("in_channels")
    if given is not None and int(given) != in_ch:
        raise ValueError(f"head in_channels={given} but the backbone gives "
                         f"{in_ch} channels at in_index={idx}")
    return _build_filtered(HEADS, cfg, in_channels=in_ch)


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
