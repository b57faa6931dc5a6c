"""Subnet extraction: slice the supernet's state dict into a standalone
subnet.

Port of ``gaiaseg_tpu/engine/extract.py`` (the reference's
``tools/extract_subnet.py`` + gaiavision ``model.deploy()``). The subnet's
config is the supernet's with the backbone's MAX widths and depths replaced
by the arch's; every tensor of its state dict is cut from the supernet's.
Widths are prefix slices, so each tensor is a leading slice on every axis
whose size differs, except the kernel of a conv whose input is a concat with
an elastic first segment (the PSP / UPer bottleneck): it keeps the rows
``[0, a) ++ [m, m + n*ch)`` of its input axis (OIHW axis 1), the rows
``DynConv2d(in_tail=n*ch)`` reads in the supernet. The subnet runs through
the same modules at its own MAX, so it equals the supernet at the arch.

``build_head`` checks a head's ``in_channels`` against the backbone's
output channels, where Flax infers input widths, so ``subnet_model_cfg``
also sets each head's ``in_channels`` to the subnet's. FCN
``concat_input=True`` (``conv_cat``) and the deep stem raise in the port's
modules (ROADMAP A6), so their extraction waits too.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..archspace.meta import meta_hash
from ..models.arch_util import canonical_arch, model_max_arch
from ..models.builder import build_segmentor

EXPANSION = 4   # DynBottleneck's


def _stage_channels(backbone_cfg: Dict[str, Any],
                    widths: List[int]) -> List[int]:
    """Output channels of each of the backbone's outputs at ``widths``."""
    out_indices = backbone_cfg.get("out_indices", (0, 1, 2, 3))
    return [int(widths[i]) * EXPANSION for i in out_indices]


def _with_in_channels(head: Dict[str, Any],
                      channels: List[int]) -> Dict[str, Any]:
    head = dict(head)
    idx = head.get("in_index", -1)
    head["in_channels"] = [channels[i] for i in idx] \
        if isinstance(idx, (list, tuple)) else channels[idx]
    return head


def subnet_model_cfg(model_cfg: Dict[str, Any],
                     arch: Dict[str, Any]) -> Dict[str, Any]:
    """Supernet cfg -> static subnet cfg (active widths become MAX; the
    heads take the subnet's input widths)."""
    cfg = copy.deepcopy(dict(model_cfg))
    bb = dict(cfg["backbone"])
    bb_arch = arch["backbone"]
    if "stem" in bb_arch:
        bb["stem_width"] = bb_arch["stem"]["width"]
    if "body" in bb_arch:
        bb["body_width"] = list(bb_arch["body"]["width"])
        bb["body_depth"] = list(bb_arch["body"]["depth"])
        channels = _stage_channels(bb, bb["body_width"])
        cfg["decode_head"] = _with_in_channels(cfg["decode_head"], channels)
        aux = cfg.get("auxiliary_head")
        if isinstance(aux, (list, tuple)):
            cfg["auxiliary_head"] = [_with_in_channels(a, channels)
                                     for a in aux]
        elif aux:
            cfg["auxiliary_head"] = _with_in_channels(aux, channels)
    cfg["backbone"] = bb
    return cfg


def _concat_row_indices(max_segs: List[int], act_segs: List[int]
                        ) -> np.ndarray:
    """Row gather indices for a kernel whose input is a concat of segments
    stored at ``max_segs`` widths with ``act_segs`` active."""
    idx, base = [], 0
    for m, a in zip(max_segs, act_segs):
        idx.append(np.arange(a) + base)
        base += m
    return np.concatenate(idx)


def _concat_spec(key: str, model_cfg: Dict[str, Any],
                 max_arch: Dict[str, Any], arch: Dict[str, Any]
                 ) -> Optional[Tuple[List[int], List[int]]]:
    """(max_segments, active_segments) of the conv input for the state dict
    entries that consume an elastic concat (JAX ``decode_head_m/bottleneck``
    and ``psp_bottleneck`` are both the port's ``decode_head.bottleneck``);
    None for plain leading-slice entries."""
    if key != "decode_head.bottleneck.conv.weight":
        return None
    head = dict(model_cfg["decode_head"])
    if head.get("type") not in ("DynamicPSPHead", "PSPHead",
                                "DynamicUPerHead", "UPerHead"):
        return None
    bb = model_cfg["backbone"]
    max_c = _stage_channels(bb, max_arch["backbone"]["body"]["width"])
    act_c = _stage_channels(bb, arch["backbone"]["body"]["width"])
    idx = head.get("in_index", -1)
    if isinstance(idx, (list, tuple)):
        idx = idx[-1]           # UPer: the pyramid runs on the last input
    ch = int(head.get("channels", 512))
    n = len(head.get("pool_scales", (1, 2, 3, 6)))
    return [max_c[idx]] + [ch] * n, [act_c[idx]] + [ch] * n


def _slice_tensor(src: torch.Tensor, shape: Tuple[int, ...],
                  concat: Optional[Tuple[List[int], List[int]]]
                  ) -> torch.Tensor:
    """``src`` cut to ``shape``: the concat's rows on the input axis, then a
    leading slice on every axis whose size differs; always a copy, so a
    saved subnet does not carry the supernet's storage."""
    out = src
    if tuple(out.shape) != tuple(shape):
        if concat is not None:
            rows = torch.from_numpy(_concat_row_indices(*concat))
            out = out.index_select(1, rows.to(out.device))
        out = out[tuple(slice(0, t) for t in shape)]
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"cannot cut {tuple(src.shape)} to {tuple(shape)}")
    return out.clone(memory_format=torch.contiguous_format)


def extract_subnet(model_cfg: Dict[str, Any],
                   state_dict: Dict[str, torch.Tensor],
                   meta: Optional[Dict[str, Any]] = None
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor],
                              Dict[str, Any]]:
    """Returns ``(subnet_model_cfg, subnet_state_dict, nested_arch)``. The
    target shapes come from the subnet built on the ``meta`` device
    (nothing allocated); a target entry the supernet lacks raises
    ``KeyError``. The tensors stay on ``state_dict``'s device."""
    max_arch = model_max_arch(model_cfg)
    arch = canonical_arch(max_arch, meta)
    sub_cfg = subnet_model_cfg(model_cfg, arch)
    with torch.device("meta"):
        target = build_segmentor(sub_cfg).state_dict()
    out = {}
    for key, t in target.items():
        if key not in state_dict:
            raise KeyError(f"missing supernet entry for {key}")
        out[key] = _slice_tensor(state_dict[key], tuple(t.shape),
                                 _concat_spec(key, model_cfg, max_arch, arch))
    return sub_cfg, out, arch


def subnet_name(meta: Dict[str, Any]) -> str:
    return meta_hash(meta)
