"""Subnet extraction: slice the supernet's state dict into a standalone
subnet.

Port of ``gaiaseg_tpu/engine/extract.py`` (the reference's
``tools/extract_subnet.py`` + gaiavision ``model.deploy()``). The subnet's
config is the supernet's with the backbone's MAX widths and depths replaced
by the arch's; every tensor of its state dict is cut from the supernet's.
Widths are prefix slices, so each tensor is a leading slice on every axis
whose size differs, except the kernel of a conv whose input is a concat with
an elastic first segment (the PSP / UPer bottleneck, FCN ``conv_cat``): it
keeps the rows ``[0, a) ++ [m, m + n*ch)`` of its input axis (OIHW axis
1), the rows ``DynConv2d(in_tail=n*ch)`` reads in the supernet; an FCN
head under ``resize_concat`` keeps each stage's active rows of its first
conv and ``conv_cat``. The ASPP and DeepLabV3+ heads need leading slices
only: their elastic inputs (the image pool, every ASPP branch, the
depthwise conv and BN, ``c1_bottleneck``) each read a prefix, and every
concat inside them is of static widths. The subnet runs through the same
modules at its own MAX, so it equals the supernet at the arch.

``build_head`` checks a head's ``in_channels`` (and a DeepLabV3+ head's
``c1_in_channels``) against the backbone's output channels, where Flax
infers input widths, so ``subnet_model_cfg`` also sets them to the
subnet's. A 3-list stem width becomes the subnet's deep stem.
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
    if head.get("type") in ("DepthwiseSeparableASPPHead",
                            "DynamicSepASPPHead"):
        head["c1_in_channels"] = channels[int(head.get("c1_in_index", 0))]
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


def _heads(model_cfg: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """State-dict prefix -> head config, the decode head and each aux."""
    heads = {"decode_head": dict(model_cfg["decode_head"])}
    aux = model_cfg.get("auxiliary_head")
    if isinstance(aux, (list, tuple)):
        heads.update({f"auxiliary_head.{i}": dict(a)
                      for i, a in enumerate(aux)})
    elif aux:
        heads["auxiliary_head"] = dict(aux)
    return heads


_FCN = ("DynamicFCNHead", "FCNHead")
_PYRAMID = ("DynamicPSPHead", "PSPHead", "DynamicUPerHead", "UPerHead")


def _concat_spec(key: str, model_cfg: Dict[str, Any],
                 max_arch: Dict[str, Any], arch: Dict[str, Any]
                 ) -> Optional[Tuple[List[int], List[int]]]:
    """(max_segments, active_segments) of the conv input for the state dict
    entries that consume an elastic concat: the PSP / UPer bottleneck (JAX
    ``decode_head_m/bottleneck`` and ``psp_bottleneck``), FCN ``conv_cat``
    (JAX ``extract.py:91-103``) and an FCN's first conv under
    ``resize_concat``; None for plain leading-slice entries."""
    if not key.endswith(".conv.weight"):
        return None
    module = key[:-len(".conv.weight")]
    found = [(p, h) for p, h in _heads(model_cfg).items()
             if module.startswith(p + ".")]
    if not found:
        return None
    prefix, head = max(found, key=lambda f: len(f[0]))
    name = module[len(prefix) + 1:]
    bb = model_cfg["backbone"]
    max_c = _stage_channels(bb, max_arch["backbone"]["body"]["width"])
    act_c = _stage_channels(bb, arch["backbone"]["body"]["width"])
    idx = head.get("in_index", -1)
    if head.get("input_transform") == "resize_concat":
        if head.get("type") not in _FCN:
            raise NotImplementedError(
                f"extracting a {head.get('type')} under resize_concat")
        idx = list(idx) if isinstance(idx, (list, tuple)) else [idx]
        max_segs = [max_c[i] for i in idx]
        act_segs = [act_c[i] for i in idx]
    else:
        if isinstance(idx, (list, tuple)):
            idx = idx[-1]       # UPer: the pyramid runs on the last input
        max_segs, act_segs = [max_c[idx]], [act_c[idx]]
    ch = int(head.get("channels", 512))
    if head.get("type") in _PYRAMID and name == "bottleneck":
        n = len(head.get("pool_scales", (1, 2, 3, 6)))
        return max_segs + [ch] * n, act_segs + [ch] * n
    if head.get("type") in _FCN and name == "conv_cat":
        return max_segs + [ch], act_segs + [ch]
    if head.get("type") in _FCN and name == "convs.0" and len(max_segs) > 1:
        return max_segs, act_segs
    return None


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
