"""JAX supernet variables -> port ``state_dict``.

Carries weights from the JAX package to the port: ``variables_np`` is the
JAX ``{'params', 'batch_stats'}`` tree with numpy leaves (no JAX needed
here). Conv kernels go HWIO -> OIHW and linear kernels ``[in, out]`` ->
``[out, in]``; BN ``scale/bias/mean/var`` become
``weight/bias/running_mean/running_var`` and LN ``scale`` ``weight``; the
ViT's separate ``w_q/w_k/w_v`` become one fused ``qkv``. Names follow the
reference mmseg / timm layout the port's modules use, so the JAX package's
own ``segmentor_state_dict_to_variables`` (``engine/torch_convert.py:294``)
and ``vit_state_dict_to_params`` (``:489``) map the result back. Covers the
DynamicResNet (unrolled blocks; the plain or deep stem, ``stem0-2`` ->
mmseg's ``stem.{0,1,3,4,6,7}``; avg_down's ``downsample.{1,2}``) and
ElasticTransformer backbones, the multi-level neck and the PSP/UPer/FCN
(with ``conv_cat``)/ASPP/DeepLabV3+ heads. The JAX converter maps no ASPP
key back and reads ``downsample.0`` as avg_down's conv (ROADMAP C12).
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def conv_state(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX conv's ``{kernel[, bias]}`` -> ``{weight[, bias]}`` (OIHW)."""
    out = {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def linear_state(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX dense ``{kernel [in, out][, bias]}`` -> ``{weight [out, in]
    [, bias]}``."""
    out = {"weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def ln_state(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def bn_state(p: Dict[str, Any], s: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX BN's params + stats -> torch BN ``state_dict`` entries."""
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(s["mean"]), "running_var": _t(s["var"])}


def _put(sd, prefix, entries):
    sd.update({f"{prefix}.{k}": v for k, v in entries.items()})


def backbone_state_dict(p: Dict[str, Any], s: Dict[str, Any],
                        prefix: str = "backbone", avg_down: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """``backbone_m`` params/stats of a DynamicResNet -> state_dict
    (``avg_down``: the shortcut's conv and BN sit behind its pool)."""
    pre = f"{prefix}." if prefix else ""
    sd: Dict[str, torch.Tensor] = {}
    if "stem1" in p:
        for i in range(3):
            _put(sd, f"{pre}stem.{3 * i}", conv_state(p[f"stem{i}"]["conv"]))
            _put(sd, f"{pre}stem.{3 * i + 1}",
                 bn_state(p[f"stem{i}"]["bn"], s[f"stem{i}"]["bn"]))
    else:
        _put(sd, pre + "conv1", conv_state(p["stem0"]["conv"]))
        _put(sd, pre + "bn1", bn_state(p["stem0"]["bn"], s["stem0"]["bn"]))
    ds = (1, 2) if avg_down else (0, 1)
    stage = 1
    while f"layer{stage}" in p:
        lp, ls = p[f"layer{stage}"], s[f"layer{stage}"]
        if "blocks" in lp:
            raise NotImplementedError("scan_blocks (stacked) backbones wait "
                                      "for a later slice")
        b = 0
        while f"block{b}" in lp:
            bp, bs = lp[f"block{b}"], ls[f"block{b}"]
            blk = f"{pre}layer{stage}.{b}"
            for k in (1, 2, 3):
                _put(sd, f"{blk}.conv{k}", conv_state(bp[f"conv{k}"]))
                _put(sd, f"{blk}.bn{k}", bn_state(bp[f"bn{k}"], bs[f"bn{k}"]))
            if "downsample_conv" in bp:
                _put(sd, f"{blk}.downsample.{ds[0]}",
                     conv_state(bp["downsample_conv"]))
                _put(sd, f"{blk}.downsample.{ds[1]}",
                     bn_state(bp["downsample_bn"], bs["downsample_bn"]))
            b += 1
        stage += 1
    return sd


def vit_state_dict(p: Dict[str, Any], prefix: str = "backbone"
                   ) -> Dict[str, torch.Tensor]:
    """``backbone_m`` params of an ElasticTransformer -> state_dict."""
    if any(k.startswith("rel_pos") for k in p.get("layer0", {}).get(
            "attn", {})):
        raise NotImplementedError("relative positions wait for a later "
                                  "slice")
    pre = f"{prefix}." if prefix else ""
    sd = {f"{pre}pos_embed": _t(p["pos_embed"])}
    if "cls_token" in p:
        sd[f"{pre}cls_token"] = _t(p["cls_token"])
    _put(sd, pre + "patch_embed.proj", conv_state(p["patch_embed"]))
    i = 0
    while f"layer{i}" in p:
        lp, blk = p[f"layer{i}"], f"{pre}blocks.{i}"
        attn = lp["attn"]
        qkv = [linear_state(attn[n]) for n in ("w_q", "w_k", "w_v")]
        sd[f"{blk}.attn.qkv.weight"] = torch.cat([e["weight"] for e in qkv])
        sd[f"{blk}.attn.qkv.bias"] = torch.cat([e["bias"] for e in qkv])
        _put(sd, f"{blk}.attn.proj", linear_state(attn["proj"]))
        for n in ("norm1", "norm2"):
            _put(sd, f"{blk}.{n}", ln_state(lp[n]))
        for n in ("fc1", "fc2"):
            _put(sd, f"{blk}.mlp.{n}", linear_state(lp[n]))
        i += 1
    return sd


def neck_state_dict(p: Dict[str, Any], prefix: str = "neck"
                    ) -> Dict[str, torch.Tensor]:
    """``neck_m`` params of the multi-level neck (convs with bias, no
    norm) -> state_dict."""
    pre = f"{prefix}." if prefix else ""
    sd: Dict[str, torch.Tensor] = {}
    for name, mp in p.items():
        m = re.fullmatch(r"(lateral|conv)(\d+)", name)
        if m is None:
            raise NotImplementedError(f"neck submodule {name!r} waits for a "
                                      "later slice")
        group = "lateral_convs" if m.group(1) == "lateral" else "convs"
        _put(sd, f"{pre}{group}.{m.group(2)}.conv", conv_state(mp["conv"]))
    return sd


_HEAD_MODULES = {"bottleneck": "bottleneck", "psp_bottleneck": "bottleneck",
                 "fpn_bottleneck": "fpn_bottleneck", "conv_cat": "conv_cat",
                 "image_pool": "image_pool.1", "c1_proj": "c1_bottleneck"}
_SEP_MODULES = {"fuse1": "sep_bottleneck.0", "fuse2": "sep_bottleneck.1"}
_HEAD_LISTS = {"conv": "convs", "lateral": "lateral_convs",
               "fpn_conv": "fpn_convs"}


def _head_state_dict(prefix, p, s, cfg) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def module(name, mp, ms):
        _put(sd, f"{prefix}.{name}.conv", conv_state(mp["conv"]))
        _put(sd, f"{prefix}.{name}.bn", bn_state(mp["bn"], ms["bn"]))

    def sep_module(name, mp, ms):
        """JAX ``SepConvModule`` (``dw``, ``dw_bn``, ``pw``) -> mmcv's
        ``depthwise_conv`` / ``pointwise_conv``."""
        _put(sd, f"{prefix}.{name}.depthwise_conv.conv", conv_state(mp["dw"]))
        _put(sd, f"{prefix}.{name}.depthwise_conv.bn",
             bn_state(mp["dw_bn"], ms["dw_bn"]))
        module(f"{name}.pointwise_conv", mp["pw"], ms["pw"])

    for name in p:
        listed = re.fullmatch(r"(conv|lateral|fpn_conv)(\d+)", name)
        if name == "conv_seg":
            _put(sd, f"{prefix}.conv_seg", conv_state(p[name]))
        elif name in _HEAD_MODULES:
            module(_HEAD_MODULES[name], p[name], s[name])
        elif name == "psp_modules":
            scales = tuple(cfg.get("pool_scales", (1, 2, 3, 6)))
            for i, sc in enumerate(scales):
                module(f"psp_modules.{i}.1", p[name][f"pool{sc}"],
                       s[name][f"pool{sc}"])
        elif name in _SEP_MODULES:
            sep_module(_SEP_MODULES[name], p[name], s[name])
        elif name == "aspp":
            for branch in p[name]:
                i = int(branch[len("branch"):])
                bp, bs = p[name][branch], s[name][branch]
                (sep_module if "dw" in bp else module)(
                    f"aspp_modules.{i}", bp, bs)
        elif listed:
            module(f"{_HEAD_LISTS[listed.group(1)]}.{listed.group(2)}",
                   p[name], s[name])
        else:
            raise NotImplementedError(f"head submodule {name!r} waits for a "
                                      "later slice")
    return sd


def variables_to_state_dict(variables_np: Dict[str, Any],
                            model_cfg: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    if "patch_embed" in params["backbone_m"]:
        sd = vit_state_dict(params["backbone_m"])
    else:
        sd = backbone_state_dict(
            params["backbone_m"], stats["backbone_m"],
            avg_down=bool(model_cfg["backbone"].get("avg_down", False)))
    if "neck_m" in params:
        sd.update(neck_state_dict(params["neck_m"]))
    sd.update(_head_state_dict("decode_head", params["decode_head_m"],
                               stats["decode_head_m"],
                               dict(model_cfg["decode_head"])))
    aux = model_cfg.get("auxiliary_head")
    aux_list = list(aux) if isinstance(aux, (list, tuple)) else \
        ([aux] if aux else [])
    for i, a_cfg in enumerate(aux_list):
        prefix = "auxiliary_head" if len(aux_list) == 1 \
            else f"auxiliary_head.{i}"
        sd.update(_head_state_dict(prefix, params[f"aux_heads_{i}"],
                                   stats[f"aux_heads_{i}"], dict(a_cfg)))
    return sd
