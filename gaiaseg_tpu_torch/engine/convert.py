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
DynamicResNet (unrolled blocks, or ``scan_blocks``' stacked tail blocks
unstacked; the plain or deep stem, ``stem0-2`` -> mmseg's
``stem.{0,1,3,4,6,7}``; avg_down's ``downsample.{1,2}``),
ElasticTransformer (its relative-position tables too), DynamicConvNeXt
(the upstream ConvNeXt layout), ElasticConvformer and ElasticMixViT
(JAX's names; no upstream SegFormer layout is read) backbones, the
multi-level neck and the PSP/UPer/FCN (with ``conv_cat``)/ASPP/
DeepLabV3+/SegFormer heads, and a distiller's teacher
(``t_backbone``, a BEiT or a DynamicResNet, ``t_neck``, ``t_decode_head``)
into its ``t_*`` keys: BEiT in the official layout, its k bias dropped (a
bias added to every key of a row moves no softmax) and its FPN deconv
kernels flipped in space (flax's ``ConvTranspose`` with its defaults
computes ``out[2i] = x[i] w[1]``, ``out[2i+1] = x[i] w[0]``). The JAX
converter maps no ASPP key back and reads ``downsample.0`` as avg_down's
conv (ROADMAP C12).
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


def _unstack_blocks(layer: Dict[str, Any]) -> Dict[str, Any]:
    """A ``scan_blocks`` stage (``block0`` + ``blocks.b``, every leaf of the
    tail blocks stacked on a leading depth axis) -> the unrolled layout
    ``block0 .. block{n}``; an unrolled stage as it is."""
    if "blocks" not in layer:
        return layer
    stacked = layer["blocks"]["b"]
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, dict) else np.asarray(v)[i]
                for k, v in tree.items()}
    out = {k: v for k, v in layer.items() if k != "blocks"}
    out.update({f"block{i + 1}": take(stacked, i)
                for i in range(np.shape(leaf)[0])})
    return out


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
        lp, ls = _unstack_blocks(p[f"layer{stage}"]), \
            _unstack_blocks(s[f"layer{stage}"])
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


def attn_state(p: Dict[str, Any], prefix: str,
               rel_max_dist: int = 14) -> Dict[str, torch.Tensor]:
    """A JAX ``ElasticMHA`` (``w_q/w_k/w_v``, ``proj``, the relative-position
    tables ``rel_pos``/``rel_pos_v`` when present) -> the fused ``qkv``,
    ``proj`` and ``rel_pos_embed_k``/``_v`` entries under ``prefix``. JAX
    sizes every table for distance 14 whatever the backbone's
    ``rel_max_dist`` (ROADMAP C18); its index reads the first
    ``2 * rel_max_dist + 2`` rows, the port's tables' size."""
    qkv = [linear_state(p[n]) for n in ("w_q", "w_k", "w_v")]
    sd = {f"{prefix}.qkv.weight": torch.cat([e["weight"] for e in qkv]),
          f"{prefix}.qkv.bias": torch.cat([e["bias"] for e in qkv])}
    _put(sd, f"{prefix}.proj", linear_state(p["proj"]))
    for name, slot in (("rel_pos", "rel_pos_embed_k"),
                       ("rel_pos_v", "rel_pos_embed_v")):
        if name in p:
            for table in ("rel_rows", "rel_cols"):
                sd[f"{prefix}.{slot}.{table}"] = _t(
                    p[name][table])[:2 * rel_max_dist + 2]
    return sd


def encoder_layer_state(p: Dict[str, Any], prefix: str,
                        rel_max_dist: int = 14) -> Dict[str, torch.Tensor]:
    """A JAX pre-norm transformer layer (the ViT's ``layer{i}``, Conformer's
    ``trans_1`` and ``trans_block``) -> the timm names under ``prefix``."""
    sd = attn_state(p["attn"], f"{prefix}.attn", rel_max_dist)
    for n in ("norm1", "norm2"):
        _put(sd, f"{prefix}.{n}", ln_state(p[n]))
    for n in ("fc1", "fc2"):
        _put(sd, f"{prefix}.mlp.{n}", linear_state(p[n]))
    return sd


def vit_state_dict(p: Dict[str, Any], prefix: str = "backbone",
                   rel_max_dist: int = 14) -> Dict[str, torch.Tensor]:
    """``backbone_m`` params of an ElasticTransformer (its ``rel_max_dist``
    given) -> state_dict."""
    pre = f"{prefix}." if prefix else ""
    sd = {f"{pre}pos_embed": _t(p["pos_embed"])}
    if "cls_token" in p:
        sd[f"{pre}cls_token"] = _t(p["cls_token"])
    _put(sd, pre + "patch_embed.proj", conv_state(p["patch_embed"]))
    i = 0
    while f"layer{i}" in p:
        sd.update(encoder_layer_state(p[f"layer{i}"], f"{pre}blocks.{i}",
                                      rel_max_dist))
        i += 1
    return sd


def mixvit_state_dict(p: Dict[str, Any], prefix: str = "backbone"
                      ) -> Dict[str, torch.Tensor]:
    """``backbone_m`` params of an ElasticMixViT -> state_dict: JAX's
    names in PyTorch form (``patch{i}``, ``stage{i}_block{j}.attn.q`` ...,
    ``out_norm{i}``; the depthwise ``dwconv`` ``[3, 3, 1, C]`` ->
    ``[C, 1, 3, 3]``)."""
    return _tree_state(p, {}, prefix, lambda name: name)


def _tree_state(p: Dict[str, Any], s: Dict[str, Any], prefix: str,
                rename) -> Dict[str, torch.Tensor]:
    """A JAX module tree -> state_dict entries by the kind of each leaf
    module: a 4-D ``kernel`` a conv (HWIO -> OIHW, a depthwise ``[k, k, 1,
    C]`` -> ``[C, 1, k, k]``), a 2-D one a linear; a ``scale`` a BN when
    it has ``batch_stats``, else a LayerNorm; a ViT layer (an ``attn``
    with ``w_q`` beside ``norm1``) by ``encoder_layer_state``; a bare array
    (``gamma``, ``cls_token``) as it is. ``rename`` maps a JAX name to the
    port's."""
    sd: Dict[str, torch.Tensor] = {}
    for name, sub in p.items():
        key = f"{prefix}.{rename(name)}" if prefix else rename(name)
        stats = (s or {}).get(name)
        if not isinstance(sub, dict):
            sd[key] = _t(sub)
        elif "kernel" in sub:
            _put(sd, key, conv_state(sub) if np.ndim(sub["kernel"]) == 4
                 else linear_state(sub))
        elif "scale" in sub:
            _put(sd, key, bn_state(sub, stats) if stats else ln_state(sub))
        elif "attn" in sub and "norm1" in sub and "w_q" in sub["attn"]:
            sd.update(encoder_layer_state(sub, key))
        else:
            sd.update(_tree_state(sub, stats, key, rename))
    return sd


def _convnext_name(name: str) -> str:
    """JAX ``stem``, ``stem_ln``, ``ds{i}_ln``, ``ds{i}_conv``,
    ``stage{i}_block{j}`` -> the upstream ConvNeXt layout."""
    fixed = {"stem": "downsample_layers.0.0",
             "stem_ln": "downsample_layers.0.1"}
    if name in fixed:
        return fixed[name]
    m = re.fullmatch(r"ds(\d)_(ln|conv)", name)
    if m:
        return f"downsample_layers.{m.group(1)}.{int(m.group(2) == 'conv')}"
    m = re.fullmatch(r"stage(\d+)_block(\d+)", name)
    return f"stages.{m.group(1)}.{m.group(2)}" if m else name


def convnext_state_dict(p: Dict[str, Any], prefix: str = "backbone"
                        ) -> Dict[str, torch.Tensor]:
    """``backbone_m`` params of a DynamicConvNeXt -> state_dict."""
    return _tree_state(p, {}, prefix, _convnext_name)


def _convformer_name(name: str) -> str:
    """JAX ``stage{s}_block{b}`` -> ``stages.{s}.{b}``; the rest keep
    their names."""
    m = re.fullmatch(r"stage(\d+)_block(\d+)", name)
    return f"stages.{m.group(1)}.{m.group(2)}" if m else name


def convformer_state_dict(p: Dict[str, Any], s: Dict[str, Any],
                          prefix: str = "backbone"
                          ) -> Dict[str, torch.Tensor]:
    """``backbone_m`` params and BN statistics of an ElasticConvformer ->
    state_dict."""
    return _tree_state(p, s, prefix, _convformer_name)


def deconv_state(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``ConvTranspose`` (``transpose_kernel=False``) kernel ``[kh,
    kw, in, out]`` -> torch ``ConvTranspose2d`` ``[in, out, kh, kw]``,
    flipped in space."""
    k = np.asarray(p["kernel"])[::-1, ::-1]
    return {"weight": _t(k.transpose(2, 3, 0, 1)), "bias": _t(p["bias"])}


def beit_state_dict(p: Dict[str, Any], prefix: str = "t_backbone"
                    ) -> Dict[str, torch.Tensor]:
    """A JAX BEiT's params -> the port's (official-layout) state dict."""
    pre = f"{prefix}." if prefix else ""
    sd = {f"{pre}cls_token": _t(p["cls_token"])}
    _put(sd, pre + "patch_embed.proj", conv_state(p["patch_embed"]))
    if "rel_pos_bias_table" in p:
        sd[f"{pre}rel_pos_bias.relative_position_bias_table"] = _t(
            p["rel_pos_bias_table"])
    i = 0
    while f"block{i}" in p:
        bp, blk = p[f"block{i}"], f"{pre}blocks.{i}"
        qkv = linear_state(bp["qkv"])
        d = qkv["weight"].shape[1]
        sd[f"{blk}.attn.qkv.weight"] = qkv["weight"]
        sd[f"{blk}.attn.q_bias"] = qkv["bias"][:d].clone()
        sd[f"{blk}.attn.v_bias"] = qkv["bias"][2 * d:].clone()
        _put(sd, f"{blk}.attn.proj", linear_state(bp["proj"]))
        if f"rel_pos_bias_table_{i}" in p:
            sd[f"{blk}.attn.relative_position_bias_table"] = _t(
                p[f"rel_pos_bias_table_{i}"])
        for n in ("norm1", "norm2"):
            _put(sd, f"{blk}.{n}", ln_state(bp[n]))
        for n in ("fc1", "fc2"):
            _put(sd, f"{blk}.mlp.{n}", linear_state(bp[n]))
        for g in ("gamma_1", "gamma_2"):
            sd[f"{blk}.{g}"] = _t(bp[g])
        i += 1
    for name, slot in (("fpn1_deconv1", "fpn1.0"), ("fpn1_deconv2", "fpn1.3"),
                       ("fpn2_deconv", "fpn2.0")):
        _put(sd, pre + slot, deconv_state(p[name]))
    _put(sd, pre + "fpn1.1", ln_state(p["fpn1_norm"]))
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
                 "image_pool": "image_pool.1", "c1_proj": "c1_bottleneck",
                 "fuse": "fuse"}
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
        elif re.fullmatch(r"mlp\d+", name):         # SegFormer's linears
            _put(sd, f"{prefix}.{name}", linear_state(p[name]))
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
    bb_type = model_cfg["backbone"].get("type")
    if bb_type == "DynamicConvNeXt":
        sd = convnext_state_dict(params["backbone_m"])
    elif bb_type in ("ElasticMixViT", "ElasticSegFormer"):
        sd = mixvit_state_dict(params["backbone_m"])
    elif bb_type == "ElasticConvformer":
        sd = convformer_state_dict(params["backbone_m"],
                                   stats.get("backbone_m", {}))
    elif "patch_embed" in params["backbone_m"]:
        sd = vit_state_dict(params["backbone_m"], rel_max_dist=int(
            model_cfg["backbone"].get("rel_max_dist", 14)))
    else:
        sd = backbone_state_dict(
            params["backbone_m"], stats["backbone_m"],
            avg_down=bool(model_cfg["backbone"].get("avg_down", False)))
    if "neck_m" in params:
        sd.update(neck_state_dict(params["neck_m"]))
    sd.update(_head_state_dict("decode_head", params["decode_head_m"],
                               stats["decode_head_m"],
                               dict(model_cfg["decode_head"])))
    if "t_backbone" in params:
        sd.update(teacher_state_dict(params, stats, model_cfg))
    aux = model_cfg.get("auxiliary_head")
    aux_list = list(aux) if isinstance(aux, (list, tuple)) else \
        ([aux] if aux else [])
    for i, a_cfg in enumerate(aux_list):
        prefix = "auxiliary_head" if len(aux_list) == 1 \
            else f"auxiliary_head.{i}"
        sd.update(_head_state_dict(prefix, params[f"aux_heads_{i}"],
                                   stats[f"aux_heads_{i}"], dict(a_cfg)))
    return sd


def teacher_state_dict(params: Dict[str, Any], stats: Dict[str, Any],
                       model_cfg: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX distiller's ``t_backbone`` / ``t_neck`` / ``t_decode_head``
    -> the port's ``t_*`` entries."""
    bb = params["t_backbone"]
    if "patch_embed" in bb:
        sd = beit_state_dict(bb)
    else:
        sd = backbone_state_dict(
            bb, stats["t_backbone"], prefix="t_backbone",
            avg_down=bool(model_cfg["teacher_backbone"].get("avg_down",
                                                            False)))
    if "t_neck" in params:
        sd.update(neck_state_dict(params["t_neck"], prefix="t_neck"))
    if "t_decode_head" in params:
        sd.update(_head_state_dict(
            "t_decode_head", params["t_decode_head"],
            stats.get("t_decode_head", {}),
            dict(model_cfg["teacher_decode_head"])))
    return sd
