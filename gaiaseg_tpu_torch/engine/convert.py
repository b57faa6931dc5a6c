"""JAX supernet variables -> port ``state_dict``.

Carries weights from the JAX package to the port: ``variables_np`` is the
JAX ``{'params', 'batch_stats'}`` tree with numpy leaves (no JAX needed
here). Conv kernels go HWIO -> OIHW; BN ``scale/bias/mean/var`` become
``weight/bias/running_mean/running_var``; names follow the reference
mmseg layout the port's modules use, so the JAX package's own
``segmentor_state_dict_to_variables`` (``engine/torch_convert.py:294``)
maps the result back. Covers the DynamicResNet (unrolled blocks, plain
stem) + PSP/FCN segmentor of this slice.
"""
from __future__ import annotations

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


def bn_state(p: Dict[str, Any], s: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX BN's params + stats -> torch BN ``state_dict`` entries."""
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(s["mean"]), "running_var": _t(s["var"])}


def _put(sd, prefix, entries):
    sd.update({f"{prefix}.{k}": v for k, v in entries.items()})


def backbone_state_dict(p: Dict[str, Any], s: Dict[str, Any],
                        prefix: str = "backbone"
                        ) -> Dict[str, torch.Tensor]:
    """``backbone_m`` params/stats of a DynamicResNet -> state_dict."""
    if "stem0" not in p or "stem1" in p:
        raise NotImplementedError("deep-stem backbones wait for a later slice")
    pre = f"{prefix}." if prefix else ""
    sd: Dict[str, torch.Tensor] = {}
    _put(sd, pre + "conv1", conv_state(p["stem0"]["conv"]))
    _put(sd, pre + "bn1", bn_state(p["stem0"]["bn"], s["stem0"]["bn"]))
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
                _put(sd, f"{blk}.downsample.0",
                     conv_state(bp["downsample_conv"]))
                _put(sd, f"{blk}.downsample.1",
                     bn_state(bp["downsample_bn"], bs["downsample_bn"]))
            b += 1
        stage += 1
    return sd


def _head_state_dict(prefix, p, s, cfg) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def module(name, mp, ms):
        _put(sd, f"{prefix}.{name}.conv", conv_state(mp["conv"]))
        _put(sd, f"{prefix}.{name}.bn", bn_state(mp["bn"], ms["bn"]))

    for name in p:
        if name == "conv_seg":
            _put(sd, f"{prefix}.conv_seg", conv_state(p[name]))
        elif name == "bottleneck":
            module("bottleneck", p[name], s[name])
        elif name == "psp_modules":
            scales = tuple(cfg.get("pool_scales", (1, 2, 3, 6)))
            for i, sc in enumerate(scales):
                module(f"psp_modules.{i}.1", p[name][f"pool{sc}"],
                       s[name][f"pool{sc}"])
        elif name.startswith("conv") and name[4:].isdigit():
            module(f"convs.{name[4:]}", p[name], s[name])
        else:
            raise NotImplementedError(f"head submodule {name!r} waits for a "
                                      "later slice")
    return sd


def variables_to_state_dict(variables_np: Dict[str, Any],
                            model_cfg: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    sd = backbone_state_dict(params["backbone_m"], stats["backbone_m"])
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
