"""ElasticTransformer (the elastic ViT): a patch conv, a position
embedding and an optional cls token, then pre-norm layers (qkv, dense
attention of the active heads with a float32 softmax, proj, a two-layer
GELU FFN), its outputs at ``out_indices`` as maps on the patch grid. The
arch picks the embedding width, the depth, and each layer's heads and FFN
width; a head has ``HEAD_DIM`` lanes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ...lib.macs import _conv
from ..nets import Specs, conv, layer_norm

TYPES = ("ElasticTransformer", "ElasticTransformer1")
ROLE = "backbone"
HEAD_DIM = 64


def max_arch(bb: Dict[str, Any]) -> Dict[str, Any]:
    emb, depth = int(bb.get("embed_dim", 768)), int(bb.get("depth", 12))
    return {"embedding": {"width": emb},
            "encoder": {"depth": depth,
                        "num_heads": [int(bb.get("num_heads", 12))] * depth,
                        "ffn_channels": [int(bb.get("ffn_ratio", 4.0) * emb)]
                        * depth}}


def specs(bb: Dict[str, Any], S: Specs) -> List[int]:
    emb, depth = int(bb.get("embed_dim", 768)), int(bb.get("depth", 12))
    inner = int(bb.get("num_heads", 12)) * HEAD_DIM
    ffn = int(bb.get("ffn_ratio", 4.0) * emb)
    p = int(bb.get("patch_size", 16))
    grid = int(bb.get("img_size", 224)) // p
    S.conv("backbone.patch_embed.proj", 3, emb, p, bias=True)
    S.add("backbone.pos_embed", (1, grid * grid + 1, emb))
    if bb.get("with_cls_token", True):
        S.add("backbone.cls_token", (1, 1, emb))
    for i in range(depth):
        pre = f"backbone.blocks.{i}."
        S.norm(pre + "norm1", emb)
        S.add(pre + "attn.qkv.weight", (3 * inner, emb))
        S.add(pre + "attn.qkv.bias", (3 * inner,))
        S.add(pre + "attn.proj.weight", (emb, inner))
        S.add(pre + "attn.proj.bias", (emb,))
        S.norm(pre + "norm2", emb)
        S.add(pre + "mlp.fc1.weight", (ffn, emb))
        S.add(pre + "mlp.fc1.bias", (ffn,))
        S.add(pre + "mlp.fc2.weight", (emb, ffn))
        S.add(pre + "mlp.fc2.bias", (emb,))
    return [emb] * len(bb.get("out_indices", (2, 5, 8, 11)))


def forward(nm, P, x, arch, cfg, train, stats=None) -> List[torch.Tensor]:
    p = int(cfg.get("patch_size", 16))
    emb = int(arch["embedding"]["width"])
    enc = arch["encoder"]
    b = x.shape[0]
    gh, gw = x.shape[2] // p, x.shape[3] // p
    x = conv(nm, P, "backbone.patch_embed.proj", x, emb, p, padding=0)
    x = x.flatten(2).transpose(1, 2)
    pos = P["backbone.pos_embed"]
    if pos.shape[1] - 1 != gh * gw:
        raise ValueError("the reference runs the ViT at its own grid only")
    x = x + pos[:, 1:, :emb]
    with_cls = cfg.get("with_cls_token", True)
    if with_cls:
        cls = (P["backbone.cls_token"] + pos[:, :1])[..., :emb]
        x = torch.cat([cls.expand(b, -1, -1), x], 1)
    outs = []
    out_indices = list(cfg.get("out_indices", (2, 5, 8, 11)))
    for i in range(int(cfg.get("depth", 12))):
        if i < int(enc["depth"]):
            pre = f"backbone.blocks.{i}."
            x = x + _attention(nm, P, pre + "attn", layer_norm(
                P, pre + "norm1", x), int(enc["num_heads"][i]))
            f = int(enc["ffn_channels"][i])
            y = layer_norm(P, pre + "norm2", x)
            y = F.gelu(nm.linear(y, P[pre + "mlp.fc1.weight"][:f, :emb],
                                 P[pre + "mlp.fc1.bias"][:f]))
            x = x + nm.linear(y, P[pre + "mlp.fc2.weight"][:emb, :f],
                              P[pre + "mlp.fc2.bias"][:emb])
        if i in out_indices:
            t = x[:, 1:] if with_cls else x
            outs.append(t.transpose(1, 2).reshape(b, emb, gh, gw))
    return outs


def _attention(nm, P, name, x, heads: int):
    b, n, c = x.shape
    w_all, b_all = P[name + ".qkv.weight"], P[name + ".qkv.bias"]
    inner = w_all.shape[0] // 3
    width = heads * HEAD_DIM
    w = w_all.view(3, inner, -1)[:, :width, :c].reshape(3 * width, c)
    bias = b_all.view(3, inner)[:, :width].reshape(-1)
    q, k, v = nm.linear(x, w, bias).view(b, n, 3, heads,
                                         HEAD_DIM).unbind(2)
    logits = nm.bmm(q, k, "bnhd,bmhd->bhnm") / math.sqrt(HEAD_DIM)
    attn = torch.softmax(logits, -1)
    out = nm.bmm(attn, v, "bhnm,bmhd->bnhd").reshape(b, n, width)
    return nm.linear(out, P[name + ".proj.weight"][:c, :width],
                     P[name + ".proj.bias"][:c])


def macs(bb: Dict[str, Any], arch: Dict[str, Any], hw):
    """(MACs, [(channels, (h, w)) at ``out_indices``]); attention counts
    ``2 * N^2 * HEAD_DIM`` a head (``QK^T`` and ``PV``)."""
    p = int(bb.get("patch_size", 16))
    emb = int(arch["embedding"]["width"])
    enc = arch["encoder"]
    gh, gw = hw[0] // p, hw[1] // p
    n = gh * gw + (1 if bb.get("with_cls_token", True) else 0)
    total = _conv((gh, gw), 3, emb, p)
    for i in range(int(enc["depth"])):
        inner = int(enc["num_heads"][i]) * HEAD_DIM
        f = int(enc["ffn_channels"][i])
        total += n * emb * 3 * inner + 2 * n * n * inner + n * inner * emb
        total += 2 * n * emb * f
    outs = [(emb, (gh, gw)) for _ in bb.get("out_indices", (2, 5, 8, 11))]
    return total, outs
