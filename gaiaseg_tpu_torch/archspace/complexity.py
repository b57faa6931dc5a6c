"""Analytic FLOPs/params for sampled subnets — no tracing required.

A copy of ``gaiaseg_tpu/archspace/complexity.py`` (pure Python; importing
the JAX package's module would load jax through its package ``__init__``).

Capability parity with gaiavision ``get_model_complexity_info`` as used by
reference tools/count_flops.py:128-158: per-subnet FLOPs+params at the
*active* (manipulated) channels/depth, an ``only_backbone_flops`` switch, and
input ``(3, H, W)``. SURVEY.md §7 step 1: complexity is pure conv arithmetic
on the arch meta, reproducing the reference metadata without running a model.

Conventions follow the mmcv flops counter the reference relies on:
conv/linear = multiply-accumulates (k*k*Cin/groups*Cout*Hout*Wout), BN = 2x
elements (affine), act/pool = elements.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple


class Acc:
    def __init__(self):
        self.flops = 0.0
        self.params = 0.0

    def conv(self, k, cin, cout, hout, wout, groups=1, bias=False):
        kk = k * k if isinstance(k, int) else k[0] * k[1]
        self.flops += kk * (cin / groups) * cout * hout * wout
        self.params += kk * (cin / groups) * cout + (cout if bias else 0)
        if bias:
            self.flops += cout * hout * wout

    def linear(self, cin, cout, n=1, bias=True):
        self.flops += cin * cout * n
        self.params += cin * cout + (cout if bias else 0)

    def bn(self, c, h, w):
        self.flops += 2 * c * h * w
        self.params += 2 * c

    def ln(self, c, n):
        self.flops += 2 * c * n
        self.params += 2 * c

    def act(self, c, h, w):
        self.flops += c * h * w

    def pool(self, c, h, w):
        self.flops += c * h * w


def _out_size(size: int, stride: int) -> int:
    return int(math.ceil(size / stride))


def resnet_complexity(acc: Acc, backbone_cfg: Dict[str, Any],
                      arch: Dict[str, Any], h: int, w: int
                      ) -> List[Tuple[int, int, int]]:
    """Counts the active DynamicResNet; returns per-stage (C, H, W) outputs."""
    stem = arch["stem"]["width"]
    stem_ws = stem if isinstance(stem, (list, tuple)) else [stem]
    widths = list(arch["body"]["width"])
    depths = list(arch["body"]["depth"])
    strides = list(backbone_cfg.get("strides", (1, 2, 2, 2)))
    dilations = list(backbone_cfg.get("dilations", (1, 1, 1, 1)))
    deep_stem = bool(backbone_cfg.get("deep_stem", False))
    out_indices = list(backbone_cfg.get("out_indices", (0, 1, 2, 3)))
    expansion = 4

    cin = 3
    if deep_stem:
        sw = stem_ws if len(stem_ws) == 3 else [stem_ws[0] // 2,
                                                stem_ws[0] // 2, stem_ws[0]]
        h, w = _out_size(h, 2), _out_size(w, 2)
        for i, c in enumerate(sw):
            acc.conv(3, cin, c, h, w)
            acc.bn(c, h, w)
            acc.act(c, h, w)
            cin = c
    else:
        c = stem_ws[0]
        h, w = _out_size(h, 2), _out_size(w, 2)
        acc.conv(7, cin, c, h, w)
        acc.bn(c, h, w)
        acc.act(c, h, w)
        cin = c
    h, w = _out_size(h, 2), _out_size(w, 2)   # maxpool /2
    acc.pool(cin, h, w)

    outs = []
    for si in range(4):
        planes, depth, stride = widths[si], depths[si], strides[si]
        for bi in range(depth):
            s = stride if bi == 0 else 1
            oh, ow = _out_size(h, s), _out_size(w, s)
            acc.conv(1, cin, planes, h, w)
            acc.bn(planes, h, w)
            acc.act(planes, h, w)
            acc.conv(3, planes, planes, oh, ow)
            acc.bn(planes, oh, ow)
            acc.act(planes, oh, ow)
            acc.conv(1, planes, planes * expansion, oh, ow)
            acc.bn(planes * expansion, oh, ow)
            if bi == 0:
                acc.conv(1, cin, planes * expansion, oh, ow)
                acc.bn(planes * expansion, oh, ow)
            acc.act(planes * expansion, oh, ow)
            cin = planes * expansion
            h, w = oh, ow
        if si in out_indices:
            outs.append((cin, h, w))
    return outs


def psp_head_complexity(acc: Acc, head_cfg: Dict[str, Any],
                        feat: Tuple[int, int, int]) -> None:
    cin, h, w = feat
    ch = head_cfg.get("channels", 512)
    scales = head_cfg.get("pool_scales", (1, 2, 3, 6))
    ncls = head_cfg.get("num_classes", 19)
    for s in scales:
        acc.pool(cin, h, w)
        acc.conv(1, cin, ch, s, s)
        acc.bn(ch, s, s)
        acc.act(ch, s, s)
    concat_c = cin + len(scales) * ch
    acc.conv(3, concat_c, ch, h, w)
    acc.bn(ch, h, w)
    acc.act(ch, h, w)
    acc.conv(1, ch, ncls, h, w, bias=True)


def fcn_head_complexity(acc: Acc, head_cfg: Dict[str, Any],
                        feat: Tuple[int, int, int]) -> None:
    cin, h, w = feat
    ch = head_cfg.get("channels", 256)
    k = head_cfg.get("kernel_size", 3)
    ncls = head_cfg.get("num_classes", 19)
    c = cin
    for _ in range(head_cfg.get("num_convs", 2)):
        acc.conv(k, c, ch, h, w)
        acc.bn(ch, h, w)
        acc.act(ch, h, w)
        c = ch
    if head_cfg.get("concat_input", True) and head_cfg.get("num_convs", 2):
        acc.conv(k, cin + ch, ch, h, w)
        acc.bn(ch, h, w)
        acc.act(ch, h, w)
    acc.conv(1, ch if head_cfg.get("num_convs", 2) else cin, ncls, h, w,
             bias=True)


def uper_head_complexity(acc: Acc, head_cfg: Dict[str, Any],
                         feats: Sequence[Tuple[int, int, int]]) -> None:
    ch = head_cfg.get("channels", 512)
    ncls = head_cfg.get("num_classes", 19)
    scales = head_cfg.get("pool_scales", (1, 2, 3, 6))
    cin, h, w = feats[-1]
    for s in scales:
        acc.pool(cin, h, w)
        acc.conv(1, cin, ch, s, s)
        acc.bn(ch, s, s)
        acc.act(ch, s, s)
    acc.conv(3, cin + len(scales) * ch, ch, h, w)
    acc.bn(ch, h, w)
    acc.act(ch, h, w)
    for (c, hh, ww) in feats[:-1]:
        acc.conv(1, c, ch, hh, ww)
        acc.bn(ch, hh, ww)
        acc.act(ch, hh, ww)
        acc.conv(3, ch, ch, hh, ww)
        acc.bn(ch, hh, ww)
        acc.act(ch, hh, ww)
    h0, w0 = feats[0][1], feats[0][2]
    acc.conv(3, ch * len(feats), ch, h0, w0)
    acc.bn(ch, h0, w0)
    acc.act(ch, h0, w0)
    acc.conv(1, ch, ncls, h0, w0, bias=True)


def convnext_complexity(acc: Acc, backbone_cfg: Dict[str, Any],
                        arch: Dict[str, Any], h: int, w: int
                        ) -> List[Tuple[int, int, int]]:
    widths = list(arch["body"]["width"])
    depths = list(arch["body"]["depth"])
    out_indices = list(backbone_cfg.get("out_indices", (0, 1, 2, 3)))
    h, w = _out_size(h, 4), _out_size(w, 4)
    acc.conv(4, 3, widths[0], h, w, bias=True)
    acc.ln(widths[0], h * w)
    outs = []
    for i in range(4):
        c = widths[i]
        for _ in range(depths[i]):
            acc.conv(7, 1, c, h, w, bias=True)   # depthwise: cin/groups = 1
            acc.ln(c, h * w)
            acc.linear(c, 4 * c, h * w)
            acc.act(4 * c, h, w)
            acc.linear(4 * c, c, h * w)
            acc.flops += c * h * w               # gamma scale
        if i in out_indices:
            acc.ln(c, h * w)
            outs.append((c, h, w))
        if i < 3:
            acc.ln(c, h * w)
            h, w = _out_size(h, 2), _out_size(w, 2)
            acc.conv(2, c, widths[i + 1], h, w, bias=True)
    return outs


def _attention_flops(acc: Acc, n: int, inner: int, embed: int,
                     ffn: int) -> None:
    acc.ln(embed, n)
    acc.linear(embed, inner, n)       # q
    acc.linear(embed, inner, n)       # k
    acc.linear(embed, inner, n)       # v
    acc.flops += 2.0 * n * n * inner  # qk^T + attn@v
    acc.linear(inner, embed, n)       # proj
    acc.ln(embed, n)
    acc.linear(embed, ffn, n)
    acc.act(ffn, n, 1)
    acc.linear(ffn, embed, n)


def elastic_transformer_complexity(acc: Acc, backbone_cfg: Dict[str, Any],
                                   arch: Dict[str, Any], h: int, w: int
                                   ) -> List[Tuple[int, int, int]]:
    embed = arch["embedding"]["width"]
    depth = arch["encoder"]["depth"]
    heads = list(arch["encoder"]["num_heads"])
    ffns = list(arch["encoder"]["ffn_channels"])
    p = backbone_cfg.get("patch_size", 16)
    out_indices = list(backbone_cfg.get("out_indices", ()))
    gh, gw = h // p, w // p
    n = gh * gw + (1 if backbone_cfg.get("with_cls_token", True) else 0)
    acc.conv(p, 3, embed, gh, gw, bias=True)
    for i in range(depth):
        _attention_flops(acc, n, heads[i] * 64, embed, ffns[i])
    return [(embed, gh, gw) for _ in (out_indices or [0])]


def convformer_complexity(acc: Acc, backbone_cfg: Dict[str, Any],
                          arch: Dict[str, Any], h: int, w: int
                          ) -> List[Tuple[int, int, int]]:
    stem = arch["stem"]["width"]
    body = arch["body"]
    depths = list(body["depth"])
    widths = list(body["block"]["convblock"]["width"])
    embed = body["block"]["embed_dim"]["width"]
    heads = list(body["block"]["transblock"]["MHA"]["num_heads"])
    ffcs = list(body["block"]["transblock"]["FFN"]["feedforward_channels"])
    p = backbone_cfg.get("patch_size", 16)
    h, w = _out_size(h, 2), _out_size(w, 2)
    acc.conv(7, 3, stem, h, w)
    acc.bn(stem, h, w)
    h, w = _out_size(h, 2), _out_size(w, 2)

    def conv_block(cin, wdt, hh, ww, stride=1, res=False):
        med = wdt // 4
        oh, ow = _out_size(hh, stride), _out_size(ww, stride)
        acc.conv(1, cin, med, hh, ww)
        acc.bn(med, hh, ww)
        acc.conv(3, med, med, oh, ow)
        acc.bn(med, oh, ow)
        acc.conv(1, med, wdt, oh, ow)
        acc.bn(wdt, oh, ow)
        if res:
            acc.conv(1, cin, wdt, oh, ow)
            acc.bn(wdt, oh, ow)
        return oh, ow

    dw = p // 4
    n_tok = (h // dw) * (w // dw) + 1
    # conv_trans_1
    conv_block(stem, widths[0], h, w, 1, True)
    acc.conv(dw, stem, embed, h // dw, w // dw, bias=True)
    _attention_flops(acc, n_tok, heads[0] * 64, embed,
                     ffcs[0] * embed // 10)

    cin = widths[0]
    for si in range(3):
        wdt = widths[si]
        med = wdt // 4
        for bi in range(depths[si]):
            stride = 2 if (bi == 0 and si > 0) else 1
            res = bi == 0 and si > 0
            h, w = conv_block(cin, wdt, h, w, stride, res)
            cin = wdt
            acc.conv(1, med, embed, n_tok - 1, 1, bias=True)  # squeeze
            _attention_flops(acc, n_tok, heads[si] * 64, embed,
                             ffcs[si] * embed // 10)
            acc.conv(1, embed, med, n_tok - 1, 1, bias=True)  # expand
            h2, w2 = conv_block(wdt, wdt, h, w, 1, False)     # fusion
    # last fusion (stride 2 in fusion block)
    conv_block(cin, widths[2], h, w, 1, False)
    h, w = _out_size(h, 2), _out_size(w, 2)
    return [(widths[0], h * 8, w * 8), (widths[1], h * 4, w * 4),
            (widths[2], h * 2, w * 2), (widths[2], h, w)]


def neck_complexity(acc: Acc, neck_cfg: Dict[str, Any],
                    feats: List[Tuple[int, int, int]]
                    ) -> List[Tuple[int, int, int]]:
    """DynamicMultiLevelNeck (reference dynamic_multilevel_neck.py:14-84)."""
    out_c = neck_cfg.get("out_channels", 512)
    scales = list(neck_cfg.get("scales", (0.5, 1, 2, 4)))
    laterals = []
    for (c, h, w) in feats:
        acc.conv(1, c, out_c, h, w, bias=True)
        laterals.append((out_c, h, w))
    if len(laterals) == 1:
        laterals = laterals * len(scales)
    outs = []
    for (c, h, w), s in zip(laterals, scales):
        oh, ow = int(h * s), int(w * s)
        acc.conv(3, out_c, out_c, oh, ow, bias=True)
        outs.append((out_c, oh, ow))
    return outs


_BACKBONE_FNS = {
    "DynamicResNet": resnet_complexity,
    "DynamicConvNeXt": convnext_complexity,
    "ElasticTransformer": elastic_transformer_complexity,
    "ElasticTransformer1": elastic_transformer_complexity,
    "ElasticConvformer": convformer_complexity,
}

_HEAD_FNS = {
    "DynamicPSPHead": psp_head_complexity, "PSPHead": psp_head_complexity,
    "DynamicFCNHead": fcn_head_complexity, "FCNHead": fcn_head_complexity,
}


def get_model_complexity_info(model_cfg: Dict[str, Any],
                              arch: Dict[str, Any],
                              input_shape: Sequence[int] = (3, 512, 2048),
                              only_backbone_flops: bool = False
                              ) -> Dict[str, float]:
    """Returns {'flops', 'params'} for the active subnet.

    ``arch`` is a nested arch dict (see arch_util.canonical_arch);
    ``input_shape`` is CHW like the reference (count_flops.py:139-140).
    """
    _, h, w = input_shape
    bb_cfg = dict(model_cfg["backbone"])
    bb_type = bb_cfg.get("type")
    acc = Acc()
    bb_fn = _BACKBONE_FNS.get(bb_type)
    if bb_fn is None:
        raise NotImplementedError(
            f"complexity for backbone {bb_type!r} not implemented yet")
    feats = bb_fn(acc, bb_cfg, arch["backbone"], h, w)
    if only_backbone_flops:
        return {"flops": acc.flops, "params": acc.params}
    if model_cfg.get("neck"):
        feats = neck_complexity(acc, dict(model_cfg["neck"]), feats)

    head_cfg = dict(model_cfg["decode_head"])
    head_fn = _HEAD_FNS.get(head_cfg.get("type"))
    if head_fn is None and head_cfg.get("type") in ("DynamicUPerHead",
                                                    "UPerHead"):
        uper_head_complexity(acc, head_cfg, feats)
    elif head_fn is not None:
        in_index = head_cfg.get("in_index", -1)
        head_fn(acc, head_cfg, feats[in_index])

    aux = model_cfg.get("auxiliary_head")
    aux_list = aux if isinstance(aux, (list, tuple)) else \
        ([aux] if aux else [])
    for a in aux_list:
        a = dict(a)
        fn = _HEAD_FNS.get(a.get("type"), fcn_head_complexity)
        fn(acc, a, feats[a.get("in_index", -1)])
    return {"flops": acc.flops, "params": acc.params}
