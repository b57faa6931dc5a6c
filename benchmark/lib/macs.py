"""The frozen multiply-accumulate counter: conv, linear and attention MACs
a forward pass needs, worked out from the arch and the input shape alone.

It never counts from what ran, so a change that drops work cannot raise a
utilisation read against it. Norms, activations, pools, resizes and the
loss are not counted. Attention counts ``2 * N^2 * 64`` a head (``QK^T``
and ``PV``). ``heads`` picks the decode head alone (inference) or the
decode and auxiliary heads (training). A training step is three forward
passes' worth: ``6 * MACs`` operations; a forward pass ``2 * MACs``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

HEAD_DIM = 64


def _out(size: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _conv(hw: Tuple[int, int], cin: int, cout: int, k: int) -> int:
    return hw[0] * hw[1] * cin * cout * k * k


def resnet_features(bb: Dict[str, Any], arch: Dict[str, Any],
                    hw: Tuple[int, int]):
    """(MACs, [(channels, (h, w)) of each stage]) of ``DynamicResNet``
    (7x7 stem; bottlenecks of expansion 4, the stride on the 3x3)."""
    strides = bb.get("strides", (1, 2, 2, 2))
    sw = int(arch["stem"]["width"])
    h, w = _out(hw[0], 7, 2, 3), _out(hw[1], 7, 2, 3)
    macs = _conv((h, w), 3, sw, 7)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, feats = sw, []
    for i, (width, depth) in enumerate(zip(arch["body"]["width"],
                                           arch["body"]["depth"])):
        width, s = int(width), int(strides[i])
        ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
        for b in range(int(depth)):
            first = b == 0
            macs += _conv((h, w) if first else (ho, wo), cin, width, 1)
            macs += _conv((ho, wo), width, width, 3)
            macs += _conv((ho, wo), width, 4 * width, 1)
            if first:
                macs += _conv((ho, wo), cin, 4 * width, 1)
            cin = 4 * width
        h, w = ho, wo
        feats.append((cin, (h, w)))
    return macs, feats


def vit_features(bb: Dict[str, Any], arch: Dict[str, Any],
                 hw: Tuple[int, int]):
    """(MACs, [(channels, (h, w)) at ``out_indices``]) of
    ``ElasticTransformer``: a patch conv, then pre-norm layers (qkv, the
    attention of the active heads, proj, a two-layer FFN)."""
    p = int(bb.get("patch_size", 16))
    emb = int(arch["embedding"]["width"])
    enc = arch["encoder"]
    gh, gw = hw[0] // p, hw[1] // p
    n = gh * gw + (1 if bb.get("with_cls_token", True) else 0)
    macs = _conv((gh, gw), 3, emb, p)
    for i in range(int(enc["depth"])):
        inner = int(enc["num_heads"][i]) * HEAD_DIM
        f = int(enc["ffn_channels"][i])
        macs += n * emb * 3 * inner + 2 * n * n * inner + n * inner * emb
        macs += 2 * n * emb * f
    outs = [(emb, (gh, gw)) for _ in bb.get("out_indices", (2, 5, 8, 11))]
    return macs, outs


def mln_neck(neck: Dict[str, Any], feats):
    out = int(neck.get("out_channels", 512))
    macs, levels = 0, []
    scales = neck.get("scales", (0.5, 1, 2, 4))
    for (c, hw), s in zip(feats, scales):
        macs += _conv(hw, c, out, 1)
        o = (int(hw[0] * s), int(hw[1] * s))
        macs += _conv(o, out, out, 3)
        levels.append((out, o))
    return macs, levels


def _pyramid(c: int, hw, ch: int, scales: Sequence[int], classes: int):
    macs = sum(s * s * c * ch for s in scales)
    return macs + _conv(hw, c + len(scales) * ch, ch, 3)


def decode_head(head: Dict[str, Any], feats) -> int:
    ch, classes = int(head["channels"]), int(head["num_classes"])
    scales = head.get("pool_scales", (1, 2, 3, 6))
    kind = head["type"]
    if kind in ("DynamicPSPHead", "PSPHead"):
        c, hw = feats[head.get("in_index", -1)]
        return _pyramid(c, hw, ch, scales, classes) + _conv(hw, ch, classes,
                                                            1)
    if kind in ("DynamicUPerHead", "UPerHead"):
        levels = [feats[i] for i in head.get("in_index", (0, 1, 2, 3))]
        c_top, hw_top = levels[-1]
        macs = _pyramid(c_top, hw_top, ch, scales, classes)
        for c, hw in levels[:-1]:
            macs += _conv(hw, c, ch, 1) + _conv(hw, ch, ch, 3)
        fine = levels[0][1]
        macs += _conv(fine, len(levels) * ch, ch, 3)
        return macs + _conv(fine, ch, classes, 1)
    if kind in ("DynamicFCNHead", "FCNHead"):
        c, hw = feats[head.get("in_index", -1)]
        k = int(head.get("kernel_size", 3))
        macs = 0
        for i in range(int(head.get("num_convs", 2))):
            macs += _conv(hw, c if i == 0 else ch, ch, k)
        if head.get("concat_input", True):
            macs += _conv(hw, c + ch, ch, k)
        return macs + _conv(hw, ch, classes, 1)
    raise ValueError(f"no MAC count for head {kind!r}")


def model_macs(model_cfg: Dict[str, Any], arch: Dict[str, Any],
               hw: Tuple[int, int], train: bool) -> int:
    """MACs of one image of ``hw`` through the segmentor at ``arch`` (the
    auxiliary head too when ``train``)."""
    bb = model_cfg["backbone"]
    if bb["type"] == "DynamicResNet":
        macs, feats = resnet_features(bb, arch["backbone"], hw)
    elif bb["type"] in ("ElasticTransformer", "ElasticTransformer1"):
        macs, feats = vit_features(bb, arch["backbone"], hw)
    else:
        raise ValueError(f"no MAC count for backbone {bb['type']!r}")
    if model_cfg.get("neck"):
        neck_macs, feats = mln_neck(model_cfg["neck"], feats)
        macs += neck_macs
    macs += decode_head(model_cfg["decode_head"], feats)
    aux = model_cfg.get("auxiliary_head")
    if train and aux:
        for head in (aux if isinstance(aux, (list, tuple)) else [aux]):
            macs += decode_head(head, feats)
    return macs
