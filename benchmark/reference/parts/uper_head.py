"""The UPer head: the PSP pyramid over the top level, 1x1 laterals over the
others, a top-down sum, 3x3 FPN convs, every level resized to the finest
and concatenated, a 3x3 bottleneck, then the classifier."""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ...lib.macs import _conv
from ..nets import Specs, cls_seg, conv_bn_relu, resize
from .psp_head import pyramid, pyramid_macs, pyramid_specs

TYPES = ("DynamicUPerHead", "UPerHead")
ROLE = "head"


def specs(head: Dict[str, Any], chans: List[int], S: Specs,
          name: str) -> None:
    ch = int(head["channels"])
    ins = [chans[i] for i in head.get("in_index", (0, 1, 2, 3))]
    pyramid_specs(S, name, ins[-1], ch, head.get("pool_scales", (1, 2, 3, 6)))
    for i, c in enumerate(ins[:-1]):
        S.cbr(f"{name}.lateral_convs.{i}", c, ch, 1)
        S.cbr(f"{name}.fpn_convs.{i}", ch, ch, 3)
    S.cbr(f"{name}.fpn_bottleneck", len(ins) * ch, ch, 3)
    S.cls_seg(name, head)


def forward(nm, P, feats, head, train, stats, gen, name="decode_head"):
    levels = [feats[i] for i in head.get("in_index", (0, 1, 2, 3))]
    psp = pyramid(nm, P, name, levels[-1],
                  head.get("pool_scales", (1, 2, 3, 6)), train, stats)
    lats = [conv_bn_relu(nm, P, f"{name}.lateral_convs.{i}", f, train, stats)
            for i, f in enumerate(levels[:-1])] + [psp]
    for i in range(len(lats) - 1, 0, -1):
        lats[i - 1] = lats[i - 1] + resize(lats[i], lats[i - 1].shape[2:])
    outs = [conv_bn_relu(nm, P, f"{name}.fpn_convs.{i}", lat, train, stats)
            for i, lat in enumerate(lats[:-1])] + [lats[-1]]
    outs = [resize(o, outs[0].shape[2:]) for o in outs]
    feat = conv_bn_relu(nm, P, f"{name}.fpn_bottleneck", torch.cat(outs, 1),
                        train, stats)
    return cls_seg(nm, P, name, feat, head, train, gen)


def macs(head: Dict[str, Any], feats) -> int:
    ch, classes = int(head["channels"]), int(head["num_classes"])
    levels = [feats[i] for i in head.get("in_index", (0, 1, 2, 3))]
    c_top, hw_top = levels[-1]
    total = pyramid_macs(c_top, hw_top, ch,
                         head.get("pool_scales", (1, 2, 3, 6)))
    for c, hw in levels[:-1]:
        total += _conv(hw, c, ch, 1) + _conv(hw, ch, ch, 3)
    fine = levels[0][1]
    total += _conv(fine, len(levels) * ch, ch, 3)
    return total + _conv(fine, ch, classes, 1)
