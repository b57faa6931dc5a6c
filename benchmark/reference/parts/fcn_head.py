"""The FCN head: ``num_convs`` conv-BN-ReLU layers over one level, then the
classifier. The reference has no ``concat_input`` conv; the MAC count
does."""
from __future__ import annotations

from typing import Any, Dict, List

from ...lib.macs import _conv
from ..nets import Specs, cls_seg, conv_bn_relu

TYPES = ("DynamicFCNHead", "FCNHead")
ROLE = "head"


def specs(head: Dict[str, Any], chans: List[int], S: Specs,
          name: str) -> None:
    ch = int(head["channels"])
    c = chans[head.get("in_index", -1)]
    for i in range(int(head.get("num_convs", 2))):
        S.cbr(f"{name}.convs.{i}", c if i == 0 else ch, ch,
              int(head.get("kernel_size", 3)))
    if head.get("concat_input", True):
        raise ValueError("the reference has no FCN conv_cat")
    S.cls_seg(name, head)


def forward(nm, P, feats, head, train, stats, gen, name="auxiliary_head"):
    x = feats[head.get("in_index", -1)]
    for i in range(int(head.get("num_convs", 2))):
        x = conv_bn_relu(nm, P, f"{name}.convs.{i}", x, train, stats)
    return cls_seg(nm, P, name, x, head, train, gen)


def macs(head: Dict[str, Any], feats) -> int:
    ch, classes = int(head["channels"]), int(head["num_classes"])
    c, hw = feats[head.get("in_index", -1)]
    k = int(head.get("kernel_size", 3))
    total = 0
    for i in range(int(head.get("num_convs", 2))):
        total += _conv(hw, c if i == 0 else ch, ch, k)
    if head.get("concat_input", True):
        total += _conv(hw, c + ch, ch, k)
    return total + _conv(hw, ch, classes, 1)
