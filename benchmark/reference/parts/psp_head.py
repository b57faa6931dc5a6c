"""The PSP head: a pyramid of pooled 1x1 conv-BN-ReLU branches over one
level, resized back and concatenated after it, a 3x3 bottleneck, then the
classifier. The bottleneck's input is ``[elastic features, static pool
branches]``: the branches take the LAST rows of its kernel. The UPer head
tops its levels with the same pyramid."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

from ...lib.macs import _conv
from ..nets import Specs, cls_seg, conv_bn_relu, resize

TYPES = ("DynamicPSPHead", "PSPHead")
ROLE = "head"


def pyramid_specs(S: Specs, name: str, c: int, ch: int,
                  scales: Sequence[int]) -> None:
    for j in range(len(scales)):
        S.cbr(f"{name}.psp_modules.{j}.1", c, ch, 1)
    S.cbr(f"{name}.bottleneck", c + len(scales) * ch, ch, 3)


def specs(head: Dict[str, Any], chans: List[int], S: Specs,
          name: str) -> None:
    c = chans[head.get("in_index", -1)]
    pyramid_specs(S, name, c, int(head["channels"]),
                  head.get("pool_scales", (1, 2, 3, 6)))
    S.cls_seg(name, head)


def pyramid(nm, P, name, x, scales, train, stats):
    outs = [x]
    for j, s in enumerate(scales):
        y = F.adaptive_avg_pool2d(x, int(s))
        y = conv_bn_relu(nm, P, f"{name}.psp_modules.{j}.1", y, train, stats)
        outs.append(resize(y, x.shape[2:]))
    return conv_bn_relu(nm, P, f"{name}.bottleneck", torch.cat(outs, 1),
                        train, stats, in_tail=(len(outs) - 1) *
                        P[f"{name}.bottleneck.conv.weight"].shape[0])


def forward(nm, P, feats, head, train, stats, gen, name="decode_head"):
    x = feats[head.get("in_index", -1)]
    feat = pyramid(nm, P, name, x, head.get("pool_scales", (1, 2, 3, 6)),
                   train, stats)
    return cls_seg(nm, P, name, feat, head, train, gen)


def pyramid_macs(c: int, hw, ch: int, scales: Sequence[int]) -> int:
    total = sum(s * s * c * ch for s in scales)
    return total + _conv(hw, c + len(scales) * ch, ch, 3)


def macs(head: Dict[str, Any], feats) -> int:
    ch, classes = int(head["channels"]), int(head["num_classes"])
    c, hw = feats[head.get("in_index", -1)]
    return pyramid_macs(c, hw, ch, head.get("pool_scales", (1, 2, 3, 6))) \
        + _conv(hw, ch, classes, 1)
