"""DynamicResNet: a 7x7 stem and bottlenecks of expansion 4, the stride on
the 3x3, sliced to the arch's stem width and each stage's width and depth.

``Numerics(fault="branch_wgrad")`` plants its fault here: each
bottleneck's 3x3 conv takes its weight gradient from the first half of the
batch only (forward and input gradient whole).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ...lib.macs import _conv, _out
from ..nets import Specs, batch_norm, conv

TYPES = ("DynamicResNet",)
ROLE = "backbone"


def max_arch(bb: Dict[str, Any]) -> Dict[str, Any]:
    return {"stem": {"width": int(bb.get("stem_width", 64))},
            "body": {"width": list(bb.get("body_width", (80, 160, 320, 640))),
                     "depth": list(bb.get("body_depth", (4, 6, 29, 4)))}}


def specs(bb: Dict[str, Any], S: Specs) -> List[int]:
    sw = int(bb.get("stem_width", 64))
    S.conv("backbone.conv1", 3, sw, 7)
    S.bn("backbone.bn1", sw)
    cin, chans = sw, []
    for i, (w, d) in enumerate(zip(bb["body_width"], bb["body_depth"])):
        for blk in range(d):
            pre = f"backbone.layer{i + 1}.{blk}."
            S.conv(pre + "conv1", cin, w, 1)
            S.bn(pre + "bn1", w)
            S.conv(pre + "conv2", w, w, 3)
            S.bn(pre + "bn2", w)
            S.conv(pre + "conv3", w, 4 * w, 1)
            S.bn(pre + "bn3", 4 * w)
            if blk == 0:
                S.conv(pre + "downsample.0", cin, 4 * w, 1)
                S.bn(pre + "downsample.1", 4 * w)
            cin = 4 * w
        chans.append(cin)
    return chans


def forward(nm, P, x, arch, cfg, train, stats=None) -> List[torch.Tensor]:
    strides = cfg.get("strides", (1, 2, 2, 2))
    x = conv(nm, P, "backbone.conv1", x, int(arch["stem"]["width"]), 2)
    x = F.relu(batch_norm(P, "backbone.bn1", x, train, stats))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = []
    for i, (w, d) in enumerate(zip(arch["body"]["width"],
                                   arch["body"]["depth"])):
        w = int(w)
        for blk in range(int(d)):
            pre = f"backbone.layer{i + 1}.{blk}."
            s = int(strides[i]) if blk == 0 else 1
            y = F.relu(batch_norm(P, pre + "bn1", conv(
                nm, P, pre + "conv1", x, w), train, stats))
            y = F.relu(batch_norm(P, pre + "bn2", conv(
                nm, P, pre + "conv2", y, w, s,
                half_wgrad=nm.fault == "branch_wgrad"), train, stats))
            y = batch_norm(P, pre + "bn3", conv(nm, P, pre + "conv3", y,
                                                4 * w), train, stats)
            if blk == 0:
                x = batch_norm(P, pre + "downsample.1", conv(
                    nm, P, pre + "downsample.0", x, 4 * w, s, padding=0),
                    train, stats)
            x = F.relu(y + x)
        feats.append(x)
    return feats


def macs(bb: Dict[str, Any], arch: Dict[str, Any], hw):
    """(MACs, [(channels, (h, w)) of each stage])."""
    strides = bb.get("strides", (1, 2, 2, 2))
    sw = int(arch["stem"]["width"])
    h, w = _out(hw[0], 7, 2, 3), _out(hw[1], 7, 2, 3)
    total = _conv((h, w), 3, sw, 7)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, feats = sw, []
    for i, (width, depth) in enumerate(zip(arch["body"]["width"],
                                           arch["body"]["depth"])):
        width, s = int(width), int(strides[i])
        ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
        for b in range(int(depth)):
            first = b == 0
            total += _conv((h, w) if first else (ho, wo), cin, width, 1)
            total += _conv((ho, wo), width, width, 3)
            total += _conv((ho, wo), width, 4 * width, 1)
            if first:
                total += _conv((ho, wo), cin, 4 * width, 1)
            cin = 4 * width
        h, w = ho, wo
        feats.append((cin, (h, w)))
    return total, feats
