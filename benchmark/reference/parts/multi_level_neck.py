"""The multi-level neck (MLN): each level a 1x1 lateral conv, a bilinear
resize by its scale, then a 3x3 conv, both with a bias and no norm."""
from __future__ import annotations

from typing import Any, Dict, List

from ...lib.macs import _conv
from ..nets import Specs, conv, resize

TYPES = ("DynamicMultiLevelNeck",)
ROLE = "neck"


def specs(neck: Dict[str, Any], chans: List[int], S: Specs) -> List[int]:
    oc = int(neck["out_channels"])
    for i, c in enumerate(chans):
        S.conv(f"neck.lateral_convs.{i}.conv", c, oc, 1, True)
    for i in range(len(neck.get("scales", (0.5, 1, 2, 4)))):
        S.conv(f"neck.convs.{i}.conv", oc, oc, 3, True)
    return [oc] * len(neck.get("scales", (0.5, 1, 2, 4)))


def forward(nm, P, feats, neck, train, stats=None):
    outs = []
    scales = neck.get("scales", (0.5, 1, 2, 4))
    for i, (x, s) in enumerate(zip(feats, scales)):
        lat = conv(nm, P, f"neck.lateral_convs.{i}.conv", x)
        h, w = lat.shape[2:]
        outs.append(conv(nm, P, f"neck.convs.{i}.conv",
                         resize(lat, (int(h * s), int(w * s)))))
    return outs


def macs(neck: Dict[str, Any], feats):
    out = int(neck.get("out_channels", 512))
    total, levels = 0, []
    scales = neck.get("scales", (0.5, 1, 2, 4))
    for (c, hw), s in zip(feats, scales):
        total += _conv(hw, c, out, 1)
        o = (int(hw[0] * s), int(hw[1] * s))
        total += _conv(o, out, out, 3)
        levels.append((out, o))
    return total, levels
