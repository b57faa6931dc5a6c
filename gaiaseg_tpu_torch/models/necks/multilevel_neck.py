"""Multi-level neck: the ViT's single-scale maps -> a 4-level pyramid.

Port of ``gaiaseg_tpu/models/necks/multilevel_neck.py``: per input a 1x1
lateral conv with bias (no norm, no activation) that takes the active embed
width and gives all ``out_channels``, then per scale a bilinear resize to
``(int(h * s), int(w * s))`` and a 3x3 conv with bias. State-dict names
follow mmseg (``lateral_convs.{i}.conv``, ``convs.{i}.conv``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ...ops.blocks import DynConvModule
from ...ops.resize import resize_bilinear
from ...utils.registry import NECKS


@NECKS.register_module(name=["DynamicMultiLevelNeck", "MultiLevelNeck"])
class DynamicMultiLevelNeck(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 512,
                 scales: Sequence[float] = (0.5, 1, 2, 4)):
        super().__init__()
        self.out_ch = int(out_channels)
        self.scales = tuple(float(s) for s in scales)
        self.lateral_convs = nn.ModuleList([
            DynConvModule(int(c), self.out_ch, 1, norm=None, act=None)
            for c in in_channels])
        self.convs = nn.ModuleList([
            DynConvModule(self.out_ch, self.out_ch, 3, norm=None, act=None)
            for _ in self.scales])

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.out_ch for _ in self.scales)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        if len(laterals) == 1:
            laterals = laterals * len(self.scales)
        outs = []
        for lat, scale, conv in zip(laterals, self.scales, self.convs):
            h, w = lat.shape[2:]
            outs.append(conv(resize_bilinear(lat, (int(h * scale),
                                                   int(w * scale)))))
        return outs
