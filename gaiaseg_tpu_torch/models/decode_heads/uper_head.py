"""UPerNet decode head for the ViT supernet.

Port of ``gaiaseg_tpu/models/decode_heads/uper_head.py``: the PSP pyramid
on the deepest level and a 3x3 bottleneck over it, 1x1 laterals on the
other levels, the top-down bilinear add, a 3x3 FPN conv per level, every
level resized to the finest and concatenated, a 3x3 ``fpn_bottleneck``,
dropout and the classifier. Reads ``input_transform='multiple_select'``.
Names follow mmseg (``psp_modules.{i}.1``, ``bottleneck``,
``lateral_convs.{i}``, ``fpn_convs.{i}``, ``fpn_bottleneck``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.blocks import DynConvModule
from ...ops.resize import resize_bilinear
from ...utils.registry import HEADS
from .base import BaseDecodeHead
from .psp_head import pyramid_modules, pyramid_pool


@HEADS.register_module(name=["DynamicUPerHead", "UPerHead"])
class DynamicUPerHead(BaseDecodeHead):
    def __init__(self, in_channels: Sequence[int], channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), **kw):
        kw.setdefault("in_index", (0, 1, 2, 3))
        kw.setdefault("input_transform", "multiple_select")
        super().__init__(in_channels, channels, **kw)
        ins, ch = self.in_channels, self.channels
        self.pool_scales = tuple(int(s) for s in pool_scales)
        self.psp_modules = pyramid_modules(ins[-1], ch, self.pool_scales)
        self.bottleneck = DynConvModule(
            ins[-1] + len(self.pool_scales) * ch, ch, 3)
        self.lateral_convs = nn.ModuleList([DynConvModule(c, ch, 1)
                                            for c in ins[:-1]])
        self.fpn_convs = nn.ModuleList([DynConvModule(ch, ch, 3)
                                        for _ in ins[:-1]])
        self.fpn_bottleneck = DynConvModule(len(ins) * ch, ch, 3)

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self._transform_inputs(inputs)
        top = feats[-1]
        psp = self.bottleneck(
            torch.cat([top] + pyramid_pool(self.psp_modules, top,
                                           self.align_corners), dim=1),
            in_tail=len(self.pool_scales) * self.channels)
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        laterals.append(psp)
        for i in range(len(laterals) - 1, 0, -1):     # top-down add
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[2:], self.align_corners)
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        outs = [resize_bilinear(o, outs[0].shape[2:], self.align_corners)
                for o in outs]
        return self.cls_seg(self.fpn_bottleneck(torch.cat(outs, dim=1)),
                            generator)
