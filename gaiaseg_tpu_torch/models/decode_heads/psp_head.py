"""PSP decode head: pyramid pooling over the sliced supernet feature.

Port of ``gaiaseg_tpu/models/decode_heads/psp_head.py``: per scale an
adaptive average pool and a 1x1 conv module resized back and concatenated
with the input, a 3x3 bottleneck over ``in_channels + len(scales) *
channels``, then dropout and the 1x1 classifier. The input's width follows
the arch, so the bottleneck maps the static pool branches to the LAST
kernel rows (``in_tail``, ``psp_head.py:62-70``). The UPer head reuses the
pyramid (``pyramid_modules`` / ``pyramid_pool``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ...ops.blocks import DynConvModule
from ...ops.resize import resize_bilinear
from ...utils.registry import HEADS
from .base import BaseDecodeHead


def pyramid_modules(in_channels: int, channels: int,
                    pool_scales: Sequence[int]) -> nn.ModuleList:
    """Reference layout ``psp_modules.{i} = Sequential(pool, ConvModule)``."""
    return nn.ModuleList([
        nn.ModuleList([nn.AdaptiveAvgPool2d(int(s)),
                       DynConvModule(in_channels, channels, 1)])
        for s in pool_scales])


def pyramid_pool(modules: nn.ModuleList, x: torch.Tensor,
                 align_corners: bool) -> List[torch.Tensor]:
    """Each scale's pooled, projected branch resized back to ``x``."""
    return [resize_bilinear(conv(pool(x)), x.shape[2:], align_corners)
            for pool, conv in modules]


@HEADS.register_module(name=["DynamicPSPHead", "PSPHead"])
class DynamicPSPHead(BaseDecodeHead):
    def __init__(self, in_channels: int, channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), **kw):
        super().__init__(in_channels, channels, **kw)
        self.pool_scales = tuple(int(s) for s in pool_scales)
        self.psp_modules = pyramid_modules(self.in_channels, self.channels,
                                           self.pool_scales)
        self.bottleneck = DynConvModule(
            self.in_channels + len(self.pool_scales) * self.channels,
            self.channels, 3)

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._transform_inputs(inputs)
        outs = [x] + pyramid_pool(self.psp_modules, x, self.align_corners)
        feat = self.bottleneck(torch.cat(outs, dim=1),
                               in_tail=len(self.pool_scales) * self.channels)
        return self.cls_seg(feat, generator)
