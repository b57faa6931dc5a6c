"""FCN decode head (the auxiliary head of the flagship supernet config).

Port of ``gaiaseg_tpu/models/decode_heads/fcn_head.py``: ``num_convs`` 3x3
conv modules, dropout and the 1x1 classifier. The first conv takes the
active input rows only. ``concat_input=True`` adds ``conv_cat``, a conv
module over ``[x, convs(x)]``: the rows of the elastic ``x`` come first
and the static tail of ``channels`` rows last (``in_tail``, JAX
``fcn_head.py:43-51``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.blocks import DynConvModule
from ...utils.registry import HEADS
from .base import BaseDecodeHead


@HEADS.register_module(name=["DynamicFCNHead", "FCNHead"])
class DynamicFCNHead(BaseDecodeHead):
    def __init__(self, in_channels: int, channels: int = 256,
                 num_convs: int = 2, kernel_size: int = 3,
                 concat_input: bool = True, dilation: int = 1, **kw):
        super().__init__(in_channels, channels, **kw)
        self.convs = nn.ModuleList([
            DynConvModule(self.in_channels if i == 0 else self.channels,
                          self.channels, kernel_size, dilation=dilation)
            for i in range(int(num_convs))])
        self.conv_cat = DynConvModule(self.in_channels + self.channels,
                                      self.channels, kernel_size) \
            if concat_input else None

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = feat = self._transform_inputs(inputs)
        for conv in self.convs:
            feat = conv(feat)
        if self.conv_cat is not None:
            feat = self.conv_cat(torch.cat([x, feat], dim=1),
                                 in_tail=self.channels)
        return self.cls_seg(feat, generator)
