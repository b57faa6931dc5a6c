"""SegFormer's MLP decode head (pairs with ElasticMixViT).

Port of ``gaiaseg_tpu/models/decode_heads/segformer_head.py``: each input
level goes through its linear projection ``mlp{i}`` to ``channels`` (a
subnet's narrower level takes the first columns of the weight), is resized
bilinearly to the first (finest) level's size, and the projections are
concatenated finest first (mlp0, mlp1, mlp2, mlp3); then the 1x1 ``fuse``
conv + BN + ReLU, dropout and the classifier. Reads
``input_transform='multiple_select'``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.blocks import DynConvModule
from ...ops.dynamic_layers import DynLinear
from ...ops.resize import resize_bilinear
from ...utils.registry import HEADS
from .base import BaseDecodeHead


@HEADS.register_module(name=["SegFormerHead", "SegformerHead"])
class SegFormerHead(BaseDecodeHead):
    def __init__(self, in_channels: Sequence[int], channels: int = 256,
                 **kw):
        kw.setdefault("in_index", (0, 1, 2, 3))
        kw.setdefault("input_transform", "multiple_select")
        super().__init__(in_channels, channels, **kw)
        for i, c in enumerate(self.in_channels):
            self.add_module(f"mlp{i}", DynLinear(c, self.channels))
        self.fuse = DynConvModule(len(self.in_channels) * self.channels,
                                  self.channels, 1)

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self._transform_inputs(inputs)
        target = feats[0].shape[2:]
        proj = []
        for i, f in enumerate(feats):
            y = getattr(self, f"mlp{i}")(f.permute(0, 2, 3, 1))
            proj.append(resize_bilinear(y.permute(0, 3, 1, 2), target,
                                        self.align_corners))
        return self.cls_seg(self.fuse(torch.cat(proj, dim=1)), generator)
