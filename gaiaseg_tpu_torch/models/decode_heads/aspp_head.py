"""ASPP and DeepLabV3+ decode heads.

Port of ``gaiaseg_tpu/models/decode_heads/aspp_head.py``. ``ASPPHead``: a
global-pool branch (mean, 1x1 conv module, resized back) and one branch a
dilation (1x1 at dilation 1, else a dilated 3x3, or a depthwise-separable
3x3 with ``separable``), concatenated, a 3x3 ``bottleneck``, dropout and
the classifier. ``DepthwiseSeparableASPPHead`` (DeepLabV3+): the separable
ASPP on ``inputs[in_index]``, then a 1x1 projection of the low-level
feature ``inputs[c1_in_index]`` to ``c1_channels``, the ASPP output resized
to it and concatenated before it, and two separable 3x3 modules.

Names follow mmseg: ``image_pool.1.{conv,bn}``, ``aspp_modules.{i}``
(``.{conv,bn}``, or ``.depthwise_conv.{conv,bn}`` and
``.pointwise_conv.{conv,bn}``), ``bottleneck``, ``c1_bottleneck``,
``sep_bottleneck.{0,1}``, ``conv_seg``.

Only the backbone is elastic, so only the convs that read a backbone
feature take a narrower input: the image pool, every ASPP branch and
``c1_bottleneck``, each a prefix of its rows (the depthwise conv and its
BN a prefix of their channels). Every concat inside the head is of static
widths.

The depthwise BN slices with its input: at a subnet its inactive channels
take no part. The JAX module runs it unmasked at MAX width, where those
channels are zeros in and ``relu(bias - mean * scale / sqrt(var + eps))``
out, which the pointwise conv reads (ROADMAP C9). The two agree when those
channels hold bias 0 and running statistics (0, 1), as at init; the
extracted subnet computes what the port does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.blocks import DynConvModule
from ...ops.resize import resize_bilinear
from ...utils.registry import HEADS
from .base import BaseDecodeHead


class SepConvModule(nn.Module):
    """mmcv's ``DepthwiseSeparableConvModule``: a depthwise 3x3 conv module
    (BN, ReLU) then a pointwise 1x1 conv module (BN, ReLU); JAX
    ``SepConvModule`` (``dw``, ``dw_bn``, ``pw``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dilation: int = 1):
        super().__init__()
        self.depthwise_conv = DynConvModule(in_channels, in_channels, 3,
                                            dilation=dilation,
                                            groups=in_channels)
        self.pointwise_conv = DynConvModule(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_conv(self.depthwise_conv(x))


def aspp_modules(in_channels: int, channels: int, dilations: Sequence[int],
                 separable: bool) -> nn.ModuleList:
    """One branch a dilation (JAX ``ASPPModule``)."""
    mods = []
    for d in dilations:
        if d == 1:
            mods.append(DynConvModule(in_channels, channels, 1))
        elif separable:
            mods.append(SepConvModule(in_channels, channels, d))
        else:
            mods.append(DynConvModule(in_channels, channels, 3, dilation=d))
    return nn.ModuleList(mods)


class _ASPP(BaseDecodeHead):
    """The pool branch, the ASPP branches and the bottleneck over their
    concat, shared by both heads."""

    def __init__(self, in_channels: int, channels: int,
                 dilations: Sequence[int], separable: bool, **kw):
        super().__init__(in_channels, channels, **kw)
        self.dilations = tuple(int(d) for d in dilations)
        self.image_pool = nn.ModuleList([
            nn.AdaptiveAvgPool2d(1),
            DynConvModule(self.in_channels, self.channels, 1)])
        self.aspp_modules = aspp_modules(self.in_channels, self.channels,
                                         self.dilations, separable)
        self.bottleneck = DynConvModule(
            (len(self.dilations) + 1) * self.channels, self.channels, 3)

    def aspp(self, x: torch.Tensor) -> torch.Tensor:
        pool, conv = self.image_pool
        # bilinear from one pixel is a broadcast; F.interpolate's backward
        # would add every output pixel into that one by atomics
        outs = [conv(pool(x)).expand(-1, -1, *x.shape[2:])]
        outs += [m(x) for m in self.aspp_modules]
        return self.bottleneck(torch.cat(outs, dim=1))


@HEADS.register_module(name=["DynamicASPPHead", "ASPPHead"])
class DynamicASPPHead(_ASPP):
    def __init__(self, in_channels: int, channels: int = 512,
                 dilations: Sequence[int] = (1, 12, 24, 36),
                 separable: bool = False, **kw):
        super().__init__(in_channels, channels, dilations, separable, **kw)

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cls_seg(self.aspp(self._transform_inputs(inputs)),
                            generator)


@HEADS.register_module(name=["DepthwiseSeparableASPPHead",
                             "DynamicSepASPPHead"])
class DepthwiseSeparableASPPHead(_ASPP):
    """DeepLabV3+. ``c1_in_channels`` is the MAX width of
    ``inputs[c1_in_index]`` (``build_head`` fills it in)."""

    def __init__(self, in_channels: int, c1_in_channels: int,
                 channels: int = 512,
                 dilations: Sequence[int] = (1, 12, 24, 36),
                 c1_in_index: int = 0, c1_channels: int = 48, **kw):
        super().__init__(in_channels, channels, dilations, True, **kw)
        self.c1_in_index = int(c1_in_index)
        self.c1_bottleneck = DynConvModule(int(c1_in_channels),
                                           int(c1_channels), 1)
        self.sep_bottleneck = nn.ModuleList([
            SepConvModule(self.channels + int(c1_channels), self.channels),
            SepConvModule(self.channels, self.channels)])

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self.aspp(self._transform_inputs(inputs))
        c1 = self.c1_bottleneck(inputs[self.c1_in_index])
        feat = torch.cat([resize_bilinear(feat, c1.shape[2:],
                                          self.align_corners), c1], dim=1)
        for m in self.sep_bottleneck:
            feat = m(feat)
        return self.cls_seg(feat, generator)
