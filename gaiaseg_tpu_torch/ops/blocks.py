"""Composite sliced blocks: DynConvModule and DynBottleneck.

Port of ``gaiaseg_tpu/ops/blocks.py``. Submodule names follow the reference
mmseg ``state_dict`` (``conv``/``bn``; ``conv{1-3}``/``bn{1-3}``/
``downsample.{0,1}``, or ``downsample.{1,2}`` behind the avg_down pool).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dynamic_layers import DynBatchNorm, DynConv2d


class DynConvModule(nn.Module):
    """conv -> norm -> act, sliced to ``out_channels`` (default: MAX).

    ``norm`` is ``"bn"`` or None, ``act`` ``"relu"`` or None; the conv has
    a bias iff there is no norm, unless ``bias`` says otherwise (the JAX
    rule, ``gaiaseg_tpu/ops/blocks.py:40-51``). ``groups=in_channels`` makes
    the conv depthwise (``DynConv2d``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 norm: Optional[str] = "bn", act: Optional[str] = "relu",
                 bias: Optional[bool] = None, groups: int = 1):
        super().__init__()
        if norm not in ("bn", None) or act not in ("relu", None):
            raise NotImplementedError(
                f"DynConvModule norm={norm!r} act={act!r}: the port has "
                "norm 'bn' / None and act 'relu' / None")
        self.conv = DynConv2d(in_channels, out_channels, kernel_size, stride,
                              dilation, bias=norm is None if bias is None
                              else bias, groups=groups)
        self.bn = DynBatchNorm(out_channels) if norm == "bn" else None
        self.act = act

    def forward(self, x: torch.Tensor, out_channels: Optional[int] = None,
                in_tail: int = 0) -> torch.Tensor:
        y = self.conv(x, out_channels, in_tail)
        if self.bn is not None:
            y = self.bn(y)
        return F.relu(y) if self.act == "relu" else y


class DynBottleneck(nn.Module):
    """ResNet bottleneck (1x1 -> 3x3 -> 1x1, expansion 4), stride on the 3x3.

    ``width`` is the active mid width ("planes"); the output is ``4*width``
    channels. A block past the active depth is not called at all — the slice
    counterpart of the JAX ``where(active, out, identity)`` with frozen BN
    stats (``gaiaseg_tpu/ops/blocks.py:150-153``).
    """

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 avg_down: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = DynConv2d(inplanes, planes, 1)
        self.bn1 = DynBatchNorm(planes)
        self.conv2 = DynConv2d(planes, planes, 3, stride, dilation)
        self.bn2 = DynBatchNorm(planes)
        self.conv3 = DynConv2d(planes, out, 1)
        self.bn3 = DynBatchNorm(out)
        self.downsample = None
        if downsample and avg_down:
            pool = nn.AvgPool2d(stride, stride) if stride > 1 \
                else nn.Identity()
            self.downsample = nn.ModuleList([
                pool, DynConv2d(inplanes, out, 1), DynBatchNorm(out)])
        elif downsample:
            self.downsample = nn.ModuleList([
                DynConv2d(inplanes, out, 1, stride), DynBatchNorm(out)])

    def forward(self, x: torch.Tensor, width: int) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x, width)))
        y = F.relu(self.bn2(self.conv2(y, width)))
        y = self.bn3(self.conv3(y, width * self.expansion))
        identity = x
        if self.downsample is not None:
            *pool, conv, bn = self.downsample
            if pool:
                identity = pool[0](identity)
            identity = bn(conv(identity, width * self.expansion))
        return F.relu(y + identity)
