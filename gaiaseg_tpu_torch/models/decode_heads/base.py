"""Decode-head base: input selection, dropout and the 1x1 classifier.

Port of ``gaiaseg_tpu/models/decode_heads/base.py``: an int ``in_index``
picks one input; ``input_transform='multiple_select'`` with a list
``in_index`` picks several (``in_channels`` is then a list);
``'resize_concat'`` resizes them to the first one's size and concatenates
them (``in_channels`` is then their sum, as mmseg's, and
``in_channels_list`` the list). The loss lives in the segmentor, so heads
are pure feature -> logit functions.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dropout import dropout
from ...ops.dynamic_layers import DynConv2d
from ...ops.resize import resize_bilinear


class BaseDecodeHead(nn.Module):
    def __init__(self, in_channels: Union[int, Sequence[int]], channels: int,
                 num_classes: int = 19,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 dropout_ratio: float = 0.1, align_corners: bool = False,
                 ignore_index: int = 255):
        super().__init__()
        if input_transform not in (None, "multiple_select",
                                   "resize_concat"):
            raise ValueError(f"input_transform={input_transform!r}")
        if (input_transform is None) != isinstance(in_index, int):
            raise ValueError("in_index is a list exactly when "
                             "input_transform is set")
        self.input_transform = input_transform
        self.in_channels = [int(c) for c in in_channels] \
            if input_transform else int(in_channels)
        if input_transform == "resize_concat":
            self.in_channels_list = self.in_channels
            self.in_channels = sum(self.in_channels)
        self.channels = int(channels)
        self.num_classes = int(num_classes)
        self.in_index = in_index
        self.dropout_ratio = float(dropout_ratio)
        self.align_corners = bool(align_corners)
        self.ignore_index = ignore_index
        self.conv_seg = DynConv2d(self.channels, self.num_classes, 1,
                                  bias=True)

    def _transform_inputs(self, inputs):
        if self.input_transform == "resize_concat":
            # JAX base.py:45-62: a feature narrower than its declared
            # width (a subnet's) is padded with zeros to it, so the concat
            # keeps the MAX layout the next conv's rows follow
            feats = [inputs[i] for i in self.in_index]
            size = feats[0].shape[2:]
            feats = [F.pad(resize_bilinear(f, size, self.align_corners),
                           (0, 0, 0, 0, 0, c - f.shape[1]))
                     for f, c in zip(feats, self.in_channels_list)]
            return torch.cat(feats, dim=1)
        if self.input_transform == "multiple_select":
            return [inputs[i] for i in self.in_index]
        if isinstance(inputs, (list, tuple)):
            return inputs[self.in_index]
        return inputs

    def cls_seg(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training and self.dropout_ratio > 0:
            feat = dropout(feat, self.dropout_ratio, generator)
        return self.conv_seg(feat)
