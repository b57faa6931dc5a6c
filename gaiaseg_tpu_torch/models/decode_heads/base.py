"""Decode-head base: input selection, dropout and the 1x1 classifier.

Port of ``gaiaseg_tpu/models/decode_heads/base.py``: an int ``in_index``
picks one input; ``input_transform='multiple_select'`` with a list
``in_index`` picks several (``in_channels`` is then a list).
``resize_concat`` waits for a later slice. The loss lives in the
segmentor, so heads are pure feature -> logit functions.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ...ops.dynamic_layers import DynConv2d


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout drawn from an explicit generator (the JAX head's
    ``nn.Dropout``); ``F.dropout`` takes no generator."""
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask / keep


class BaseDecodeHead(nn.Module):
    def __init__(self, in_channels: Union[int, Sequence[int]], channels: int,
                 num_classes: int = 19,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 dropout_ratio: float = 0.1, align_corners: bool = False,
                 ignore_index: int = 255):
        super().__init__()
        if input_transform not in (None, "multiple_select"):
            raise NotImplementedError(
                f"input_transform={input_transform!r} waits for a later "
                "slice of the port")
        if (input_transform is None) != isinstance(in_index, int):
            raise ValueError("in_index is a list exactly when "
                             "input_transform='multiple_select'")
        self.input_transform = input_transform
        self.in_channels = [int(c) for c in in_channels] \
            if input_transform else int(in_channels)
        self.channels = int(channels)
        self.num_classes = int(num_classes)
        self.in_index = in_index
        self.dropout_ratio = float(dropout_ratio)
        self.align_corners = bool(align_corners)
        self.ignore_index = ignore_index
        self.conv_seg = DynConv2d(self.channels, self.num_classes, 1,
                                  bias=True)

    def _transform_inputs(self, inputs):
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
