"""Sliced dynamic layers: DynConv2d, DynBatchNorm, DynLinear, DynLayerNorm.

Port of ``gaiaseg_tpu/ops/dynamic_layers.py``. The JAX package keeps every
parameter at MAX shape and MASKS inactive channels, so one XLA program
serves every subnet. PyTorch runs eagerly and has no compile to amortise,
so the port does what the reference's gaiavision ops do: parameters live at
MAX shape and a subnet runs on PREFIX SLICES of them. ``tests/
test_dynamic_ops.py`` holds masking equal to slicing, so the two agree on
every active channel.

Layout is NCHW, parameters OIHW and linear weights ``[out, in]`` (the
reference mmseg / timm ``state_dict``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class DynConv2d(nn.Module):
    """Conv2d over a prefix slice of a MAX-shape ``[out, in, kh, kw]`` weight.

    The input rows follow ``x``: a narrower input takes kernel rows
    ``[:in_ch]``. ``in_tail`` marks an input that is a concat of
    ``[elastic prefix, static tail]`` (the PSP bottleneck): the prefix takes
    rows ``[:in_ch - in_tail]`` and the tail the LAST ``in_tail`` rows
    (``gaiaseg_tpu/ops/dynamic_layers.py:137-151``). ``out_channels``
    truncates the produced channels. ``padding=None`` is torch's symmetric
    ``dilation * (k - 1) // 2``; an int or pair pads symmetrically by that
    (0 for the ViT patch embed).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1,
                 dilation: Union[int, Tuple[int, int]] = 1,
                 bias: bool = False,
                 padding: Optional[Union[int, Tuple[int, int]]] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.padding = (self.dilation[0] * (kh - 1) // 2,
                        self.dilation[1] * (kw - 1) // 2) \
            if padding is None else _pair(padding)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kh, kw))
        # the JAX init: variance_scaling(2.0, "fan_out", truncated normal)
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor, out_channels: Optional[int] = None,
                in_tail: int = 0) -> torch.Tensor:
        w, b = self.weight, self.bias
        in_ch, in_max = x.shape[1], w.shape[1]
        if in_ch > in_max:
            raise ValueError(f"input has {in_ch} channels, the weight {in_max}")
        if in_ch < in_max:
            if in_tail:
                w = torch.cat([w[:, :in_ch - in_tail], w[:, in_max - in_tail:]],
                              dim=1)
            else:
                w = w[:, :in_ch]
        if out_channels is not None and out_channels < w.shape[0]:
            w = w[:out_channels]
            b = b[:out_channels] if b is not None else None
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation)


class DynBatchNorm(nn.Module):
    """Batch norm over the first ``x.shape[1]`` channels of MAX-shape
    parameters and running statistics.

    ``F.batch_norm`` on prefix views updates the running stats of the active
    channels in place and leaves the rest alone, which is the JAX module's
    gated update (``dynamic_layers.py:304-320``). ``momentum=0.1`` is torch's
    weight of the NEW statistic: the JAX ``momentum=0.9`` is the decay of the
    old one (``:238``). Both unbias the running variance by ``n/(n-1)``.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        return F.batch_norm(x, self.running_mean[:c], self.running_var[:c],
                            self.weight[:c], self.bias[:c], self.training,
                            self.momentum, self.eps)


class DynLinear(nn.Module):
    """Linear over a prefix slice of a MAX-shape ``[out, in]`` weight
    (``gaiaseg_tpu/ops/dynamic_layers.py:189-219``): the input width picks
    the columns, ``out_features`` truncates the rows."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        # the JAX init: lecun_normal (truncated normal, variance 1/fan_in)
        nn.init.trunc_normal_(self.weight, std=in_features ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor,
                out_features: Optional[int] = None) -> torch.Tensor:
        w, b = self.weight[:, :x.shape[-1]], self.bias
        if out_features is not None and out_features < w.shape[0]:
            w = w[:out_features]
            b = b[:out_features] if b is not None else None
        return F.linear(x, w, b)


class DynLayerNorm(nn.Module):
    """LayerNorm over the last ``x.shape[-1]`` channels with the prefix of
    MAX-shape ``weight``/``bias`` (``gaiaseg_tpu/ops/dynamic_layers.py:
    341-386``: mean and variance over the active channels only). ``eps``
    is the JAX module's 1e-6, not torch's 1e-5."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        return F.layer_norm(x, (c,), self.weight[:c], self.bias[:c], self.eps)
