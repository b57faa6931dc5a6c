"""DynamicConvNeXt supernet backbone, elastic by slicing.

Port of ``gaiaseg_tpu/models/backbones/dynamic_convnext.py``: a 4x4/4 conv
stem with bias and a LayerNorm, four stages of blocks with a LayerNorm and
a 2x2/2 conv between them, and a LayerNorm ``norm{i}`` on each stage in
``out_indices``. A block is a depthwise 7x7 conv with bias, then (channels
last) LayerNorm, ``pwconv1`` to 4C, tanh GELU (flax's ``nn.gelu``),
``pwconv2`` back to C and the layer scale ``gamma``, then stochastic depth
on the branch and the residual add. Every LayerNorm has eps 1e-6.

The arch ``{'body': {'width': [4], 'depth': [4]}}`` picks each stage's
active width and depth; a stage runs its first ``depth`` blocks on prefix
slices of the MAX-shape parameters (a block past the depth passes ``x``
on), and the stem and each downsample conv produce the next stage's active
width. The stochastic-depth rates are spaced over the MAX blocks,
``drop_path_rate * i / (sum(depths) - 1)`` for block ``i``, whatever the
active depth.

Parameter names follow the upstream ConvNeXt segmentation layout:
``downsample_layers.0.{0,1}`` (stem conv, its LayerNorm),
``downsample_layers.{1,2,3}.{0,1}`` (LayerNorm, conv),
``stages.{i}.{j}.{dwconv,norm,pwconv1,pwconv2,gamma}`` and ``norm{i}``;
``pwconv*`` are linear weights ``[out, in]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dropout import drop_path
from ...ops.dynamic_layers import (DynChannelLayerNorm, DynConv2d,
                                   DynLayerNorm, DynLinear)
from ...utils.registry import BACKBONES


class DynamicConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, dp_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dp_rate = float(dp_rate)
        self.dwconv = DynConv2d(dim, dim, 7, bias=True, groups=dim)
        self.norm = DynLayerNorm(dim)
        self.pwconv1 = DynLinear(dim, 4 * dim)
        self.pwconv2 = DynLinear(4 * dim, dim)
        # float32, as the JAX parameter, cast to the compute type when used
        self.gamma = nn.Parameter(torch.full((dim,), float(
            layer_scale_init_value))) if layer_scale_init_value > 0 else None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = x.shape[1]
        y = self.dwconv(x).permute(0, 2, 3, 1)          # NHWC for LN, linears
        y = self.pwconv1(self.norm(y), 4 * c)
        y = self.pwconv2(F.gelu(y, approximate="tanh"), c)
        if self.gamma is not None:
            y = y * self.gamma[:c].to(y.dtype)
        y = y.permute(0, 3, 1, 2)
        return x + drop_path(y, self.dp_rate, generator, self.training)


@BACKBONES.register_module()
class DynamicConvNeXt(nn.Module):
    def __init__(self, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (3, 3, 9, 3),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-6, in_chans: int = 3):
        super().__init__()
        self.dims = [int(d) for d in dims]
        self.depths = [int(d) for d in depths]
        self.out_indices = tuple(int(i) for i in out_indices)
        self.downsample_layers = nn.ModuleList([nn.ModuleList([
            DynConv2d(in_chans, self.dims[0], 4, 4, bias=True, padding=0),
            DynChannelLayerNorm(self.dims[0])])])
        for i in range(1, 4):
            self.downsample_layers.append(nn.ModuleList([
                DynChannelLayerNorm(self.dims[i - 1]),
                DynConv2d(self.dims[i - 1], self.dims[i], 2, 2, bias=True,
                          padding=0)]))
        total = sum(self.depths)
        rates = [float(drop_path_rate) * i / max(total - 1, 1)
                 for i in range(total)]
        self.stages = nn.ModuleList()
        offset = 0
        for dim, depth in zip(self.dims, self.depths):
            self.stages.append(nn.ModuleList([
                DynamicConvNeXtBlock(dim, rates[offset + j],
                                     layer_scale_init_value)
                for j in range(depth)]))
            offset += depth
        for i in self.out_indices:
            self.add_module(f"norm{i}", DynChannelLayerNorm(self.dims[i]))

    @staticmethod
    def max_arch_of(cfg: Dict[str, Any]) -> Dict[str, Any]:
        """Nested arch dict at MAX, from a backbone config."""
        return {"body": {
            "width": [int(w) for w in cfg.get("dims", (96, 192, 384, 768))],
            "depth": [int(d) for d in cfg.get("depths", (3, 3, 9, 3))]}}

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.dims[i] for i in self.out_indices)

    def forward(self, x: torch.Tensor, arch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """``generator`` draws the blocks' stochastic depth in training."""
        widths = [int(w) for w in arch["body"]["width"]]
        depths = [int(d) for d in arch["body"]["depth"]]
        for i in range(4):
            if not 1 <= depths[i] <= self.depths[i] \
                    or not 1 <= widths[i] <= self.dims[i]:
                raise ValueError(f"stage {i} arch (width {widths[i]}, depth "
                                 f"{depths[i]}) is outside the MAX net")
        conv, ln = self.downsample_layers[0]
        x = ln(conv(x, widths[0]))
        outs = []
        for i in range(4):
            for block in self.stages[i][:depths[i]]:
                x = block(x, generator)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
            if i < 3:
                ln, conv = self.downsample_layers[i + 1]
                x = conv(ln(x), widths[i + 1])
        return outs
