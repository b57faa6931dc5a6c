"""DynamicResNet supernet backbone, elastic by slicing.

Port of ``gaiaseg_tpu/models/backbones/dynamic_resnet.py``: a stem, a 3x3/2
max pool and four stages of bottlenecks. The arch
``{'stem': {'width'}, 'body': {'width': [4], 'depth': [4]}}`` picks the
active stem width, per-stage mid widths and depths; a stage runs its first
``depth`` blocks on prefix slices of the MAX-shape parameters.

The stem is a 7x7/2 conv (``conv1``/``bn1``) or, with ``deep_stem`` (the
v1c variant), three 3x3 conv-BN-ReLU, the first at stride 2, laid out as
mmseg's Sequential ``stem.{0,1,3,4,6,7}``. Its widths are a 3-list, or
``w//2, w//2, w`` for a scalar (JAX ``stem_widths``); an arch's stem width
is a 3-list or a scalar read the same way. ``avg_down`` gives each stage's
first block the ResNet-D shortcut; ``contract_dilation`` halves that
block's dilation when it is above 1. ``norm_eval`` keeps the backbone's BN
modules in eval mode whatever ``train()`` says (JAX ``bn_train = train and
not norm_eval``): they normalize with their running statistics, leave
them alone and call no collective, while the heads train theirs.
``frozen_stages`` is read by the optimizer (``engine/optim.freeze_labels``),
not here, as in JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.blocks import DynBottleneck
from ...ops.dynamic_layers import DynBatchNorm, DynConv2d
from ...utils.registry import BACKBONES


def stem_widths(stem_width: Any, deep_stem: bool) -> Tuple[int, ...]:
    """The stem convs' widths (JAX ``DynamicResNet.stem_widths``)."""
    if isinstance(stem_width, (list, tuple)):
        return tuple(int(w) for w in stem_width)
    w = int(stem_width)
    return (w // 2, w // 2, w) if deep_stem else (w,)


@BACKBONES.register_module()
class DynamicResNet(nn.Module):
    def __init__(self, stem_width: Any = 64,
                 body_width: Sequence[int] = (80, 160, 320, 640),
                 body_depth: Sequence[int] = (4, 6, 29, 4),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 deep_stem: bool = False, avg_down: bool = False,
                 contract_dilation: bool = False, norm_eval: bool = False,
                 frozen_stages: int = -1):
        super().__init__()
        self.deep_stem = bool(deep_stem)
        self.norm_eval = bool(norm_eval)
        self.frozen_stages = int(frozen_stages)
        self.body_width = [int(w) for w in body_width]
        self.body_depth = [int(d) for d in body_depth]
        self.out_indices = tuple(out_indices)
        sws = stem_widths(stem_width, self.deep_stem)
        if self.deep_stem:
            if len(sws) != 3:
                raise ValueError(f"deep stem widths {sws}: three convs")
            layers, cin = [], 3
            for i, w in enumerate(sws):
                layers += [DynConv2d(cin, w, 3, 2 if i == 0 else 1),
                           DynBatchNorm(w), nn.ReLU()]
                cin = w
            self.stem = nn.ModuleList(layers)
        else:
            self.conv1 = DynConv2d(3, sws[0], 7, 2)
            self.bn1 = DynBatchNorm(sws[0])
        inplanes = sws[-1]
        for i, (w, d) in enumerate(zip(self.body_width, self.body_depth)):
            first = dilations[i]
            if contract_dilation and first > 1:
                first //= 2
            blocks = [DynBottleneck(inplanes, w, strides[i], first,
                                    downsample=True, avg_down=avg_down)]
            inplanes = w * DynBottleneck.expansion
            blocks += [DynBottleneck(inplanes, w, 1, dilations[i])
                       for _ in range(1, d)]
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))

    @staticmethod
    def max_arch_of(cfg: Dict[str, Any]) -> Dict[str, Any]:
        """Nested arch dict at MAX, from a backbone config."""
        sws = stem_widths(cfg.get("stem_width", 64),
                          bool(cfg.get("deep_stem", False)))
        return {"stem": {"width": list(sws) if len(sws) > 1 else sws[0]},
                "body": {"width": [int(w) for w in
                                   cfg.get("body_width", (80, 160, 320, 640))],
                         "depth": [int(d) for d in
                                   cfg.get("body_depth", (4, 6, 29, 4))]}}

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.body_width[i] * DynBottleneck.expansion
                     for i in self.out_indices)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, DynBatchNorm):
                    m.eval()
        return self

    def _stem(self, x: torch.Tensor, width: Any) -> torch.Tensor:
        if not self.deep_stem:
            w = int(width[0] if isinstance(width, (list, tuple)) else width)
            return F.relu(self.bn1(self.conv1(x, w)))
        ws = [int(v) for v in width] if isinstance(width, (list, tuple)) \
            else [int(width) // 2, int(width) // 2, int(width)]
        for i, w in enumerate(ws):
            conv, bn = self.stem[3 * i], self.stem[3 * i + 1]
            x = F.relu(bn(conv(x, w)))
        return x

    def forward(self, x: torch.Tensor,
                arch: Dict[str, Any]) -> List[torch.Tensor]:
        widths, depths = arch["body"]["width"], arch["body"]["depth"]
        x = self._stem(x, arch["stem"]["width"])
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(len(self.body_width)):
            if not 1 <= depths[i] <= self.body_depth[i] \
                    or not 1 <= widths[i] <= self.body_width[i]:
                raise ValueError(f"stage {i + 1} arch (width {widths[i]}, "
                                 f"depth {depths[i]}) is outside the MAX net")
            layer = getattr(self, f"layer{i + 1}")
            for block in layer[:depths[i]]:
                x = block(x, int(widths[i]))
            if i in self.out_indices:
                outs.append(x)
        return outs
