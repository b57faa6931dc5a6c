"""DynamicResNet supernet backbone, elastic by slicing.

Port of ``gaiaseg_tpu/models/backbones/dynamic_resnet.py``: a 7x7/2 stem, a
3x3/2 max pool and four stages of bottlenecks. The arch
``{'stem': {'width'}, 'body': {'width': [4], 'depth': [4]}}`` picks the
active stem width, per-stage mid widths and depths; a stage runs its first
``depth`` blocks on prefix slices of the MAX-shape parameters.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.blocks import DynBottleneck
from ...ops.dynamic_layers import DynBatchNorm, DynConv2d
from ...utils.registry import BACKBONES


@BACKBONES.register_module()
class DynamicResNet(nn.Module):
    def __init__(self, stem_width: int = 64,
                 body_width: Sequence[int] = (80, 160, 320, 640),
                 body_depth: Sequence[int] = (4, 6, 29, 4),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 deep_stem: bool = False, avg_down: bool = False,
                 contract_dilation: bool = False, norm_eval: bool = False,
                 frozen_stages: int = -1):
        super().__init__()
        waiting = {"deep_stem": deep_stem, "avg_down": avg_down,
                   "contract_dilation": contract_dilation,
                   "norm_eval": norm_eval, "frozen_stages": frozen_stages >= 0}
        if any(waiting.values()):
            raise NotImplementedError(
                f"DynamicResNet options {[k for k, v in waiting.items() if v]}"
                " wait for a later slice of the port")
        self.body_width = [int(w) for w in body_width]
        self.body_depth = [int(d) for d in body_depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = DynConv2d(3, int(stem_width), 7, 2)
        self.bn1 = DynBatchNorm(int(stem_width))
        inplanes = int(stem_width)
        for i, (w, d) in enumerate(zip(self.body_width, self.body_depth)):
            blocks = [DynBottleneck(inplanes, w, strides[i], dilations[i],
                                    downsample=True)]
            inplanes = w * DynBottleneck.expansion
            blocks += [DynBottleneck(inplanes, w, 1, dilations[i])
                       for _ in range(1, d)]
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))

    @staticmethod
    def max_arch_of(cfg: Dict[str, Any]) -> Dict[str, Any]:
        """Nested arch dict at MAX, from a backbone config."""
        return {"stem": {"width": int(cfg.get("stem_width", 64))},
                "body": {"width": [int(w) for w in
                                   cfg.get("body_width", (80, 160, 320, 640))],
                         "depth": [int(d) for d in
                                   cfg.get("body_depth", (4, 6, 29, 4))]}}

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.body_width[i] * DynBottleneck.expansion
                     for i in self.out_indices)

    def forward(self, x: torch.Tensor,
                arch: Dict[str, Any]) -> List[torch.Tensor]:
        stem = arch["stem"]["width"]
        stem = int(stem[0] if isinstance(stem, (list, tuple)) else stem)
        widths, depths = arch["body"]["width"], arch["body"]["depth"]
        x = F.relu(self.bn1(self.conv1(x, stem)))
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
