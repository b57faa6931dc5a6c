"""Spatial resize / pooling, NCHW.

Port of ``gaiaseg_tpu/ops/resize.py``, which re-implements torch's own
semantics for NHWC (``tests/test_resize_parity.py`` holds them equal). Here
they are torch's functions themselves.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of ``[N,C,h,w]`` to ``size=(H, W)``."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear",
                         align_corners=align_corners)


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """Torch bin edges: bin i spans [floor(i*H/s), ceil((i+1)*H/s))."""
    return F.adaptive_avg_pool2d(x, output_size)
