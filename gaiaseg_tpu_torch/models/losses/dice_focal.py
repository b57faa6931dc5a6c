"""Pixel accuracy (the rest of JAX's ``dice_focal.py`` waits for a later
slice).

Port of ``pixel_accuracy`` from ``gaiaseg_tpu/models/losses/dice_focal.py``
(the reference's ``accuracy.py``): logits NCHW ``[N, C, H, W]``, labels
``[N, H, W]`` with ``ignore_index``.
"""
from __future__ import annotations

from typing import Optional

import torch


def pixel_accuracy(logits: torch.Tensor, label: torch.Tensor,
                   ignore_index: int = 255, topk: int = 1,
                   thresh: Optional[float] = None) -> torch.Tensor:
    """The share of valid pixels whose label is among the ``topk`` classes
    (and, with ``thresh``, whose top softmax score is above it); a float32
    scalar in ``[0, 1]``."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    n_valid = valid.sum().clamp_min(1).float()
    if topk == 1 and thresh is None:
        hit = (logits.argmax(dim=1) == safe) & valid
        return hit.sum().float() / n_valid
    scores = torch.softmax(logits.float(), dim=1)
    idx = scores.topk(topk, dim=1).indices
    hit = (idx == safe[:, None]).any(dim=1)
    if thresh is not None:
        hit = hit & (scores.amax(dim=1) > thresh)
    return (hit & valid).sum().float() / n_valid
