"""Softmax cross-entropy with ignore index (the flagship loss).

Port of ``softmax_cross_entropy`` and ``CrossEntropyLoss`` from
``gaiaseg_tpu/models/losses/cross_entropy.py``. Logits are NCHW
``[N, C, H, W]``; labels ``[N, H, W]`` with ``ignore_index`` (255, the seg
pad value). The sigmoid BCE and the distillation losses wait for a later
slice.
"""
from __future__ import annotations

from typing import Any

import torch

from ...parallel.distributed import data_parallel, sum_over_ranks
from ...utils.registry import LOSSES


def softmax_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                          ignore_index: int = 255,
                          avg_non_ignore: bool = True) -> torch.Tensor:
    """Mean softmax CE over the pixels (over the non-ignored ones with
    ``avg_non_ignore``), computed in float32. Across ranks the mean is the
    global batch's: this rank returns its share, and the ranks' shares add
    up to it."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = -logp.gather(1, safe[:, None]).squeeze(1)
    w = valid.float()
    if avg_non_ignore:
        return (nll * w).sum() / sum_over_ranks(w.sum()).clamp_min(1.0)
    world = data_parallel()[1]
    if world == 1:
        return (nll * w).mean()
    return (nll * w).sum() / (w.numel() * world)


@LOSSES.register_module()
class CrossEntropyLoss:
    """Config-buildable CE (``type='CrossEntropyLoss'`` in every reference
    model config): plain softmax CE with ``loss_weight``. Class weights,
    other reductions and the sigmoid / mask variants wait for a later
    slice and raise."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = "mean", class_weight: Any = None,
                 loss_weight: float = 1.0, avg_non_ignore: bool = True,
                 loss_name: str = "loss_ce"):
        if use_sigmoid or use_mask or class_weight is not None \
                or reduction != "mean":
            raise NotImplementedError(
                "sigmoid / mask CE, class weights and reductions other than "
                "'mean' wait for a later slice of the port")
        self.use_sigmoid = use_sigmoid
        self.class_weight = class_weight
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.avg_non_ignore = avg_non_ignore
        self.loss_name = loss_name

    def __call__(self, logits: torch.Tensor, label: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
        return self.loss_weight * softmax_cross_entropy(
            logits, label, ignore_index, self.avg_non_ignore)
