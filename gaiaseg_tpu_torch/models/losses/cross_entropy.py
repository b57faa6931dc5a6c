"""Cross-entropy losses with ignore index, class and pixel weights.

Port of ``weight_reduce_loss``, ``softmax_cross_entropy``,
``binary_cross_entropy`` and ``CrossEntropyLoss`` from
``gaiaseg_tpu/models/losses/cross_entropy.py`` (mmseg's semantics). Logits
are NCHW ``[N, C, H, W]``; labels ``[N, H, W]`` with ``ignore_index`` (255,
the seg pad value). The distillation losses wait for a later slice.

Across ranks every mean is the global batch's: this rank returns its share
and the ranks' shares add up to it. A denominator that counts pixels or
weights is summed over the ranks (``sum_over_ranks``); a ``sum`` is its own
share; ``none`` returns this rank's pixels.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ...parallel.distributed import data_parallel, sum_over_ranks
from ...utils.registry import LOSSES


def weight_reduce_loss(loss: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean") -> torch.Tensor:
    """mmseg's reduction (JAX ``weight_reduce_loss``; no caller gives its
    ``avg_factor``); ``mean`` is over every rank's elements."""
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"reduction={reduction!r}")
    world = data_parallel()[1]
    return loss.mean() if world == 1 else loss.sum() / (loss.numel() * world)


def _class_weight(class_weight: Any, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(class_weight, dtype=torch.float32,
                           device=like.device)


def softmax_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                          ignore_index: int = 255,
                          avg_non_ignore: bool = True,
                          class_weight: Any = None,
                          reduction: str = "mean",
                          pixel_weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Softmax CE in float32, each pixel weighted by its validity, its
    label's ``class_weight`` and its ``pixel_weight``. ``mean`` with
    ``avg_non_ignore`` divides by the sum of those weights, else by the
    pixel count."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = -logp.gather(1, safe[:, None]).squeeze(1)
    w = valid.float()
    if class_weight is not None:
        w = w * _class_weight(class_weight, logits)[safe]
    if pixel_weight is not None:
        w = w * pixel_weight.float()
    if reduction == "none":
        return nll * w
    if avg_non_ignore and reduction == "mean":
        return (nll * w).sum() / sum_over_ranks(w.sum()).clamp_min(1.0)
    return weight_reduce_loss(nll, w, reduction)


def binary_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                         ignore_index: int = 255,
                         class_weight: Any = None) -> torch.Tensor:
    """Sigmoid BCE against one-hot targets, summed over the classes (each
    times its ``class_weight``), averaged over the valid pixels."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    x = logits.float()
    onehot = F.one_hot(safe, x.shape[1]).permute(0, 3, 1, 2).float()
    per = x.clamp_min(0) - x * onehot + torch.log1p(torch.exp(-x.abs()))
    if class_weight is not None:
        per = per * _class_weight(class_weight, x)[:, None, None]
    w = valid.float()
    return (per.sum(1) * w).sum() / sum_over_ranks(w.sum()).clamp_min(1.0)


@LOSSES.register_module()
class CrossEntropyLoss:
    """Config-buildable CE (``type='CrossEntropyLoss'`` in every reference
    model config). ``use_sigmoid`` takes the BCE (which, as in JAX, reads
    neither ``reduction`` nor a pixel weight); ``use_mask`` is accepted and
    ignored, as in JAX."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = "mean", class_weight: Any = None,
                 loss_weight: float = 1.0, avg_non_ignore: bool = True,
                 loss_name: str = "loss_ce"):
        if reduction not in ("none", "sum", "mean"):
            raise ValueError(f"reduction={reduction!r}")
        self.use_sigmoid = use_sigmoid
        self.class_weight = class_weight
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.avg_non_ignore = avg_non_ignore
        self.loss_name = loss_name

    def __call__(self, logits: torch.Tensor, label: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 ignore_index: int = 255) -> torch.Tensor:
        if self.use_sigmoid:
            loss = binary_cross_entropy(logits, label, ignore_index,
                                        self.class_weight)
        else:
            loss = softmax_cross_entropy(
                logits, label, ignore_index, self.avg_non_ignore,
                self.class_weight, self.reduction, pixel_weight=weight)
        return self.loss_weight * loss
