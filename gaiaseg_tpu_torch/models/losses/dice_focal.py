"""Dice, focal and mixed losses, and pixel accuracy.

Port of ``gaiaseg_tpu/models/losses/dice_focal.py`` (the reference's
``dice_loss.py``, ``focal_loss.py``, ``mixed_loss.py`` and
``accuracy.py``): logits NCHW ``[N, C, H, W]``, labels ``[N, H, W]`` with
``ignore_index``. The losses compute in float32 (float64 for float64
logits).

Across ranks each loss is the global batch's, as in ``cross_entropy.py``:
this rank returns its share and the shares add up to it. A weighted mean
divides by the valid count summed over the ranks. Dice is not a mean: its
per-class sums are summed over the ranks (the other ranks' terms enter as
constants, so each rank's gradient is that of the global loss through its
own pixels, and the ranks' gradients add up to the whole one), and each
rank returns ``1 / world`` of the value.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ...parallel.distributed import data_parallel, sum_over_ranks
from ...utils.registry import LOSSES


def _wide(logits: torch.Tensor) -> torch.Tensor:
    return logits.to(torch.promote_types(logits.dtype, torch.float32))


def _onehot(safe: torch.Tensor, num_classes: int,
            dtype: torch.dtype) -> torch.Tensor:
    """``[N, H, W]`` class ids -> ``[N, C, H, W]`` one-hot."""
    return F.one_hot(safe, num_classes).permute(0, 3, 1, 2).to(dtype)


def _valid_mean(loss: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``sum(loss * valid) / max(sum(valid), 1)``, the count over every
    rank."""
    w = valid.to(loss.dtype)
    return (loss * w).sum() / sum_over_ranks(w.sum()).clamp_min(1.0)


def _global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks; its gradient flows to this rank's
    own term."""
    if data_parallel()[1] == 1:
        return t
    return t + (sum_over_ranks(t) - t).detach()


def _rank_share(loss: torch.Tensor) -> torch.Tensor:
    """``loss / world`` in value, ``loss``'s gradient."""
    world = data_parallel()[1]
    if world == 1:
        return loss
    return loss - (loss * (1.0 - 1.0 / world)).detach()


def multiclass_dice(logits: torch.Tensor, label: torch.Tensor,
                    ignore_index: int = 255,
                    smooth: float = 1.0) -> torch.Tensor:
    """1 - the mean over classes of the softmax dice ``(2 * inter +
    smooth) / (sum prob + sum onehot + smooth)``, ignored pixels left
    out (reference ``dice_loss.py:93-109``)."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    prob = torch.softmax(_wide(logits), dim=1)
    v = valid[:, None].to(prob.dtype)
    onehot = _onehot(safe, logits.shape[1], prob.dtype) * v
    prob = prob * v
    dims = (0, 2, 3)
    inter = _global_sum((prob * onehot).sum(dims))
    denom = _global_sum(prob.sum(dims) + onehot.sum(dims))
    dice = (2 * inter + smooth) / (denom + smooth)
    return _rank_share(1.0 - dice.mean())


def binary_dice(prob: torch.Tensor, target: torch.Tensor,
                smooth: float = 1.0) -> torch.Tensor:
    """1 - ``(2 * sum(prob * target) + smooth) / (sum prob + sum target +
    smooth)`` over every element."""
    inter = _global_sum((prob * target).sum())
    denom = _global_sum(prob.sum() + target.sum())
    return _rank_share(1.0 - (2 * inter + smooth) / (denom + smooth))


@LOSSES.register_module()
class DiceLoss:
    """``binary_class``: the sigmoid of class channel 0 against ``label ==
    1`` (every pixel counts, as in JAX); else ``multiclass_dice``."""

    def __init__(self, loss_weight: float = 1.0, binary_class: bool = False,
                 smooth: float = 1.0, loss_name: str = "loss_dice", **kw):
        self.loss_weight = loss_weight
        self.binary_class = binary_class
        self.smooth = smooth
        self.loss_name = loss_name

    def __call__(self, logits, label, ignore_index: int = 255, **kw):
        if self.binary_class:
            prob = torch.sigmoid(_wide(logits[:, 0]))
            target = (label == 1).to(prob.dtype)
            return self.loss_weight * binary_dice(prob, target, self.smooth)
        return self.loss_weight * multiclass_dice(logits, label, ignore_index,
                                                  self.smooth)


def _bce(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid BCE of logits ``x`` against ``target``."""
    return x.clamp_min(0) - x * target + torch.log1p(torch.exp(-x.abs()))


def sigmoid_focal(logits: torch.Tensor, label: torch.Tensor,
                  alpha: float = 0.25, gamma: float = 2.0,
                  ignore_index: int = 255) -> torch.Tensor:
    """Sigmoid focal loss against one-hot targets, summed over the classes
    and averaged over the valid pixels (reference ``focal_loss.py:31-82``)."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    x = _wide(logits)
    onehot = _onehot(safe, x.shape[1], x.dtype)
    p = torch.sigmoid(x)
    pt = p * onehot + (1 - p) * (1 - onehot)
    at = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = (at * (1 - pt) ** gamma * _bce(x, onehot)).sum(1)
    return _valid_mean(loss, valid)


def softmax_focal(logits: torch.Tensor, label: torch.Tensor,
                  gamma: float = 2.0, ignore_index: int = 255
                  ) -> torch.Tensor:
    """Softmax CE re-weighted by ``(1 - p_label) ** gamma``, averaged over
    the valid pixels (reference ``focal_loss.py:85-111``)."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    logp = torch.log_softmax(_wide(logits), dim=1)
    nll = -logp.gather(1, safe[:, None]).squeeze(1)
    return _valid_mean((1 - torch.exp(-nll)) ** gamma * nll, valid)


@LOSSES.register_module()
class FocalLoss:
    def __init__(self, use_sigmoid: bool = True, alpha: float = 0.25,
                 gamma: float = 2.0, loss_weight: float = 1.0,
                 loss_name: str = "loss_focal", **kw):
        self.use_sigmoid = use_sigmoid
        self.alpha = alpha
        self.gamma = gamma
        self.loss_weight = loss_weight
        self.loss_name = loss_name

    def __call__(self, logits, label, ignore_index: int = 255, **kw):
        if self.use_sigmoid:
            return self.loss_weight * sigmoid_focal(
                logits, label, self.alpha, self.gamma, ignore_index)
        return self.loss_weight * softmax_focal(logits, label, self.gamma,
                                                ignore_index)


@LOSSES.register_module()
class MixedLoss:
    """Weighted sum of sub-losses built from their configs through
    ``LOSSES`` (reference ``mixed_loss.py:37-93``). The step's generator
    reaches the sub-losses that draw (EQL)."""

    def __init__(self, losses: Sequence[dict],
                 weights: Optional[Sequence[float]] = None,
                 loss_weight: float = 1.0, loss_name: str = "loss_mixed",
                 **kw):
        self.losses = [LOSSES.build(dict(c)) for c in losses]
        self.weights = list(weights) if weights else [1.0] * len(self.losses)
        self.loss_weight = loss_weight
        self.loss_name = loss_name
        self.takes_generator = any(getattr(fn, "takes_generator", False)
                                   for fn in self.losses)

    def __call__(self, logits, label, ignore_index: int = 255,
                 generator: Optional[torch.Generator] = None, **kw):
        total = 0.0
        for w, fn in zip(self.weights, self.losses):
            extra = {"generator": generator} \
                if getattr(fn, "takes_generator", False) else {}
            total = total + w * fn(logits, label, ignore_index=ignore_index,
                                   **extra)
        return self.loss_weight * total


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
