"""Cross-entropy losses with ignore index, class and pixel weights.

Port of ``weight_reduce_loss``, ``softmax_cross_entropy``,
``binary_cross_entropy``, ``CrossEntropyLoss`` and the distillation
losses ``distill_softened_ce`` and ``pairwise_gram_loss`` from
``gaiaseg_tpu/models/losses/cross_entropy.py`` (mmseg's semantics). Logits
are NCHW ``[N, C, H, W]``; labels ``[N, H, W]`` with ``ignore_index`` (255,
the seg pad value).

Across ranks every mean is the global batch's: this rank returns its share
and the ranks' shares add up to it. A denominator that counts pixels or
weights is summed over the ranks of the data axis (``sum_over_ranks``: the
K model ranks of a data index hold the same pixels); a ``sum`` is its own
share; ``none`` returns this rank's pixels.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

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
    """Softmax CE in float32 (float64 for float64 logits), each pixel
    weighted by its validity, its label's ``class_weight`` and its
    ``pixel_weight``. ``mean`` with ``avg_non_ignore`` divides by the sum of
    those weights, else by the pixel count."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=1)
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


def distill_softened_ce(student_logits: torch.Tensor,
                        teacher_logits: torch.Tensor,
                        temperature: float = 1.0) -> torch.Tensor:
    """Pixelwise softened CE ``-sum softmax(t/T) * log_softmax(s/T)`` over
    the classes (dim 1), divided by the student's ``N*H*W`` (JAX
    ``cross_entropy.py:108-115``), in float32; across ranks the global
    batch's mean."""
    with torch.autocast(student_logits.device.type, enabled=False):
        t = torch.softmax(teacher_logits.float() / temperature, dim=1)
        logs = torch.log_softmax(student_logits.float() / temperature, dim=1)
        n = student_logits.shape[0] * student_logits.shape[2] \
            * student_logits.shape[3]
        return -(t * logs).sum() / (n * data_parallel()[1])


def _crop_offsets(h: int, w: int, sh: int, sw: int,
                  generator: torch.Generator) -> torch.Tensor:
    """``(y0, x0)`` uniform in ``[0, h-sh] x [0, w-sw]``, drawn on the
    generator's device (nothing read back)."""
    dev = generator.device
    return torch.cat([torch.randint(0, h - sh + 1, (1,), generator=generator,
                                    device=dev),
                      torch.randint(0, w - sw + 1, (1,), generator=generator,
                                    device=dev)])


def _gram(f: torch.Tensor) -> torch.Tensor:
    """Channel-normalised ``[N, C, h, w]`` -> ``[N, hw, hw]`` cosines."""
    f = f.float()
    f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-8)
    f = f.flatten(2)
    return torch.einsum("ncp,ncq->npq", f, f)


def pairwise_gram_loss(student_feat: torch.Tensor,
                       teacher_feat: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       offsets: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """Pairwise similarity distillation (JAX ``cross_entropy.py:118-151``):
    channel-normalised Gram matrices ``[N, HW, HW]`` of the student's and
    the teacher's feature maps (the same size, any channel counts), and the
    CE of the teacher's row softmax against the student's, averaged over
    the rows. With a ``generator`` (or explicit ``offsets``) both maps are
    cut to the same random ``h//2 x w//2`` window first, unless that window
    would be under 2 on a side. The offsets come from the generator on its
    device; every rank draws the same ones from its copy of the shared
    generator. Float32; across ranks the global batch's mean."""
    n, _, h, w = student_feat.shape
    sh, sw = h // 2, w // 2
    if (generator is not None or offsets is not None) and sh >= 2 \
            and sw >= 2:
        if offsets is not None:
            student_feat = student_feat[:, :, offsets[0]:offsets[0] + sh,
                                        offsets[1]:offsets[1] + sw]
            teacher_feat = teacher_feat[:, :, offsets[0]:offsets[0] + sh,
                                        offsets[1]:offsets[1] + sw]
        else:
            yx = _crop_offsets(h, w, sh, sw, generator).to(
                student_feat.device)
            rows = yx[0] + torch.arange(sh, device=yx.device)
            cols = yx[1] + torch.arange(sw, device=yx.device)
            student_feat = student_feat.index_select(2, rows) \
                .index_select(3, cols)
            teacher_feat = teacher_feat.index_select(2, rows) \
                .index_select(3, cols)
    with torch.autocast(student_feat.device.type, enabled=False):
        gs, gt = _gram(student_feat), _gram(teacher_feat)
        pt = torch.softmax(gt, dim=-1)
        logps = torch.log_softmax(gs, dim=-1)
        rows = gs.shape[0] * gs.shape[1]
        return -(pt * logps).sum() / (rows * data_parallel()[1])
