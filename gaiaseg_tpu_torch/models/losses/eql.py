"""Equalization loss (EQL), the packed multi-label losses and mask CE.

Port of ``gaiaseg_tpu/models/losses/eql.py`` (the reference's
``cross_entropy_loss.py:11-295`` and ``cross_entropy_loss_EQL.py``):
logits NCHW ``[N, C, H, W]``, labels ``[N, H, W]``; the class axis is 1
wherever JAX's is the last. float32 (float64 for float64 logits); across
ranks a mean is the global batch's (``dice_focal.py``).

EQL's negative-gradient suppression is drawn from the step's generator
(JAX's ``_seg_loss`` passes no key, so its loss falls back to
``PRNGKey(0)`` on every call and suppresses the same pixels' negatives on
every step: ROADMAP C19). Without a generator the port draws from one
seeded 0, its own fixed fallback.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...ops.dropout import global_bernoulli
from ...utils.registry import LOSSES
from .cross_entropy import softmax_cross_entropy
from .dice_focal import _bce, _onehot, _valid_mean, _wide


def _codes(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The reference's 3-bit packing: category k's code ``(label >> 3k) &
    7`` of each pixel, ``[N, C, H, W]``."""
    label = label.long()
    return torch.stack([(label >> (3 * k)) & 7 for k in range(num_classes)],
                       dim=1)


def decode_packed_labels(label: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """Float ``[N, C, ...]`` of a packed label ``[N, ...]``: 1 where
    category k's code is 1 (positive), else 0 (reference
    ``cross_entropy_loss.py:118-186``)."""
    return (_codes(label, num_classes) == 1).float()


def equalize_loss(logits: torch.Tensor, label: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  tail_classes: Optional[Sequence[int]] = None,
                  sample_ratio: float = 0.618, ignore_index: int = 255,
                  keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sigmoid BCE against one-hot targets where the negative terms of the
    ``tail_classes`` are kept with probability ``1 - sample_ratio``
    (reference ``cross_entropy_loss.py:188-258``), summed over the classes
    and averaged over the valid pixels. ``keep_mask`` (0/1, the logits'
    shape) replaces the draw from ``generator``."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    x = _wide(logits)
    num_classes = x.shape[1]
    onehot = _onehot(safe, num_classes, x.dtype)
    bce = _bce(x, onehot)
    tail = torch.zeros(num_classes, dtype=x.dtype, device=x.device)
    if tail_classes is not None and len(tail_classes):
        tail[torch.as_tensor(list(tail_classes), device=x.device)] = 1.0
    if keep_mask is None:
        if generator is None:
            generator = torch.Generator(device=x.device)
            generator.manual_seed(0)
        keep_mask = global_bernoulli(bce, bce.shape, 1.0 - sample_ratio,
                                     generator)
    w = 1.0 - tail[:, None, None] * (1.0 - keep_mask.to(x.dtype)) \
        * (1.0 - onehot)
    return _valid_mean((bce * w).sum(1), valid)


def mask_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                       mask: torch.Tensor,
                       ignore_index: int = 255) -> torch.Tensor:
    """Softmax CE over the pixels of a boolean ``mask`` (reference
    ``cross_entropy_loss.py:261-295``)."""
    return softmax_cross_entropy(logits, label, ignore_index=ignore_index,
                                 pixel_weight=mask.to(torch.float32))


@LOSSES.register_module()
class EQLCrossEntropyLoss:
    """Config-buildable EQL (``type='EQLCrossEntropyLoss'``; the reference
    registers it over ``CrossEntropyLoss``, here it keeps its own name).
    The segmentor passes the step's generator."""

    takes_generator = True

    def __init__(self, tail_classes: Sequence[int] = (),
                 sample_ratio: float = 0.618, loss_weight: float = 1.0,
                 loss_name: str = "loss_eql", **kw):
        self.tail_classes = tuple(tail_classes)
        self.sample_ratio = sample_ratio
        self.loss_weight = loss_weight
        self.loss_name = loss_name

    def __call__(self, logits, label, ignore_index: int = 255,
                 generator: Optional[torch.Generator] = None, **kw):
        return self.loss_weight * equalize_loss(
            logits, label, generator, self.tail_classes, self.sample_ratio,
            ignore_index)


def self_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                       num_classes: Optional[int] = None,
                       ignore_index: int = 255) -> torch.Tensor:
    """Sigmoid BCE over the packed multi-label encoding (reference
    ``cross_entropy_loss.py:11-65``): code 1 trains against 1, code 2
    ("self") against the detached sigmoid of the model's own logit, the
    rest against 0; a pixel counts when any code is set and it is not
    ``ignore_index``."""
    codes = _codes(label, num_classes or logits.shape[1])
    x = _wide(logits)
    own = torch.sigmoid(x).detach()
    target = torch.where(codes == 1, torch.ones_like(x),
                         torch.where(codes == 2, own, torch.zeros_like(x)))
    valid = (codes > 0).any(1) & (label != ignore_index)
    return _valid_mean(_bce(x, target).sum(1), valid)
