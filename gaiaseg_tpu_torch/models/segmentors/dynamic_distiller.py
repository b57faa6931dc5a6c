"""DynamicDistiller: a supernet student distilled from a frozen teacher.

Port of ``gaiaseg_tpu/models/segmentors/dynamic_distiller.py``: the
student is a ``DynamicEncoderDecoder``; the teacher (``t_backbone``, an
optional ``t_neck`` and ``t_decode_head``) runs in eval mode under
``torch.no_grad()`` and adds two losses to the student's:

- ``distill_loss_seg``: the softened pixel CE of the student's decode
  logits against the teacher's, resized to their size (``distill_weight``,
  ``temperature``);
- ``pairwise_loss_seg``: the pairwise Gram loss between the student's and
  the teacher's top feature maps, the teacher's resized to the student's,
  over a random 50% window drawn from the step's generator
  (``pairwise_weight``).

An elastic teacher (a trained supernet: self-distillation) runs at its MAX
arch. Its parameters take no gradient (``requires_grad`` off), so no
teacher parameter reaches the optimizer, the clip or the all-reduce, and
``train()`` leaves the teacher in eval mode: its BN statistics never move
and call no collective. Inference and eval are the student's, inherited.

The teacher's subtrees keep JAX's names (``t_backbone``, ``t_neck``,
``t_decode_head``): ``engine/calibrate.FROZEN_STAT_PREFIXES`` and the
teacher loader (``engine/teacher.py``) read them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ...ops.resize import resize_bilinear
from ...utils.registry import SEGMENTORS
from ..arch_util import backbone_max_arch
from ..builder import build_backbone, build_head, build_neck
from ..losses.cross_entropy import distill_softened_ce, pairwise_gram_loss
from .encoder_decoder import DynamicEncoderDecoder

TEACHER_PREFIXES: Tuple[str, ...] = ("t_backbone", "t_neck", "t_decode_head")


@SEGMENTORS.register_module()
class DynamicDistiller(DynamicEncoderDecoder):
    # JAX's val workflow runs a distiller's forward_train as the train step
    # does (it has no eval path, ``engine/train.py:634-648``): batch
    # statistics, left unchanged, and dropout
    eval_mode_val = False

    def __init__(self, backbone: Dict[str, Any], decode_head: Dict[str, Any],
                 teacher_backbone: Optional[Dict[str, Any]] = None,
                 teacher_decode_head: Optional[Dict[str, Any]] = None,
                 teacher_neck: Optional[Dict[str, Any]] = None,
                 distill_cfg: Optional[Dict[str, Any]] = None, **kw):
        super().__init__(backbone, decode_head, **kw)
        if teacher_backbone is None:
            raise ValueError("DynamicDistiller needs a teacher_backbone "
                             "config")
        self.t_backbone = build_backbone(teacher_backbone)
        chans = self.t_backbone.out_channels()
        self.t_neck = build_neck(teacher_neck, chans) if teacher_neck \
            else None
        if self.t_neck is not None:
            chans = self.t_neck.out_channels()
        self.t_decode_head = build_head(teacher_decode_head, chans) \
            if teacher_decode_head else None
        self.teacher_arch = backbone_max_arch(teacher_backbone) or None
        cfg = dict(distill_cfg or {})
        self.temperature = float(cfg.get("temperature", 1.0))
        self.distill_weight = float(cfg.get("distill_weight", 1.0))
        self.pairwise_weight = float(cfg.get("pairwise_weight", 0.0))
        for m in self.teacher_modules():
            m.requires_grad_(False)
        self.train(self.training)

    def teacher_modules(self) -> List[nn.Module]:
        return [m for m in (self.t_backbone, self.t_neck, self.t_decode_head)
                if m is not None]

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.teacher_modules():
            m.eval()
        return self

    @torch.no_grad()
    def teacher_forward(self, img: torch.Tensor
                        ) -> Tuple[List[torch.Tensor],
                                   Optional[torch.Tensor]]:
        """The frozen teacher's features and logits (JAX ``teacher_forward``)
        in eval mode, under a profiler range of that name."""
        with torch.profiler.record_function("teacher_forward"):
            feats = self.t_backbone(img, self.teacher_arch)
            if self.t_neck is not None:
                feats = self.t_neck(feats)
            logits = self.t_decode_head(feats) \
                if self.t_decode_head is not None else None
        return feats, logits

    def forward_train(self, img: torch.Tensor, gt: torch.Tensor,
                      arch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None,
                      compute_acc: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, {name: loss}) with JAX's keys: ``decode.loss_seg``,
        ``aux_{i}.loss_seg``, ``distill_loss_seg`` (with a teacher head and
        a positive ``distill_weight``), ``pairwise_loss_seg`` (with a
        positive ``pairwise_weight``) and, with ``compute_acc``,
        ``decode.acc_seg`` (the decode loss then unfused). ``generator``
        draws the heads' dropout and the pairwise window; without one the
        whole maps are compared."""
        feats = self.extract_feat(img, arch, generator)
        # JAX's distiller logs the decode head's accuracy only; its aux
        # losses stay fused
        dec, losses = self._head_losses(feats, gt, generator, compute_acc,
                                        acc_heads=("decode",))

        t_feats, t_logits = self.teacher_forward(img)
        if t_logits is not None and self.distill_weight > 0:
            tl = resize_bilinear(t_logits, dec.shape[2:], self.align_corners)
            losses["distill_loss_seg"] = self.distill_weight * \
                distill_softened_ce(dec, tl, self.temperature)
        if self.pairwise_weight > 0:
            s_top, t_top = feats[-1], t_feats[-1]
            if t_top.shape[2:] != s_top.shape[2:]:
                t_top = resize_bilinear(t_top, s_top.shape[2:])
            losses["pairwise_loss_seg"] = self.pairwise_weight * \
                pairwise_gram_loss(s_top, t_top, generator)
        return sum(v for k, v in losses.items() if "loss" in k), losses
