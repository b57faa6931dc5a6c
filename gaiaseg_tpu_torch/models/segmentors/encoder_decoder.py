"""DynamicEncoderDecoder: the supernet segmentor.

Port of ``gaiaseg_tpu/models/segmentors/encoder_decoder.py``: backbone
(-> neck) -> decode head (+ aux heads, which read the neck's outputs too),
losses of logits resized to label size, and
whole-mode inference. The train step's mode is ``forward_train`` with
``compute_acc=False`` (``engine/train.py:97`` of the JAX package), which is
the only mode here. Slide inference and TTA wait for a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ...ops.cuda.resize_ce import fused_resize_ce, supports_fused_resize_ce
from ...ops.resize import resize_bilinear
from ...utils.registry import SEGMENTORS
from ..builder import build_backbone, build_head, build_loss, build_neck
from ..losses.cross_entropy import CrossEntropyLoss


@SEGMENTORS.register_module(name=["DynamicEncoderDecoder", "EncoderDecoder"])
class DynamicEncoderDecoder(nn.Module):
    """``fused_loss``: None (default) routes plain-CE losses through
    ``fused_resize_ce`` whenever its gate passes — its CUDA kernels for CUDA
    tensors, their plain torch versions on the CPU; False always takes the
    unfused ``F.interpolate`` + CE chain."""

    def __init__(self, backbone: Dict[str, Any], decode_head: Dict[str, Any],
                 neck: Optional[Dict[str, Any]] = None,
                 auxiliary_head: Any = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None,
                 fused_loss: Optional[bool] = None):
        super().__init__()
        self.backbone = build_backbone(backbone)
        chans = self.backbone.out_channels()
        self.neck = build_neck(neck, chans) if neck else None
        if self.neck is not None:
            chans = self.neck.out_channels()
        self.decode_head = build_head(decode_head, chans)
        aux = [] if auxiliary_head is None else (
            list(auxiliary_head) if isinstance(auxiliary_head, (list, tuple))
            else [auxiliary_head])
        if len(aux) == 1:
            self.auxiliary_head = build_head(aux[0], chans)
        elif aux:
            self.auxiliary_head = nn.ModuleList(
                [build_head(c, chans) for c in aux])
        else:
            self.auxiliary_head = None
        self.loss_decode = build_loss(dict(
            decode_head.get("loss_decode") or {"type": "CrossEntropyLoss"}))
        self.aux_losses = [build_loss(dict(
            c.get("loss_decode") or {"type": "CrossEntropyLoss"}))
            for c in aux]
        self.test_cfg = dict(test_cfg or {"mode": "whole"})
        self.fused_loss = fused_loss
        self.num_classes = int(decode_head["num_classes"])
        self.align_corners = bool(decode_head.get("align_corners", False))

    def aux_heads(self):
        if self.auxiliary_head is None:
            return []
        if isinstance(self.auxiliary_head, nn.ModuleList):
            return list(self.auxiliary_head)
        return [self.auxiliary_head]

    # ------------------------------------------------------------------ #
    def extract_feat(self, img: torch.Tensor, arch: Dict[str, Any]):
        feats = self.backbone(img, arch["backbone"])
        return self.neck(feats) if self.neck is not None else feats

    def encode_decode(self, img: torch.Tensor,
                      arch: Dict[str, Any]) -> torch.Tensor:
        """Decode-head logits resized to input resolution ``[N,C,H,W]``."""
        logit = self.decode_head(self.extract_feat(img, arch))
        return resize_bilinear(logit, img.shape[2:], self.align_corners)

    def forward(self, img: torch.Tensor, arch: Dict[str, Any]) -> torch.Tensor:
        return self.encode_decode(img, arch)

    # ------------------------------------------------------------------ #
    def forward_train(self, img: torch.Tensor, gt: torch.Tensor,
                      arch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, {name: loss}). ``gt`` is ``[N,H,W]`` with 255
        ignore; ``generator`` draws the heads' dropout."""
        feats = self.extract_feat(img, arch)
        label_hw = tuple(gt.shape[1:3])
        gt = gt.to(torch.int32).contiguous()
        losses = {"decode.loss_seg": self._seg_loss(
            self.decode_head(feats, generator), gt, label_hw,
            self.loss_decode)}
        for i, (head, loss_fn) in enumerate(zip(self.aux_heads(),
                                                self.aux_losses)):
            losses[f"aux_{i}.loss_seg"] = self._seg_loss(
                head(feats, generator), gt, label_hw, loss_fn)
        return sum(losses.values()), losses

    def _seg_loss(self, logit: torch.Tensor, gt: torch.Tensor, label_hw,
                  loss_fn) -> torch.Tensor:
        plain_ce = isinstance(loss_fn, CrossEntropyLoss) \
            and loss_fn.avg_non_ignore
        if self.fused_loss is not False and plain_ce and \
                supports_fused_resize_ce(tuple(logit.shape[2:]), label_hw,
                                         self.align_corners):
            return loss_fn.loss_weight * fused_resize_ce(logit, gt, label_hw,
                                                         255)
        up = resize_bilinear(logit, label_hw, self.align_corners)
        return loss_fn(up, gt)

    # ------------------------------------------------------------------ #
    def whole_inference(self, img: torch.Tensor,
                        arch: Dict[str, Any]) -> torch.Tensor:
        if self.training:
            raise RuntimeError("inference needs eval mode (model.eval()): "
                               "train mode would update BN running stats")
        return self.encode_decode(img, arch)

    def simple_test(self, img: torch.Tensor, arch: Dict[str, Any],
                    flip: bool = False) -> torch.Tensor:
        """Per-pixel class ``[N,H,W]`` (argmax of the logits, which equals
        the argmax of the softmax)."""
        if flip or self.test_cfg.get("mode", "whole") != "whole":
            raise NotImplementedError(
                "slide inference and flip TTA wait for a later slice")
        return self.whole_inference(img, arch).argmax(dim=1)
