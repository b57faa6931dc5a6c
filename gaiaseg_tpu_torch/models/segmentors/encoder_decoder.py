"""DynamicEncoderDecoder: the supernet segmentor.

Port of ``gaiaseg_tpu/models/segmentors/encoder_decoder.py``: backbone
(-> neck) -> decode head (+ aux heads, which read the neck's outputs too),
losses of logits resized to label size, and inference in the config's
``test_cfg`` mode (whole or slide) with flip and multi-scale TTA. The train
step's mode is ``forward_train`` with ``compute_acc=False``
(``engine/train.py:97`` of the JAX package); ``compute_acc=True`` also logs
each head's pixel accuracy, from logits resized to label size.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.cuda.resize_ce import fused_resize_ce, supports_fused_resize_ce
from ...ops.resize import resize_bilinear
from ...utils.registry import SEGMENTORS
from ..builder import build_backbone, build_head, build_loss, build_neck
from ..losses.cross_entropy import CrossEntropyLoss
from ..losses.dice_focal import pixel_accuracy


def _call_loss(loss_fn, logits: torch.Tensor, gt: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """``loss_fn(logits, gt)``, with the step's ``generator`` for a loss
    that draws (``takes_generator``)."""
    if getattr(loss_fn, "takes_generator", False):
        return loss_fn(logits, gt, generator=generator)
    return loss_fn(logits, gt)


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
    def extract_feat(self, img: torch.Tensor, arch: Dict[str, Any],
                     generator: Optional[torch.Generator] = None):
        """The backbone's (or neck's) features; ``generator`` draws the
        backbone's stochastic depth and token dropout in training."""
        feats = self.backbone(img, arch["backbone"], generator)
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
                      generator: Optional[torch.Generator] = None,
                      compute_acc: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, {name: loss}). ``gt`` is ``[N,H,W]`` with 255
        ignore; ``generator`` draws the heads' dropout and the backbone's
        stochastic depth and token dropout. ``compute_acc``
        (JAX ``encoder_decoder.py:114-151``): every head's logits are
        resized to label size, its loss taken unfused and its
        ``{head}.acc_seg`` logged; the total sums the losses only."""
        feats = self.extract_feat(img, arch, generator)
        _, losses = self._head_losses(feats, gt, generator, compute_acc)
        return sum(v for k, v in losses.items() if "loss" in k), losses

    def _head_losses(self, feats: List[torch.Tensor], gt: torch.Tensor,
                     generator: Optional[torch.Generator],
                     compute_acc: bool,
                     acc_heads: Optional[Tuple[str, ...]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the decode head's logits at their own size, {name: loss}) of
        the decode head and the aux heads, in that order. With
        ``compute_acc`` each head named in ``acc_heads`` (every head when
        None) has its logits resized to label size, its loss taken unfused
        and its ``{head}.acc_seg`` logged; the others go through
        ``_seg_loss``."""
        label_hw = tuple(gt.shape[1:3])
        gt = gt.to(torch.int32).contiguous()
        heads = [("decode", self.decode_head, self.loss_decode)] + [
            (f"aux_{i}", head, loss_fn) for i, (head, loss_fn) in
            enumerate(zip(self.aux_heads(), self.aux_losses))]
        losses, dec = {}, None
        for name, head, loss_fn in heads:
            logit = head(feats, generator)
            dec = logit if dec is None else dec
            if compute_acc and (acc_heads is None or name in acc_heads):
                up = resize_bilinear(logit, label_hw, self.align_corners)
                losses[f"{name}.loss_seg"] = _call_loss(loss_fn, up, gt,
                                                        generator)
                losses[f"{name}.acc_seg"] = pixel_accuracy(up, gt)
            else:
                losses[f"{name}.loss_seg"] = self._seg_loss(
                    logit, gt, label_hw, loss_fn, generator)
        return dec, losses

    def _seg_loss(self, logit: torch.Tensor, gt: torch.Tensor, label_hw,
                  loss_fn, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """``loss_fn`` of the logits resized to label size: a plain CE
        through ``fused_resize_ce`` when its gate passes, any other loss
        unfused. A loss that draws (EQL) gets ``generator``."""
        plain_ce = (isinstance(loss_fn, CrossEntropyLoss)
                    and not loss_fn.use_sigmoid
                    and loss_fn.class_weight is None
                    and loss_fn.reduction == "mean"
                    and loss_fn.avg_non_ignore)
        if self.fused_loss is not False and plain_ce and \
                supports_fused_resize_ce(tuple(logit.shape[2:]), label_hw,
                                         self.align_corners):
            return loss_fn.loss_weight * fused_resize_ce(logit, gt, label_hw,
                                                         255)
        up = resize_bilinear(logit, label_hw, self.align_corners)
        return _call_loss(loss_fn, up, gt, generator)

    # ------------------------------------------------------------------ #
    def _check_eval(self) -> None:
        if self.training:
            raise RuntimeError("inference needs eval mode (model.eval()): "
                               "train mode would update BN running stats")

    def whole_inference(self, img: torch.Tensor,
                        arch: Dict[str, Any]) -> torch.Tensor:
        self._check_eval()
        return self.encode_decode(img, arch)

    def slide_inference(self, img: torch.Tensor, arch: Dict[str, Any],
                        crop_size: Tuple[int, int],
                        stride: Tuple[int, int]) -> torch.Tensor:
        """float32 ``[N,C,H,W]`` logits averaged over mmseg's window grid
        (JAX ``encoder_decoder.py:189-247``). All windows of the batch run
        as one forward; the overlaps add in window order on a float32
        canvas and are divided by their cover count (true division, as the
        reference's ``preds / count_mat``). Adding zeros is exact, so this
        equals the JAX package's cell-by-cell sums bit for bit."""
        self._check_eval()
        n, _, h, w = img.shape
        h_crop, w_crop = min(int(crop_size[0]), h), min(int(crop_size[1]), w)
        h_stride, w_stride = int(stride[0]), int(stride[1])
        h_grids = max(h - h_crop + h_stride - 1, 0) // h_stride + 1
        w_grids = max(w - w_crop + w_stride - 1, 0) // w_stride + 1
        origins = [(min(i * h_stride, h - h_crop), min(j * w_stride,
                                                        w - w_crop))
                   for i in range(h_grids) for j in range(w_grids)]
        crops = torch.cat([img[:, :, y0:y0 + h_crop, x0:x0 + w_crop]
                           for y0, x0 in origins], dim=0)
        logits = self.encode_decode(crops, arch)
        logits = logits.reshape(len(origins), n, *logits.shape[1:])
        canvas = logits.new_zeros((n, logits.shape[2], h, w),
                                  dtype=torch.float32)
        count = torch.zeros((1, 1, h, w), device=img.device)
        for k, (y0, x0) in enumerate(origins):
            canvas[:, :, y0:y0 + h_crop, x0:x0 + w_crop] += logits[k]
            count[:, :, y0:y0 + h_crop, x0:x0 + w_crop] += 1
        return canvas / count

    def _mode_logits(self, img: torch.Tensor,
                     arch: Dict[str, Any]) -> torch.Tensor:
        """The ``test_cfg`` mode's logits (whole or slide)."""
        if self.test_cfg.get("mode", "whole") == "slide":
            return self.slide_inference(img, arch,
                                        tuple(self.test_cfg["crop_size"]),
                                        tuple(self.test_cfg["stride"]))
        return self.whole_inference(img, arch)

    def inference(self, img: torch.Tensor, arch: Dict[str, Any],
                  flip: bool = False) -> torch.Tensor:
        """float32 softmax probabilities ``[N,C,H,W]``; ``flip`` averages
        them with those of the horizontally flipped input, flipped back."""
        prob = torch.softmax(self._mode_logits(img, arch).float(), dim=1)
        if flip:
            flipped = self._mode_logits(img.flip(-1), arch)
            prob = (prob + torch.softmax(flipped.float(), dim=1).flip(-1)) / 2
        return prob

    def simple_test(self, img: torch.Tensor, arch: Dict[str, Any],
                    flip: bool = False) -> torch.Tensor:
        """Per-pixel class ``[N,H,W]``. Without flip, the argmax of the
        logits (which equals the argmax of the softmax)."""
        if not flip:
            return self._mode_logits(img, arch).argmax(dim=1)
        return self.inference(img, arch, flip).argmax(dim=1)

    def aug_test(self, imgs: Sequence[torch.Tensor], arch: Dict[str, Any],
                 flip: bool = False,
                 out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Multi-scale (+ flip) TTA: the probabilities of each rescaled
        input, resized back to ``out_hw`` (default: the first input's
        size), averaged; per-pixel class ``[N,H,W]``."""
        base_hw = tuple(out_hw) if out_hw is not None \
            else tuple(imgs[0].shape[2:])
        prob = None
        for im in imgs:
            p = self.inference(im, arch, flip)
            if tuple(p.shape[2:]) != base_hw:
                p = resize_bilinear(p, base_hw, self.align_corners)
            prob = p if prob is None else prob + p
        return (prob / len(imgs)).argmax(dim=1)
