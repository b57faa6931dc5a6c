"""Whole-mode evaluation of supernet subnets (mIoU per arch).

The slice of ``gaiaseg_tpu/engine/evaluate.py`` that serves the trained
supernet at the val anchors: each arch runs ``simple_test`` over the dataset
and accumulates a confusion matrix on the device. Slide mode, TTA and
population eval wait for a later slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..data.metrics import confusion_matrix, iou_from_confusion
from ..utils.device import resolve_device
from .train import autocast, prepare_batch


@torch.no_grad()
def evaluate_arch(model, dataset, arch: Dict[str, Any], norm: Dict[str, Any],
                  device: torch.device, batch_size: int = 1) -> Dict[str, Any]:
    """mIoU of ``model`` at ``arch`` over ``dataset`` (model in eval mode)."""
    device = resolve_device(device)
    cm = torch.zeros(model.num_classes, model.num_classes, dtype=torch.int64,
                     device=device)
    for i in range(0, len(dataset), batch_size):
        samples = [dataset[k] for k in
                   range(i, min(i + batch_size, len(dataset)))]
        img, gt = prepare_batch(samples, norm, device)
        with autocast(device):
            pred = model.simple_test(img, arch)
        cm += confusion_matrix(pred, gt, model.num_classes)
    return iou_from_confusion(cm.cpu().numpy())
