"""mIoU via a confusion matrix accumulated on the device.

Port of ``confusion_matrix``, ``iou_from_confusion`` and ``SegEvaluator``
from ``gaiaseg_tpu/data/metrics.py``: one ``[C, C]`` count per batch on the
device; only the small matrix reaches the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """``[C, C]`` int64 (rows = gt, cols = pred); 255-ignored pixels
    dropped, predictions clipped to ``[0, C)``."""
    valid = label != 255
    gt = label[valid].long()
    pr = pred[valid].long().clamp(0, num_classes - 1)
    return torch.bincount(gt * num_classes + pr,
                          minlength=num_classes * num_classes
                          )[:num_classes * num_classes].reshape(
                              num_classes, num_classes)


def iou_from_confusion(cm) -> Dict[str, np.ndarray]:
    cm = np.asarray(cm, np.float64)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    gt_total = cm.sum(1)
    iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
    acc = np.where(gt_total > 0, inter / np.maximum(gt_total, 1), np.nan)
    return {
        "IoU": iou,
        "Acc": acc,
        "mIoU": float(np.nanmean(iou)),
        "mAcc": float(np.nanmean(acc)),
        "aAcc": float(inter.sum() / max(cm.sum(), 1)),
    }


class SegEvaluator:
    """Streaming evaluator: feed (pred, label) batches, read mIoU at the end
    (mmseg ``dataset.evaluate(results, metric='mIoU')``). The matrix stays
    on the device of the first batch until ``evaluate``."""

    def __init__(self, num_classes: int,
                 class_names: Optional[Sequence[str]] = None):
        self.num_classes = num_classes
        self.class_names = class_names
        self.reset()

    def update(self, pred: torch.Tensor, label: torch.Tensor) -> None:
        cm = confusion_matrix(pred, label, self.num_classes)
        self.cm = cm if self.cm is None else self.cm + cm

    def confusion(self) -> np.ndarray:
        if self.cm is None:
            return np.zeros((self.num_classes, self.num_classes), np.int64)
        return self.cm.cpu().numpy()

    def evaluate(self, metric: str = "mIoU") -> Dict[str, float]:
        res = iou_from_confusion(self.confusion())
        out = {"mIoU": res["mIoU"], "mAcc": res["mAcc"], "aAcc": res["aAcc"]}
        if self.class_names:
            for name, v in zip(self.class_names, res["IoU"]):
                out[f"IoU.{name}"] = float(v)
        return out

    def reset(self) -> None:
        self.cm: Optional[torch.Tensor] = None
