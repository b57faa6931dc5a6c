from .datasets import SyntheticDataset, build_dataset
from .metrics import confusion_matrix, iou_from_confusion

__all__ = ["SyntheticDataset", "build_dataset", "confusion_matrix",
           "iou_from_confusion"]
