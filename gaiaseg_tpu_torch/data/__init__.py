from .datasets import (ADE20KDataset, CityscapesDataset, CustomDataset,
                       SyntheticDataset, build_dataset, CITYSCAPES_CLASSES,
                       CITYSCAPES_PALETTE)
from .device_cache import DeviceCachedDataset, maybe_device_cache
from .loader import BatchLoader, device_prefetch
from .metrics import SegEvaluator, confusion_matrix, iou_from_confusion
from .packed import PackedDataset, pack_dataset
from .pipeline_cfg import (TestPipelineParams, TrainPipelineParams,
                           parse_test_pipeline, parse_train_pipeline)
from .transforms import (augment_batch, draw_augment_params,
                         fused_resize_crop, gather_augment_batch,
                         gather_prepare_eval_batch, normalize,
                         photometric_distortion, prepare_eval_batch,
                         random_flip, random_scale_crop)

__all__ = [
    "CustomDataset", "CityscapesDataset", "ADE20KDataset",
    "SyntheticDataset", "build_dataset", "DeviceCachedDataset",
    "maybe_device_cache", "BatchLoader", "device_prefetch", "PackedDataset",
    "pack_dataset", "SegEvaluator", "confusion_matrix",
    "iou_from_confusion", "TrainPipelineParams", "TestPipelineParams",
    "parse_train_pipeline", "parse_test_pipeline", "augment_batch",
    "draw_augment_params", "fused_resize_crop", "gather_augment_batch",
    "gather_prepare_eval_batch", "normalize", "photometric_distortion",
    "prepare_eval_batch", "random_flip", "random_scale_crop",
    "CITYSCAPES_CLASSES", "CITYSCAPES_PALETTE",
]
