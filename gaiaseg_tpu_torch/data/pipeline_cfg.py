"""Translate mmcv-style pipeline config lists into fused-augmentation params.

A copy of ``gaiaseg_tpu/data/pipeline_cfg.py``. The reference declares
its pipeline as a list of op dicts (reference
configs/_dynamic_/models/pspnet_ar50to101v2_gsync.py:60-93):
LoadImageFromFile, LoadAnnotations, Resize, RandomCrop, RandomFlip,
PhotoMetricDistortion, Normalize, Pad, MultiScaleFlipAug... This module keeps
that config surface as the compatibility contract (SURVEY.md §5) while the
execution is the fused on-device pipeline in ``data/transforms.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


@dataclass
class TrainPipelineParams:
    crop_size: Tuple[int, int] = (512, 1024)
    ratio_range: Tuple[float, float] = (1.0, 1.0)
    img_scale: Optional[Tuple[int, int]] = None   # (w, h) mmcv order
    keep_ratio: bool = True
    cat_max_ratio: float = 1.0
    flip_prob: float = 0.0
    photometric: bool = False
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD
    seg_pad_val: int = 255


@dataclass
class TestPipelineParams:
    img_scale: Optional[Tuple[int, int]] = None   # (w, h) mmcv order
    flip: bool = False
    # multi-scale TTA ratios (MultiScaleFlipAug img_ratios, reference pspnet
    # config :76-93); None/(1.0,) = single scale
    img_ratios: Optional[Tuple[float, ...]] = None
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD


def parse_train_pipeline(pipeline: Sequence[Dict[str, Any]]
                         ) -> TrainPipelineParams:
    p = TrainPipelineParams()
    for op in pipeline or []:
        t = op.get("type")
        if t == "Resize":
            if op.get("img_scale"):
                p.img_scale = tuple(op["img_scale"])
            p.ratio_range = tuple(op.get("ratio_range", (1.0, 1.0)))
            p.keep_ratio = bool(op.get("keep_ratio", True))
        elif t == "RandomCrop":
            p.crop_size = tuple(op["crop_size"])
            p.cat_max_ratio = float(op.get("cat_max_ratio", 1.0))
        elif t == "RandomFlip":
            p.flip_prob = float(op.get("prob", op.get("flip_ratio", 0.5)) or 0)
        elif t == "PhotoMetricDistortion":
            p.photometric = True
        elif t == "Normalize":
            p.mean = tuple(op.get("mean", IMAGENET_MEAN))
            p.std = tuple(op.get("std", IMAGENET_STD))
        elif t == "Pad":
            p.seg_pad_val = int(op.get("seg_pad_val", 255))
    return p


def parse_test_pipeline(pipeline: Sequence[Dict[str, Any]]
                        ) -> TestPipelineParams:
    p = TestPipelineParams()
    for op in pipeline or []:
        t = op.get("type")
        if t == "MultiScaleFlipAug":
            if op.get("img_scale"):
                scale = op["img_scale"]
                if isinstance(scale, (list, tuple)) and scale and \
                        isinstance(scale[0], (list, tuple)):
                    # explicit multi-scale list -> ratios vs the base scale
                    scales = [tuple(s) for s in scale]
                    base = max(scales, key=lambda s: s[0] * s[1])
                    rs = tuple(round(s[0] / base[0], 4) for s in scales)
                    for s, r in zip(scales, rs):
                        if abs(s[1] / base[1] - r) > 0.01:
                            import logging
                            logging.getLogger("gaiaseg_tpu_torch").warning(
                                "MultiScaleFlipAug scale %s is not "
                                "proportional to base %s; TTA uses the "
                                "WIDTH ratio %.3g for both dims", s, base,
                                r)
                    if len(rs) > 1:
                        p.img_ratios = rs
                    scale = base
                p.img_scale = tuple(scale)
            if op.get("img_ratios"):
                rs = tuple(float(r) for r in op["img_ratios"])
                if len(rs) > 1 or rs != (1.0,):
                    p.img_ratios = rs
            p.flip = bool(op.get("flip", False))
            for sub in op.get("transforms", []):
                if sub.get("type") == "Normalize":
                    p.mean = tuple(sub.get("mean", IMAGENET_MEAN))
                    p.std = tuple(sub.get("std", IMAGENET_STD))
        elif t == "Normalize":
            p.mean = tuple(op.get("mean", IMAGENET_MEAN))
            p.std = tuple(op.get("std", IMAGENET_STD))
    return p
