"""Datasets: Cityscapes / ADE20K / custom-directory / synthetic.

Copies of the classes in ``gaiaseg_tpu/data/datasets.py``: thin host
iterables yielding fixed-shape numpy ``{'img': u8 [H,W,3], 'gt': i32 [H,W],
'idx'}`` records (the same records as the JAX package's, bit for bit). All
augmentation runs on the device (``data/transforms.py``); mIoU is a device
confusion matrix (``data/metrics.py``).
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import DATASETS

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle")

CITYSCAPES_PALETTE = [
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]]

# cityscapes labelId -> trainId (255 = ignore), for raw *_labelIds.png
_CITYSCAPES_LABEL2TRAIN = np.full(256, 255, np.int32)
for _lid, _tid in [(7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5),
                   (19, 6), (20, 7), (21, 8), (22, 9), (23, 10), (24, 11),
                   (25, 12), (26, 13), (27, 14), (28, 15), (31, 16),
                   (32, 17), (33, 18)]:
    _CITYSCAPES_LABEL2TRAIN[_lid] = _tid


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _load_label(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im, np.int32)


@DATASETS.register_module()
class CustomDataset:
    """Directory-scanned segmentation dataset (mmseg CustomDataset contract):
    images under ``img_dir`` with ``img_suffix``, labels under ``ann_dir``
    with ``seg_map_suffix``; trainId labels with 255 ignore."""

    CLASSES: Sequence[str] = ()
    PALETTE = None

    def __init__(self, data_root: str, img_dir: str, ann_dir: Optional[str],
                 img_suffix: str = ".jpg", seg_map_suffix: str = ".png",
                 split: Optional[str] = None, classes: Sequence[str] = None,
                 palette=None, label_map: Optional[np.ndarray] = None,
                 reduce_zero_label: bool = False, pipeline: Any = None,
                 test_mode: bool = False, ignore_index: int = 255, **kw):
        self.data_root = data_root
        self.img_dir = img_dir if osp.isabs(img_dir) else osp.join(
            data_root, img_dir)
        self.ann_dir = None if ann_dir is None else (
            ann_dir if osp.isabs(ann_dir) else osp.join(data_root, ann_dir))
        self.img_suffix = img_suffix
        self.seg_map_suffix = seg_map_suffix
        self.reduce_zero_label = reduce_zero_label
        self.label_map = label_map
        self.ignore_index = ignore_index
        self.pipeline_cfg = pipeline
        if classes:
            self.CLASSES = tuple(classes)
        if palette:
            self.PALETTE = palette
        self.infos = self._scan(split)

    def _scan(self, split: Optional[str]) -> List[Dict[str, str]]:
        infos = []
        if split is not None:
            with open(split if osp.isabs(split)
                      else osp.join(self.data_root, split)) as f:
                stems = [line.strip() for line in f if line.strip()]
            for stem in stems:
                infos.append(self._info_for(stem))
            return infos
        if not osp.isdir(self.img_dir):
            return []
        for root, _, files in sorted(os.walk(self.img_dir)):
            for fn in sorted(files):
                if fn.endswith(self.img_suffix):
                    rel = osp.relpath(osp.join(root, fn), self.img_dir)
                    infos.append(self._info_for(rel[: -len(self.img_suffix)]))
        return infos

    def _info_for(self, stem: str) -> Dict[str, str]:
        info = {"img": osp.join(self.img_dir, stem + self.img_suffix)}
        if self.ann_dir is not None:
            info["ann"] = osp.join(self.ann_dir, stem + self.seg_map_suffix)
        return info

    def __len__(self) -> int:
        return len(self.infos)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        img = _load_image(info["img"])
        if "ann" in info:
            gt = _load_label(info["ann"])
            if self.label_map is not None:
                gt = self.label_map[np.clip(gt, 0, 255)]
            if self.reduce_zero_label:
                gt = np.where(gt == 0, 255, gt - 1).astype(np.int32)
        else:
            gt = np.full(img.shape[:2], self.ignore_index, np.int32)
        return {"img": img, "gt": gt.astype(np.int32), "idx": idx}

    @property
    def num_classes(self) -> int:
        return len(self.CLASSES)


@DATASETS.register_module(name=["CityscapesDataset", "CityscapesDataset19"])
class CityscapesDataset(CustomDataset):
    """19-class Cityscapes (reference dataset_type 'CityscapesDataset19',
    pspnet_ar50to101v2_gsync.py:94). ``*_labelIds.png`` ground truth is
    mapped to trainIds; ``*_labelTrainIds.png`` passes through."""

    CLASSES = CITYSCAPES_CLASSES
    PALETTE = CITYSCAPES_PALETTE

    def __init__(self, data_root: str, img_dir: str = "leftImg8bit/train",
                 ann_dir: Optional[str] = "gtFine/train",
                 img_suffix: str = "_leftImg8bit.png",
                 seg_map_suffix: str = "_gtFine_labelTrainIds.png", **kw):
        label_map = None
        if "labelIds" in seg_map_suffix and "TrainIds" not in seg_map_suffix:
            label_map = _CITYSCAPES_LABEL2TRAIN
        kw.pop("label_map", None)
        super().__init__(data_root, img_dir, ann_dir, img_suffix,
                         seg_map_suffix, label_map=label_map, **kw)


@DATASETS.register_module(name=["ADE20KDataset", "ADEDataset"])
class ADE20KDataset(CustomDataset):
    """150-class ADE20K; labels are 1..150 with 0 ignore
    (``reduce_zero_label=True``)."""

    CLASSES = tuple(f"ade_class_{i}" for i in range(150))

    def __init__(self, data_root: str, img_dir: str = "images/training",
                 ann_dir: Optional[str] = "annotations/training",
                 img_suffix: str = ".jpg", seg_map_suffix: str = ".png",
                 **kw):
        kw.setdefault("reduce_zero_label", True)
        super().__init__(data_root, img_dir, ann_dir, img_suffix,
                         seg_map_suffix, **kw)


@DATASETS.register_module()
class SyntheticDataset:
    """Deterministic random dataset for tests/benchmarks: piecewise-constant
    label maps + correlated images so a model can actually learn."""

    def __init__(self, length: int = 16, size: Tuple[int, int] = (64, 64),
                 num_classes: int = 19, seed: int = 0, cells: int = 4, **kw):
        self.length = length
        self.size = tuple(size)
        self._num_classes = num_classes
        self.seed = seed
        self.cells = cells
        self.CLASSES = tuple(f"class_{i}" for i in range(num_classes))
        self.PALETTE = None
        self.ignore_index = 255

    @property
    def num_classes(self) -> int:
        return self._num_classes

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        h, w = self.size
        grid = rng.randint(0, self._num_classes,
                           (self.cells, self.cells)).astype(np.int32)
        gt = np.kron(grid, np.ones((h // self.cells + 1, w // self.cells + 1),
                                   np.int32))[:h, :w]
        # image = class-dependent color + noise (learnable signal)
        colors = np.stack([(np.arange(self._num_classes) * 29) % 255,
                           (np.arange(self._num_classes) * 53) % 255,
                           (np.arange(self._num_classes) * 97) % 255], -1)
        img = colors[gt] + rng.randint(-20, 20, (h, w, 3))
        return {"img": np.clip(img, 0, 255).astype(np.uint8),
                "gt": gt, "idx": idx}


def build_dataset(cfg: Dict[str, Any], device="cuda"):
    """The dataset of a config dict. ``device_cache: true`` (or a budget in
    GB) stages it on ``device`` when it fits the budget
    (``data/device_cache.py``); the device is touched only then."""
    cfg = dict(cfg)
    cfg.pop("pipeline", None)
    cache = cfg.pop("device_cache", False)
    ds = DATASETS.build(cfg)
    if cache:
        from .device_cache import maybe_device_cache
        ds = maybe_device_cache(ds, cache, device=device)
    return ds
