"""Datasets of the port: the synthetic dataset only.

``SyntheticDataset`` is a copy of the class in
``gaiaseg_tpu/data/datasets.py:169-204`` (same seeds, same samples). File
datasets (Cityscapes, ADE20K) need the augmentation pipeline, which waits
for the port's data-pipeline slice: building one raises.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ..utils.registry import DATASETS


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


def build_dataset(cfg: Dict[str, Any]):
    cfg = dict(cfg)
    cfg.pop("pipeline", None)
    if cfg.get("type") not in DATASETS:
        raise NotImplementedError(
            f"dataset {cfg.get('type')!r} needs the data pipeline, which "
            "waits for the port's data-pipeline slice; train on "
            "SyntheticDataset (--cfg-options data.train.type=SyntheticDataset)")
    return DATASETS.build(cfg)
