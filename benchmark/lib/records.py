"""Dataset records made from the seed: the benchmark's generator.

The logic of the port's ``SyntheticDataset`` (piecewise-constant label
maps, an image of class-dependent colours plus noise), drawn on the card in
a few calls: the label map is a grid of ``cell`` x ``cell`` pixel cells,
each a class drawn uniformly, a share ``ignore_share`` of them the ignore
label 255. With ``zero_label`` the raw labels run 0..C (ADE20K's layout,
0 "other") and are read as a dataset with ``reduce_zero_label`` reads them:
0 -> 255, c -> c - 1. Images are uint8 HxWx3, labels uint8 HxW, on the host.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .weights import RECORDS_STREAM, stream_seed

SLAB = 16     # records drawn in one call


def make_records(n: int, hw: Tuple[int, int], num_classes: int, seed: int,
                 device: torch.device, cell: int = 64,
                 ignore_share: float = 0.1, zero_label: bool = False,
                 stream: int = RECORDS_STREAM
                 ) -> Tuple[np.ndarray, np.ndarray]:
    h, w = int(hw[0]), int(hw[1])
    gh, gw = -(-h // cell), -(-w // cell)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    raw_classes = num_classes + 1 if zero_label else num_classes
    idx = torch.arange(raw_classes, device=device)
    colors = torch.stack([(idx * 29) % 255, (idx * 53) % 255,
                          (idx * 97) % 255], -1).to(torch.int16)
    imgs = np.empty((n, h, w, 3), np.uint8)
    gts = np.empty((n, h, w), np.uint8)
    for lo in range(0, n, SLAB):
        k = min(SLAB, n - lo)
        grid = torch.randint(0, raw_classes, (k, gh, gw), generator=gen,
                             device=device)
        ignore = torch.rand((k, gh, gw), generator=gen,
                            device=device) < ignore_share
        raw = grid.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
        raw = raw[:, :h, :w]
        noise = torch.randint(-20, 20, (k, h, w, 3), generator=gen,
                              device=device, dtype=torch.int16)
        img = (colors[raw] + noise).clamp_(0, 255).to(torch.uint8)
        if zero_label:
            gt = torch.where(raw == 0, 255, raw - 1)
        else:
            gt = raw
        ign = ignore.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
        gt = torch.where(ign[:, :h, :w], 255, gt).to(torch.uint8)
        imgs[lo:lo + k] = img.cpu().numpy()
        gts[lo:lo + k] = gt.cpu().numpy()
    return imgs, gts


class Records:
    """A fixed-shape record dataset over host arrays (the protocol the
    port's loaders and ``DeviceCachedDataset`` read)."""

    def __init__(self, imgs: np.ndarray, gts: np.ndarray, num_classes: int):
        self.imgs, self.gts = imgs, gts
        self.h, self.w, self.img_c = imgs.shape[1:4]
        self.num_classes = int(num_classes)
        self.CLASSES = tuple(f"class_{i}" for i in range(num_classes))
        self.PALETTE = None
        self.ignore_index = 255

    def __len__(self) -> int:
        return len(self.imgs)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {"img": self.imgs[i], "gt": self.gts[i], "idx": int(i)}

    def read_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        return {"img": self.imgs[idx], "gt": self.gts[idx], "idx": idx}
