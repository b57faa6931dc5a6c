"""Device-resident dataset cache: stage a fixed-shape dataset in the card's
memory once, serve batches as row selects there.

Port of ``gaiaseg_tpu/data/device_cache.py``. For a dataset that fits the
budget (the 32 Cityscapes records of 1024x2048 that ``chip_smoke.py`` packs
are 268 MB; the whole 2975-record train set is 25 GB), uploading it once
takes the host out of the steady-state loop: no read, no copy and no upload
per step. Numerically transparent: ``read_batch(idx)`` returns the pixels
the base dataset would, as device tensors (uint8 images; uint8 labels when
the class ids and ignore=255 fit), and the train loop reads the cache in
place through ``transforms.gather_augment_batch``.
"""
from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger("gaiaseg_tpu_torch")

DEFAULT_BUDGET_GB = 8.0     # GAIASEG_DEVICE_CACHE_GB overrides it


def default_budget_gb() -> float:
    return float(os.environ.get("GAIASEG_DEVICE_CACHE_GB", DEFAULT_BUDGET_GB))


def _record_shape(ds):
    h = getattr(ds, "h", None)
    w = getattr(ds, "w", None)
    c = getattr(ds, "img_c", 3)
    if h is None or w is None:
        rec = ds[0]
        h, w = rec["img"].shape[:2]
        c = rec["img"].shape[2] if rec["img"].ndim == 3 else 1
    return int(h), int(w), int(c)


def _label_fits_u8(gt) -> bool:
    gt = np.asarray(gt)
    return gt.max(initial=0) <= 255 and gt.min(initial=0) >= 0


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def cache_nbytes(ds) -> int:
    """Bytes the cache would allocate: the images' own dtype, labels uint8
    when the first record's fit (as ``DeviceCachedDataset`` stores them)."""
    h, w, c = _record_shape(ds)
    rec0 = ds[0]
    img_isz = np.asarray(rec0["img"]).dtype.itemsize
    gt_np = np.asarray(rec0["gt"])
    gt_isz = 1 if _label_fits_u8(gt_np) else gt_np.dtype.itemsize
    return len(ds) * (h * w * c * img_isz + h * w * gt_isz)


class DeviceCachedDataset:
    """Wraps any fixed-shape record dataset; images and labels live on
    ``device``.

    Labels are stored uint8 when every value fits (trainIds < 256 with
    ignore=255); images keep their dtype (uint8 on the packed path).
    Attribute access (CLASSES, PALETTE, num_classes, ...) goes to the base
    dataset, and so does ``__getitem__`` (a host read, for shape probes), so
    nothing is ever copied back from the device.
    """

    def __init__(self, base, device="cuda", slab_bytes: int = 64 << 20):
        self.base = base
        self.device = torch.device(device)
        n = len(base)
        h, w, c = _record_shape(base)
        rec0 = base[0]
        img_dt = np.asarray(rec0["img"]).dtype
        gt_u8 = _label_fits_u8(rec0["gt"])
        gt_dt = np.uint8 if gt_u8 else np.asarray(rec0["gt"]).dtype
        self.imgs = torch.empty((n, h, w, c), device=self.device,
                                dtype=_torch_dtype(img_dt))
        self.gts = torch.empty((n, h, w), device=self.device,
                               dtype=_torch_dtype(gt_dt))
        step = max(1, int(slab_bytes // max(h * w * c * img_dt.itemsize, 1)))
        read = getattr(base, "read_batch", None)
        for s in range(0, n, step):
            idx = np.arange(s, min(s + step, n))
            if read is not None:
                b = read(idx)
                bi, bg = np.asarray(b["img"]), np.asarray(b["gt"])
            else:
                recs = [base[int(i)] for i in idx]
                bi = np.stack([r["img"] for r in recs])
                bg = np.stack([r["gt"] for r in recs])
            if gt_u8 and bg.dtype != np.uint8:
                if not _label_fits_u8(bg):
                    raise ValueError("label ids exceed uint8 after the first "
                                     "record; disable device_cache")
                bg = bg.astype(np.uint8)
            self.imgs[s:s + len(idx)].copy_(torch.from_numpy(bi))
            self.gts[s:s + len(idx)].copy_(torch.from_numpy(bg))
        logger.info("device cache: %d records (%dx%dx%d) = %.2f GB on %s",
                    n, h, w, c,
                    (self.imgs.nbytes + self.gts.nbytes) / 2 ** 30,
                    self.device)

    # -- dataset protocol ------------------------------------------------ #
    def read_batch(self, indices) -> Dict[str, object]:
        idx = torch.as_tensor(np.asarray(indices, np.int64),
                              device=self.device)
        return {"img": self.imgs.index_select(0, idx),
                "gt": self.gts.index_select(0, idx),
                "idx": np.asarray(indices, np.int64)}

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int):
        return self.base[idx]

    def __getattr__(self, name):
        if name == "base":      # not set yet: no recursion through base
            raise AttributeError(name)
        return getattr(self.base, name)


def maybe_device_cache(ds, flag, device="cuda"):
    """Wrap ``ds`` in a DeviceCachedDataset on ``device`` when ``flag`` asks
    for it and the cache fits the budget (``device_cache: true`` in a
    dataset config uses ``GAIASEG_DEVICE_CACHE_GB``, default 8; a number
    is the budget in GB). A cache over the budget falls back to streaming
    from the host, with a warning, instead of running the card out of
    memory."""
    if isinstance(flag, str):  # --cfg-options ships strings
        low = flag.strip().lower()
        if low in ("false", "0", "no", "off", ""):
            return ds
        if low in ("true", "1", "yes", "on"):
            flag = True
        else:
            try:
                flag = float(low)
            except ValueError:
                raise ValueError(
                    f"device_cache={flag!r}: expected true/false or a "
                    "budget in GB (e.g. device_cache=6.0)") from None
    if not flag:
        return ds
    budget = default_budget_gb() if isinstance(flag, bool) else float(flag)
    need = cache_nbytes(ds)
    if need > budget * 2 ** 30:
        logger.warning(
            "device_cache: dataset needs %.2f GB > %.1f GB budget; "
            "streaming from host instead", need / 2 ** 30, budget)
        return ds
    return DeviceCachedDataset(ds, device)
