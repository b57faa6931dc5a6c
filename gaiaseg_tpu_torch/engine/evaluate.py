"""Whole-mode evaluation of supernet subnets (mIoU per arch).

The slice of ``gaiaseg_tpu/engine/evaluate.py:63-127`` that serves the
trained supernet at the val anchors: each arch runs ``simple_test`` over
the dataset, read in order through a ``BatchLoader`` (the last batch padded
by wrapping, its padded records' labels set to 255) and a prefetch thread
that uploads and normalizes the next batches on a side stream; the
confusion matrix accumulates on the device in a ``SegEvaluator``. A
device-cached val set is read in place (``gather_prepare_eval_batch``).
Slide mode, TTA and population eval wait for a later slice.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..data.device_cache import DeviceCachedDataset
from ..data.loader import BatchLoader, device_prefetch
from ..data.metrics import SegEvaluator
from ..data.staging import DeviceFeed, take
from ..data.transforms import gather_prepare_eval_batch, prepare_eval_batch
from ..utils.device import resolve_device
from .train import autocast


@torch.no_grad()
def evaluate_arch(model, dataset, arch: Dict[str, Any], norm: Dict[str, Any],
                  device: torch.device, batch_size: int = 1
                  ) -> Dict[str, Any]:
    """mIoU of ``model`` at ``arch`` over ``dataset`` (model in eval mode):
    ``SegEvaluator.evaluate()`` plus the ``confusion`` matrix (numpy
    [C, C], rows = gt). ``norm`` holds the Normalize ``mean`` and ``std``."""
    device = resolve_device(device)
    cache = dataset if isinstance(dataset, DeviceCachedDataset) else None
    loader = BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                         index_only=cache is not None)
    feed = DeviceFeed(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    consts = {}

    def prep(batch):
        pad = int(batch.get("pad_count", 0))
        with feed.side_stream():
            if not consts:
                consts.update(mean=torch.tensor(norm["mean"], device=device),
                              std=torch.tensor(norm["std"], device=device))
            mean, std = consts["mean"], consts["std"]
            if cache is not None:
                idx = feed.upload({"idx": np.asarray(batch["idx"],
                                                     np.int64)})["idx"]
                img, gt = gather_prepare_eval_batch(
                    cache.imgs, cache.gts, idx, mean, std, pad=pad,
                    dtype=dtype)
            else:
                dev = feed.upload({"img": np.asarray(batch["img"]),
                                   "gt": np.asarray(batch["gt"])})
                img = prepare_eval_batch(dev["img"], mean, std, dtype=dtype)
                gt = dev["gt"].to(torch.int32)
                if pad:     # wrapped tail records: their labels are ignored
                    gt[gt.shape[0] - pad:] = 255
            return img, gt, feed.done()

    evaluator = SegEvaluator(model.num_classes,
                             getattr(dataset, "CLASSES", None))
    batches = device_prefetch(iter(loader), prep)
    try:
        for img, gt, ready in batches:
            take((img, gt), ready)
            with autocast(device):
                pred = model.simple_test(img, arch)
            evaluator.update(pred, gt)
    finally:
        batches.close()
    return dict(evaluator.evaluate(), confusion=evaluator.confusion())
