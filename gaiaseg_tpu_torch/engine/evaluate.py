"""Evaluation: one subnet, the val anchors, a population of subnets.

Port of ``gaiaseg_tpu/engine/evaluate.py``. Each arch runs ``simple_test``
(the ``test_cfg`` mode, whole or slide; ``flip`` adds flip TTA) or, when
the test pipeline declares ``img_ratios``, ``aug_test`` on the normalized
batch rescaled on the device to ``round(h*r)`` x ``round(w*r)`` (bilinear
rescaling commutes with the per-channel normalization). The dataset is read
in order through a ``BatchLoader`` (the last batch padded by wrapping, its
padded records' labels set to 255) and a prefetch thread that uploads and
normalizes the next batches on a side stream; the confusion matrix
accumulates on the device in a ``SegEvaluator``. A device-cached val set is
read in place (``gather_prepare_eval_batch``).

``cross_arch_evaluate`` runs the val sampler's anchors in turn.
``evaluate_population`` reads each batch once and runs every arch of the
population on it, one sliced subnet after another where the JAX package
``vmap``s a stacked arch; each arch may bring its own BN statistics.

Across ranks (JAX ``evaluate.py:91-92, 121-125``) each data index sweeps
its shard of the records (``i::D`` over the D data indices, its own padded
tail ignored; the K model ranks of a data index read the same records)
and the int64 confusion matrices are summed over the data axis, so every
rank returns the one-process metrics exactly; the archs come from rank 0.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.device_cache import DeviceCachedDataset
from ..data.loader import BatchLoader, device_prefetch
from ..data.metrics import SegEvaluator
from ..data.pipeline_cfg import TestPipelineParams
from ..data.staging import DeviceFeed, take
from ..data.transforms import gather_prepare_eval_batch, prepare_eval_batch
from ..models.arch_util import encode_arch
from ..ops.resize import resize_bilinear
from ..parallel.distributed import (all_reduce_sum, broadcast_object,
                                    data_parallel)
from ..utils.device import resolve_device
from .calibrate import BNStats, bn_stats, load_bn_stats
from .numerics import autocast

logger = logging.getLogger("gaiaseg_tpu_torch")


def _ratios(test_params: TestPipelineParams) -> Optional[Tuple[float, ...]]:
    ratios = getattr(test_params, "img_ratios", None)
    ratios = tuple(float(r) for r in ratios) if ratios else None
    return None if ratios == (1.0,) else ratios


def _predict(model, img: torch.Tensor, arch: Dict[str, Any],
            flip: bool = False,
            ratios: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Per-pixel class ``[N,H,W]`` of one normalized batch: ``simple_test``,
    or ``aug_test`` over ``ratios`` (JAX ``make_eval_step``, :32-61)."""
    with autocast(img.device):
        if not ratios:
            return model.simple_test(img, arch, flip)
        h, w = img.shape[2:]
        imgs = [img if abs(r - 1.0) < 1e-6 else
                resize_bilinear(img, (max(int(round(h * r)), 1),
                                      max(int(round(w * r)), 1)), False)
                for r in ratios]
        return model.aug_test(imgs, arch, flip, out_hw=(h, w))


def _eval_batches(dataset, batch_size: int, test_params: TestPipelineParams,
                  device: torch.device) -> Iterator:
    """``(img, gt, n_real)`` batches of ``dataset`` in order (this rank's
    shard), normalized on the device by a prefetch thread; the padded
    tail's labels are 255. The iterator's ``close()`` stops the thread."""
    cache = dataset if isinstance(dataset, DeviceCachedDataset) else None
    rank, world = data_parallel()
    loader = BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                         shard_id=rank, num_shards=world,
                         index_only=cache is not None)
    feed = DeviceFeed(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    consts = {}

    def prep(batch):
        pad = int(batch.get("pad_count", 0))
        with feed.side_stream():
            if not consts:
                consts.update(
                    mean=torch.tensor(test_params.mean, device=device),
                    std=torch.tensor(test_params.std, device=device))
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
            return img, gt, batch_size - pad, feed.done()

    return device_prefetch(iter(loader), prep)


def _result(evaluator: SegEvaluator, device: torch.device) -> Dict[str, Any]:
    """Metrics and confusion matrix, the ranks' matrices summed first."""
    if data_parallel()[1] > 1:
        c = evaluator.num_classes
        cm = evaluator.cm if evaluator.cm is not None else torch.zeros(
            (c, c), dtype=torch.int64, device=device)
        evaluator.cm = all_reduce_sum(cm)
    return dict(evaluator.evaluate(), confusion=evaluator.confusion())


@torch.no_grad()
def evaluate(model, dataset, arch: Dict[str, Any], *,
             test_params: Optional[TestPipelineParams] = None,
             batch_size: int = 1, flip: bool = False,
             max_batches: Optional[int] = None,
             device="cuda") -> Dict[str, Any]:
    """mIoU of ``model`` at ``arch`` over ``dataset``:
    ``SegEvaluator.evaluate()`` plus the ``confusion`` matrix (numpy
    [C, C], rows = gt). ``test_params`` gives the Normalize mean and std
    and the multi-scale ``img_ratios``; ``max_batches`` stops after that
    many batches of real records. The model runs in eval mode and is put
    back in the mode it was in."""
    device = resolve_device(device)
    test_params = test_params or TestPipelineParams()
    ratios = _ratios(test_params)
    evaluator = SegEvaluator(model.num_classes,
                             getattr(dataset, "CLASSES", None))
    was_training = model.training
    model.eval()
    batches = _eval_batches(dataset, batch_size, test_params, device)
    n = 0
    try:
        for img, gt, n_real, ready in batches:
            take((img, gt), ready)
            evaluator.update(_predict(model, img, arch, flip, ratios), gt)
            n += n_real
            if max_batches and n >= max_batches * batch_size:
                break
    finally:
        batches.close()
        model.train(was_training)
    return _result(evaluator, device)


def cross_arch_evaluate(model, val_sampler, dataset,
                        max_arch: Dict[str, Any], *,
                        test_params: Optional[TestPipelineParams] = None,
                        batch_size: int = 1, flip: bool = False,
                        device="cuda") -> Dict[str, Dict[str, Any]]:
    """``evaluate`` at every anchor of ``val_sampler`` (the reference's
    cross-arch eval hook): ``{anchor name: metrics}``, each with its
    ``seconds``."""
    results: Dict[str, Dict[str, Any]] = {}
    for i, meta in enumerate(val_sampler.traverse()):
        meta = broadcast_object(meta)
        name = meta.get("name", val_sampler.anchor_name(i))
        t0 = time.perf_counter()
        metrics = evaluate(model, dataset, encode_arch(max_arch, meta),
                           test_params=test_params, batch_size=batch_size,
                           flip=flip, device=device)
        metrics["seconds"] = time.perf_counter() - t0
        logger.info("cross-arch eval [%s]: mIoU=%.4f aAcc=%.4f (%.1fs)",
                    name, metrics["mIoU"], metrics["aAcc"],
                    metrics["seconds"])
        results[name] = metrics
    return results


@torch.no_grad()
def evaluate_population(model, dataset, archs: Sequence[Dict[str, Any]], *,
                        test_params: Optional[TestPipelineParams] = None,
                        batch_size: int = 1, flip: bool = False,
                        stats: Optional[Sequence[BNStats]] = None,
                        device="cuda") -> List[Dict[str, Any]]:
    """Score every arch of ``archs`` in one pass over ``dataset``: each
    batch is read and normalized once and runs through each subnet in turn.
    ``stats[i]`` (from ``calibrate.bn_stats``) are arch ``i``'s BN
    statistics, loaded before it runs; the model's own are put back at the
    end. Returns one metrics dict per arch, in order, each equal to
    ``evaluate`` of that arch on those statistics.

    The JAX package's depth bucketing (``group_population`` with the
    train-side bucketer) is not ported: it exists to bound the number of
    compiled programs, and the port compiles none."""
    device = resolve_device(device)
    test_params = test_params or TestPipelineParams()
    ratios = _ratios(test_params)
    archs = broadcast_object(list(archs))
    if stats is not None and len(stats) != len(archs):
        raise ValueError(f"{len(stats)} BN statistics for {len(archs)} archs")
    evaluators = [SegEvaluator(model.num_classes,
                               getattr(dataset, "CLASSES", None))
                  for _ in archs]
    own = bn_stats(model) if stats is not None else None
    was_training = model.training
    model.eval()
    batches = _eval_batches(dataset, batch_size, test_params, device)
    try:
        for img, gt, _, ready in batches:
            take((img, gt), ready)
            for i, arch in enumerate(archs):
                if stats is not None:
                    load_bn_stats(model, stats[i])
                evaluators[i].update(_predict(model, img, arch, flip, ratios),
                                     gt)
    finally:
        batches.close()
        if own is not None:
            load_bn_stats(model, own)
        model.train(was_training)
    return [_result(e, device) for e in evaluators]
