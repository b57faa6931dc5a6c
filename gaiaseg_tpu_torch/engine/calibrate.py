"""BN calibration: reset and re-estimate the running statistics of a subnet.

Port of ``gaiaseg_tpu/engine/calibrate.py``. Under weight sharing, each
subnet's BN statistics differ from the supernet's mixture, and the train
loop's silent steps leave them alone between log boundaries; re-estimating
them for the arch at hand before eval and checkpoint recovers them.

The statistics are the ``running_mean`` / ``running_var`` buffers of the
model's ``DynBatchNorm`` modules. ``calibrate_bn`` resets them (means 0,
variances 1, except the frozen teacher's), runs k forward passes in train
mode under ``torch.no_grad()`` on train records read through a shuffled
``BatchLoader`` and normalized with the test pipeline's mean and std, then
divides out the ``1 - d^k`` share of the reset values. The decay ``d`` is
read from the modules (``1 - momentum``), not assumed to be 0.9.

BN modules that stay in eval mode under ``model.train()`` (a backbone
with ``norm_eval``) normalize with their running statistics and never
re-estimate them, so calibration keeps theirs. The JAX package resets
them to (0, 1) first and so leaves them there (ROADMAP C11).

Across ranks, data index 0 calibrates alone (its data collectives off;
under tensor parallelism its K model ranks calibrate together, gathering
their sharded weights) on the records one process would read, and every
rank takes its statistics by broadcast over the data axis, so all ranks
hold the one-process statistics bit for bit.
"""
from __future__ import annotations

from typing import Collection, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.device_cache import DeviceCachedDataset
from ..data.loader import BatchLoader
from ..data.pipeline_cfg import TestPipelineParams
from ..data.transforms import gather_prepare_eval_batch, prepare_eval_batch
from ..ops.dynamic_layers import DynBatchNorm
from ..parallel.distributed import (broadcast_tensors, data_parallel,
                                    local_only)
from .numerics import autocast

# The distiller's frozen teacher: its statistics are trained values that
# its eval-mode forward reads and never re-estimates, so a reset would
# lose them for good.
FROZEN_STAT_PREFIXES: Tuple[str, ...] = ("t_backbone", "t_neck",
                                         "t_decode_head")

BNStats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def bn_modules(model, skip_prefixes: Tuple[str, ...] = (),
               held: Collection[DynBatchNorm] = ()
               ) -> List[Tuple[str, DynBatchNorm]]:
    """``(name, module)`` of every ``DynBatchNorm`` outside the subtrees
    whose top-level name is in ``skip_prefixes`` and not in ``held``."""
    held_ids = {id(m) for m in held}
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, DynBatchNorm) and id(m) not in held_ids
            and name.split(".", 1)[0] not in skip_prefixes]


def bn_decay(model) -> float:
    """The EMA decay of the model's BN statistics, ``1 - momentum``; raises
    when the modules disagree."""
    momenta = {float(m.momentum) for _, m in bn_modules(model)}
    if len(momenta) != 1:
        raise ValueError(f"BN modules have different momenta {momenta}: "
                         "one decay cannot debias them all")
    return 1.0 - momenta.pop()


def bn_stats(model) -> BNStats:
    """A copy of every ``DynBatchNorm``'s running statistics."""
    return {name: (m.running_mean.clone(), m.running_var.clone())
            for name, m in bn_modules(model)}


@torch.no_grad()
def load_bn_stats(model, stats: BNStats) -> None:
    """Copy ``stats`` (from ``bn_stats``) back into the modules."""
    for name, m in bn_modules(model):
        mean, var = stats[name]
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)


@torch.no_grad()
def reset_bn_stats(model, skip_prefixes: Tuple[str, ...] =
                   FROZEN_STAT_PREFIXES,
                   held: Collection[DynBatchNorm] = ()) -> None:
    """Means 0, variances 1, except the frozen teacher's and ``held``."""
    for _, m in bn_modules(model, skip_prefixes, held):
        m.running_mean.zero_()
        m.running_var.fill_(1.0)


@torch.no_grad()
def debias_bn_stats(model, decay: float, num_batches: int,
                    skip_prefixes: Tuple[str, ...] = FROZEN_STAT_PREFIXES,
                    held: Collection[DynBatchNorm] = ()) -> None:
    """Remove the reset values' share from the EMA after ``num_batches``
    updates at ``decay`` (``_debias_stats`` of the JAX package).

    After the reset and k updates the statistic is ``d^k * init + (1 - d^k)
    * EW(batch stats)``; dividing out ``1 - d^k`` (after taking away the
    variance's ``d^k * 1``) leaves the weighted average of the batch
    statistics. Channels that were never updated stay at (0, 1)."""
    q = float(decay) ** int(num_batches)
    if q <= 0.0 or q >= 1.0:
        return
    scale = 1.0 - q
    for _, m in bn_modules(model, skip_prefixes, held):
        m.running_mean.div_(scale)
        m.running_var.copy_(torch.clamp((m.running_var - q) / scale,
                                        min=1e-12))


@torch.no_grad()
def calibrate_bn(model, dataset, arch, *, num_batches: int = 16,
                 batch_size: int = 2,
                 test_params: Optional[TestPipelineParams] = None,
                 device: Optional[torch.device] = None, seed: int = 0):
    """Re-estimate ``model``'s BN statistics for ``arch`` from
    ``num_batches`` forward passes in train mode (no parameter changes);
    returns ``model``. The caller keeps the new statistics or puts back the
    ones it saved with ``bn_stats``. ``device`` defaults to the model's.
    Across ranks: data index 0's calibration, broadcast to all."""
    rank, world = data_parallel()
    if world > 1:
        if rank == 0:
            with local_only():
                calibrate_bn(model, dataset, arch, num_batches=num_batches,
                             batch_size=batch_size, test_params=test_params,
                             device=device, seed=seed)
        broadcast_tensors([t for _, m in bn_modules(model)
                           for t in (m.running_mean, m.running_var)])
        return model
    if not bn_modules(model):
        return model       # nothing to re-estimate
    test_params = test_params or TestPipelineParams()
    param = next(model.parameters())
    device = param.device if device is None else device
    decay = bn_decay(model)
    cache = dataset if isinstance(dataset, DeviceCachedDataset) else None
    loader = BatchLoader(dataset, batch_size, shuffle=True, seed=seed,
                         drop_last=True, infinite=True, prefetch=0,
                         index_only=cache is not None)
    # bf16 under autocast on the card; the parameters' type on the CPU
    dtype = torch.bfloat16 if device.type == "cuda" else param.dtype
    mean = torch.tensor(test_params.mean, device=device)
    std = torch.tensor(test_params.std, device=device)
    was_training = model.training
    model.train()
    held = [m for _, m in bn_modules(model) if not m.training]
    reset_bn_stats(model, held=held)
    try:
        batches = iter(loader)
        for _ in range(num_batches):
            batch = next(batches)
            if cache is not None:
                idx = torch.from_numpy(np.asarray(batch["idx"], np.int64))
                img, _ = gather_prepare_eval_batch(
                    cache.imgs, cache.gts, idx.to(device), mean, std,
                    dtype=dtype)
            else:
                img = prepare_eval_batch(
                    torch.from_numpy(np.asarray(batch["img"])).to(device),
                    mean, std, dtype=dtype)
            with autocast(device):
                model(img, arch)
    finally:
        model.train(was_training)
    debias_bn_stats(model, decay, num_batches, held=held)
    return model
