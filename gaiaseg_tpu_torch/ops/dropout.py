"""Dropout and stochastic depth drawn from an explicit generator.

``F.dropout`` takes no generator, so a run could not replay its draws; the
functions here draw their masks (``global_bernoulli``, which EQL's loss
uses too) from the caller's ``torch.Generator`` (the train step's, on the
step's device). Across the D indices of the data axis each rank draws
the masks of the global batch from the shared generator and keeps its data
index's rows, so a sample's mask is the one a single process at the global
batch draws, and the K model ranks of a data index draw the same one.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.distributed import data_parallel
from ..utils.tracing import region


def global_bernoulli(x: torch.Tensor, shape, keep: float,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """A 0/1 mask of ``shape`` in ``x``'s dtype and device (its first axis
    this rank's batch), drawn for the global batch and cut to this rank's
    rows: 1 where a uniform draw in [0, 1) is below ``keep``, as JAX's
    ``bernoulli``, so every value is kept at ``keep`` 1 and none at 0
    (``bernoulli_`` on CUDA compares a draw in (0, 1] and drops about one
    value in 2^24 at ``keep`` 1)."""
    rank, world = data_parallel()
    n = shape[0]
    u = torch.rand((n * world,) + tuple(shape[1:]), generator=generator,
                   device=x.device, dtype=x.dtype)
    return (u[rank * n:(rank + 1) * n] < keep).to(x.dtype)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout (flax ``nn.Dropout``: kept values scaled by
    ``1 / (1 - p)``)."""
    keep = 1.0 - p
    return x * global_bernoulli(x, x.shape, keep, generator) / keep


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Per-sample stochastic depth of a residual branch ``x`` (JAX
    ``models/backbones/dynamic_convnext.py`` ``drop_path``): each sample is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``;
    the identity outside training or at rate 0. The draw and the scaling
    run under ``region("drop_path")``."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    with region("drop_path"):
        return x / keep * global_bernoulli(x, shape, keep, generator)
