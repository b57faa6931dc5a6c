"""Dropout and stochastic depth drawn from an explicit generator.

``F.dropout`` takes no generator, so a run could not replay its draws; both
functions here draw from the caller's ``torch.Generator`` (the train step's,
on the step's device). Across W ranks each rank draws the masks of the
global batch from the shared generator and keeps its own rows, so a
sample's mask is the one a single process at the global batch draws.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.distributed import data_parallel


def _global_bernoulli(x: torch.Tensor, shape, keep: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """A 0/1 mask of ``shape`` (its first axis this rank's batch), drawn
    for the global batch and cut to this rank's rows."""
    rank, world = data_parallel()
    n = shape[0]
    full = x.new_empty((n * world,) + tuple(shape[1:]))
    return full.bernoulli_(keep, generator=generator)[rank * n:(rank + 1) * n]


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout (flax ``nn.Dropout``: kept values scaled by
    ``1 / (1 - p)``)."""
    keep = 1.0 - p
    return x * _global_bernoulli(x, x.shape, keep, generator) / keep


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Per-sample stochastic depth of a residual branch ``x`` (JAX
    ``models/backbones/dynamic_convnext.py`` ``drop_path``): each sample is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``;
    the identity outside training or at rate 0."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return x / keep * _global_bernoulli(x, shape, keep, generator)
