"""Tensor parallelism over the ``model`` mesh axis: shard storage and the
autograd functions that place its collectives.

Under JAX, GSPMD places every collective of a sharded parameter; the port
places them itself. A parameter that ``parallel.mesh.shard_state`` shards
holds only this rank's part of its MAX-shape tensor: along one torch dim,
cut in ``blocks`` equal runs (1, or 3 for the fused ``qkv`` of JAX's
``w_q``/``w_k``/``w_v``), each run split evenly over the K model ranks
(JAX's even split of each leaf). Its ``tp`` attribute (``Shard``) says
where, and by which route the model computes with it:

- ``gather`` (gather-on-use): the module that owns the parameter reads the
  whole MAX-shape weight, all-gathered over the model group at each read
  (``gather_param``), and slices prefixes of it as in one process. Every
  model rank computes the same full gradient there, so the backward keeps
  this rank's slice of it and calls no collective.
- ``column`` / ``row`` (a Megatron pair of ``ElasticEncoderLayer``):
  ``qkv`` and ``fc1`` keep the rows of this rank's heads or FFN features,
  ``proj`` and ``fc2`` the matching input columns. The pair's input passes
  ``copy_to_model`` (identity forward, its gradient summed over the model
  group), its output ``row_linear`` (partial products summed over the
  model group, identity backward): one all-reduce forward and one
  backward per pair. In one process both are the plain layers.

The gather is one ``all_reduce`` of a zero-padded buffer: gloo reduces and
broadcasts CUDA tensors (through the host) but has no other collective for
them, so the model axis uses the same two as the data axis. Adding zeros
is exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .distributed import (model_all_reduce_sum, model_broadcast,
                          model_parallel)


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a sharded parameter's shard lies in its full tensor."""
    dim: int                 # torch dim that is split
    blocks: int              # equal runs along ``dim``, each split K ways
    index: int               # this rank's model index
    size: int                # K
    full_shape: Tuple[int, ...]
    route: str               # 'gather', 'column' or 'row'


def tp_info(p: torch.Tensor) -> Optional[Shard]:
    """The ``Shard`` of a sharded parameter, None for a whole one."""
    return getattr(p, "tp", None)


def shard_of(t: torch.Tensor, dim: int, blocks: int, index: int,
             size: int) -> torch.Tensor:
    """Model index ``index``'s part of the full tensor ``t`` (a view):
    along ``dim``, run ``b`` of ``blocks`` keeps its ``index``-th of
    ``size`` equal pieces."""
    s = t.shape[dim] // (blocks * size)
    return t.unflatten(dim, (blocks, size, s)).select(dim + 1, index) \
        .flatten(dim, dim + 1)


def gather_full(shard: torch.Tensor, info: Shard) -> torch.Tensor:
    """The full tensor from every model rank's ``shard`` (a collective on
    the model group): each rank writes its part into a zero buffer of the
    full shape, and one all-reduce sums the buffers."""
    dim, blocks, k = info.dim, info.blocks, info.size
    s = info.full_shape[dim] // (blocks * k)
    buf = shard.new_zeros(info.full_shape).unflatten(dim, (blocks, k, s))
    buf.select(dim + 1, info.index).copy_(shard.unflatten(dim, (blocks, s)))
    return model_all_reduce_sum(buf).flatten(dim, dim + 2)


class _GatherFromModel(torch.autograd.Function):
    """Forward: the full weight from the shards. Backward: this rank's
    slice of the full gradient (every model rank holds the same one)."""

    @staticmethod
    def forward(ctx, shard, info):
        ctx.info = info
        return gather_full(shard, info)

    @staticmethod
    def backward(ctx, grad):
        i = ctx.info
        return shard_of(grad, i.dim, i.blocks, i.index, i.size) \
            .contiguous(), None


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """The full MAX-shape value of a parameter sharded for gather-on-use
    (differentiable; ``p`` itself when it is whole)."""
    info = tp_info(p)
    return p if info is None else _GatherFromModel.apply(p, info)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the gradients of every
    input summed over the model group in one flat all-reduce (each rank's
    heads or features add their share to the pair's input and to the
    replicated bias the column layer slices)."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = model_all_reduce_sum(torch.cat([g.reshape(-1)
                                               for g in grads]))
        return tuple(v.view_as(g).to(g.dtype) for g, v in zip(
            grads, flat.split([g.numel() for g in grads])))


def copy_to_model(size: int, *tensors: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """The column layer's inputs (the activations and any replicated
    parameter it slices), as they are; under a pair over ``size > 1``
    model ranks their gradients are summed over the model group."""
    return tensors if size == 1 else _CopyToModel.apply(*tensors)


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the partial products summed over the model group;
    the identity backward."""

    @staticmethod
    def forward(ctx, partial):
        return model_all_reduce_sum(partial.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad


def row_linear(size: int, x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The row layer of a pair over ``size`` model ranks: this rank's
    partial product ``x @ weight.T`` summed over the model group in
    float32 at least (bf16 partials under autocast are each rounded once;
    their sum is not rounded again), then ``bias`` once. At ``size`` 1 it
    is ``F.linear(x, weight, bias)``."""
    if size == 1:
        return F.linear(x, weight, bias)
    partial = F.linear(x, weight)
    wide = torch.promote_types(partial.dtype, torch.float32)
    return _ReduceFromModel.apply(partial.to(wide)) + bias


# --------------------------------------------------------------------- #
# gather-on-use: the owner module reads the full weight
# --------------------------------------------------------------------- #
_GATHERING_CLASSES: Dict[Tuple[type, Tuple[str, ...]], type] = {}


def _gathered_property(name: str) -> property:
    def get(self):
        return gather_param(self._parameters[name])
    return property(get, doc=f"``{name}`` all-gathered over the model axis")


def install_gather_on_use(module: nn.Module, names: Sequence[str]) -> None:
    """Make ``module.<name>`` the all-gathered full weight for each of
    ``names`` (the parameters stay the shards: ``named_parameters``,
    ``state_dict`` and the optimizer see the shards). The module's class
    becomes a subclass of its own with one property a name."""
    cls = type(module)
    base = getattr(cls, "_tp_base", cls)
    names = tuple(sorted(set(getattr(cls, "_tp_gathered", ())) | set(names)))
    key = (base, names)
    if key not in _GATHERING_CLASSES:
        ns = {n: _gathered_property(n) for n in names}
        ns.update(_tp_base=base, _tp_gathered=names,
                  __module__=base.__module__, __qualname__=base.__qualname__)
        _GATHERING_CLASSES[key] = type(base.__name__, (base,), ns)
    module.__class__ = _GATHERING_CLASSES[key]


# --------------------------------------------------------------------- #
# the train step's model-axis work
# --------------------------------------------------------------------- #
def sync_replicated_grads(params: Iterable[torch.nn.Parameter]) -> int:
    """Give every model rank model index 0's gradients of the whole
    (replicated) parameters; returns the bytes moved (0 without a mesh of
    K > 1). Each rank computes them from the same inputs, so on the CPU
    they are already equal bit for bit; on the card a kernel that adds by
    atomics (the bilinear resize's backward) may round them otherwise, and
    the K copies of a replicated parameter must not drift apart."""
    if model_parallel()[1] == 1:
        return 0
    grads = [p.grad for p in params
             if p.grad is not None and tp_info(p) is None]
    return model_broadcast(grads)


def grad_sq_norm(params: Sequence[torch.nn.Parameter]) -> torch.Tensor:
    """The squared global norm of the gradients of the whole model: the
    sharded parameters' squared norms summed over the model group, the
    replicated ones counted once. Float32 at least."""
    sharded, whole = [], []
    for p in params:
        if p.grad is not None:
            (sharded if tp_info(p) is not None else whole).append(p.grad)

    def sq(grads):
        wide = [g.to(torch.promote_types(g.dtype, torch.float32))
                for g in grads]
        return torch.stack([torch.linalg.vector_norm(g).square()
                            for g in wide]).sum()
    ref = next(p for p in params if p.grad is not None).grad
    dtype = torch.promote_types(ref.dtype, torch.float32)
    total = torch.zeros((), dtype=dtype, device=ref.device)
    if sharded:     # the same parameters on every model rank
        total = total + model_all_reduce_sum(sq(sharded).to(dtype))
    if whole:
        total = total + sq(whole).to(dtype)
    return total


def is_sharded(model: nn.Module) -> bool:
    return any(tp_info(p) is not None for p in model.parameters())
