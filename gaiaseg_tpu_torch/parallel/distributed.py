"""Data parallelism across processes over ``torch.distributed``, and the
process groups of the ``data`` and ``model`` mesh axes.

The counterpart of ``gaiaseg_tpu/parallel/mesh.py:127-199`` under the same
public names. The JAX package runs one program over a mesh whose ``data``
axis spans every device (and every host); the port runs one process per
card, joined by a process group. A run of W ranks at ``samples_per_gpu`` B
computes what one process computes at batch W·B (JAX's ``global_batch``):
the same samples and augmentation draws, the same arch, BN statistics over
the global batch, a loss that is the mean over its valid pixels, gradients
summed over ranks.

Without a process group, or with one of world size 1, nothing here calls a
collective: every function returns its input or the one-process answer.

With a ``data x model`` mesh (``parallel.mesh.make_mesh(model_parallel=K)``,
K > 1) rank ``r`` is data index ``r // K`` and model index ``r % K``, and
each axis has its own subgroup. ``data_parallel()`` is then the data axis's
``(index, size)``, and ``all_reduce_sum``, ``sum_over_ranks``,
``all_reduce_grads`` and ``broadcast_tensors`` reduce over the data group:
the K model ranks of one data index hold the same samples, so a reduction
over every rank would count each sample K times. ``model_parallel()`` and
``model_all_reduce_sum`` / ``model_broadcast`` span the model group (tensor
parallelism, ``parallel/tensor_parallel.py``). Objects (the arch broadcast,
the gathers of eval results) and ``barrier`` keep to every rank.

Transport, by backend: tensor collectives are ``all_reduce`` and
``broadcast`` only, on either axis (the model axis gathers a sharded weight
by one ``all_reduce`` of a zero-padded buffer, ``tensor_parallel.py``).

- ``nccl`` (the card): tensors reduce on the card (a CPU tensor is staged
  through the current card). Python objects travel as pickled uint8
  tensors on the host, through a ``gloo`` group made beside the default one
  at the first use, so a broadcast of an arch never waits on the card's
  queue.
- ``gloo`` (the CPU, or ranks that share one card): objects go through the
  default group on the host; ``all_reduce`` and ``broadcast`` of a CUDA
  tensor are gloo's own, which copy through the host.

``local_only()`` turns the data axis's collectives off for work that one
data index does alone (BN calibration on data index 0); the model axis
stays on, since its K ranks hold one model together.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0
# coalesced gradient buckets: a few collectives a step (the flagship has
# 400+ parameter tensors), none above 64 MB of float32
BUCKET_ELEMS = 1 << 24

# process-wide, as the process group itself is
_objects_group = None   # the host group that carries objects under nccl
_local_depth = 0        # > 0 inside local_only()
_axes = None            # MeshAxes of a data x model mesh with K > 1
# bytes each axis's tensor collectives have moved (a rank's input sizes),
# for the readings of a step; ``reset_traffic`` sets them to 0
TRAFFIC = {"data": 0, "model": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; True when one was made.

    JAX's arguments (``coordinator`` ``host:port``, ``num_processes``,
    ``process_id``) or, when ``num_processes`` is not given, torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``). With neither, the run is one process
    and nothing is made. ``backend`` defaults to ``nccl`` when torch sees a
    card and ``gloo`` otherwise; under ``nccl`` each rank takes
    ``cuda:LOCAL_RANK`` first. A failed rendezvous raises (after
    ``timeout_s``); it never falls back to one process.
    """
    if num_processes is not None:
        if num_processes <= 1:
            return False
        if not coordinator or process_id is None:
            raise ValueError(f"num_processes={num_processes} needs a "
                             "coordinator host:port and a process_id")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process_id={process_id} outside "
                             f"[0, {num_processes})")
        world, rank = int(num_processes), int(process_id)
        init_method = f"tcp://{coordinator}"
    elif _env_int("WORLD_SIZE") is not None:
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
        if rank is None:
            raise ValueError("WORLD_SIZE is set but RANK is not")
        init_method = "env://"
    else:
        return False
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: choose nccl or gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return True


def shutdown_distributed() -> None:
    """Leave the process group (no-op without one)."""
    global _objects_group, _axes
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _objects_group = None
    _axes = None


def local_rank(rank: Optional[int] = None) -> int:
    """This process's card on its host: ``LOCAL_RANK`` under torchrun,
    else the rank modulo the cards torch sees."""
    env = _env_int("LOCAL_RANK")
    if env is not None:
        return env
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_main_process() -> bool:
    return process_index() == 0


def current_backend() -> Optional[str]:
    """The default group's backend, None without a process group."""
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


@contextlib.contextmanager
def local_only() -> Iterator[None]:
    """Within the block ``data_parallel()`` is ``(0, 1)``: the model's BN
    and loss run on this data index's tensors alone, as in one process.
    The model axis is left on."""
    global _local_depth
    _local_depth += 1
    try:
        yield
    finally:
        _local_depth -= 1


class MeshAxes:
    """The process groups of a ``data x model`` mesh (K > 1): this rank's
    index on each axis, the axis sizes, each axis's subgroup and the global
    ranks in it (in axis order)."""

    def __init__(self, data_index: int, data_size: int, model_index: int,
                 model_size: int, data_group, model_group,
                 data_ranks: Sequence[int], model_ranks: Sequence[int]):
        self.data_index, self.data_size = data_index, data_size
        self.model_index, self.model_size = model_index, model_size
        self.data_group, self.model_group = data_group, model_group
        self.data_ranks, self.model_ranks = list(data_ranks), \
            list(model_ranks)


def set_mesh_axes(axes: Optional[MeshAxes]) -> None:
    """Install (or, with None, drop) the mesh's axes for this process."""
    global _axes
    _axes = axes


def mesh_axes() -> Optional[MeshAxes]:
    return _axes


def data_parallel() -> Tuple[int, int]:
    """``(index, size)`` that the model's data collectives span: the data
    axis of the mesh, else the process group's ``(rank, world)``; ``(0,
    1)`` without one and inside ``local_only()``."""
    if _local_depth or not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    if _axes is not None:
        return _axes.data_index, _axes.data_size
    return dist.get_rank(), dist.get_world_size()


def model_parallel() -> Tuple[int, int]:
    """``(index, size)`` on the model axis: ``(0, 1)`` without a mesh of
    K > 1. ``local_only()`` does not change it."""
    if _axes is None:
        return 0, 1
    return _axes.model_index, _axes.model_size


def _data_group():
    return _axes.data_group if _axes is not None else None


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can reduce it: nccl takes only CUDA
    tensors, so a CPU one is staged through the current card."""
    if current_backend() == "nccl" and t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _reduce(tensor: torch.Tensor, group, axis: str = "data") -> torch.Tensor:
    TRAFFIC[axis] += tensor.numel() * tensor.element_size()
    work = _on_backend(tensor)
    dist.all_reduce(work, op=dist.ReduceOp.SUM, group=group)
    if work is not tensor:
        tensor.copy_(work)
    return tensor


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the data axis in place; returns it. No-op in one
    process."""
    if data_parallel()[1] == 1:
        return tensor
    return _reduce(tensor, _data_group())


def sum_over_ranks(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the data axis, as a new tensor
    (``tensor`` itself in one process)."""
    if data_parallel()[1] == 1:
        return tensor
    return all_reduce_sum(tensor.detach().clone())


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive runs of one device and dtype, each at most
    ``BUCKET_ELEMS`` elements (a larger tensor is a bucket alone)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        last = out[-1] if out else None
        if last is None or t.device != last[0].device \
                or t.dtype != last[0].dtype \
                or size + t.numel() > BUCKET_ELEMS:
            out.append([t])
            size = t.numel()
        else:
            last.append(t)
            size += t.numel()
    return out


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> int:
    """Run ``op(flat)`` on each coalesced bucket of ``tensors`` and write
    the result back; returns the bytes moved."""
    moved = 0
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        moved += flat.numel() * flat.element_size()
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view_as(t))
    return moved


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> int:
    """Sum the gradients of ``params`` that exist over the data axis, in
    flat buckets; returns the bytes reduced (0 in one process). Every rank
    must pass the same parameters with gradients in the same order (a
    sharded parameter's gradient is its shard's, summed with the same
    shard of the other data indices)."""
    if data_parallel()[1] == 1:
        return 0
    grads = [p.grad for p in params if p.grad is not None]
    return _flat_collective(grads, all_reduce_sum) if grads else 0


def _broadcast(flat: torch.Tensor, src: int, group,
               axis: str = "data") -> None:
    TRAFFIC[axis] += flat.numel() * flat.element_size()
    work = _on_backend(flat)
    dist.broadcast(work, src=src, group=group)
    if work is not flat:
        flat.copy_(work)


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with data index ``src``'s (the rank
    ``src`` without a mesh), in flat buckets (no-op in one process)."""
    if data_parallel()[1] == 1 or not tensors:
        return
    root = _axes.data_ranks[src] if _axes is not None else src
    _flat_collective(list(tensors),
                     lambda flat: _broadcast(flat, root, _data_group()))


# --------------------------------------------------------------------- #
# the model axis (tensor parallelism)
# --------------------------------------------------------------------- #
def model_all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the model axis in place; returns it (no-op
    without a mesh of K > 1)."""
    if _axes is None:
        return tensor
    return _reduce(tensor, _axes.model_group, "model")


def model_broadcast(tensors: Sequence[torch.Tensor], src: int = 0) -> int:
    """Overwrite ``tensors`` in place with model index ``src``'s, in flat
    buckets; returns the bytes moved (0 without a mesh of K > 1)."""
    if _axes is None or not tensors:
        return 0
    root = _axes.model_ranks[src]
    return _flat_collective(
        list(tensors),
        lambda flat: _broadcast(flat, root, _axes.model_group, "model"))


def _alone() -> bool:
    """True where the world-wide functions (objects, barrier) call nothing:
    one process, or inside ``local_only()``."""
    return bool(_local_depth) or process_count() == 1


def barrier() -> None:
    """Wait until every rank gets here (a one-element all-reduce on the
    object group, so nccl needs no device id). No-op in one process."""
    if _alone():
        return
    dist.all_reduce(torch.zeros(1), group=_object_group())


# --------------------------------------------------------------------- #
# python objects, pickled into uint8 tensors on the host
# --------------------------------------------------------------------- #
def _object_group():
    """None (the default group) under gloo; under nccl a gloo group of
    every rank, made at the first call (every rank makes it in the same
    collective order, since objects move only between all ranks). It
    spans every rank under a mesh too."""
    global _objects_group
    if current_backend() != "nccl":
        return None
    if _objects_group is None:
        _objects_group = dist.new_group(backend="gloo")
    return _objects_group


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (``obj`` itself in one
    process). The length goes first, so the others size their buffer,
    then the pickled bytes."""
    if _alone():
        return obj
    group = _object_group()
    mine = process_index() == src
    payload = pickle.dumps(obj) if mine else b""
    n = torch.tensor([len(payload)], dtype=torch.int64)
    dist.broadcast(n, src=src, group=group)
    buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8) if mine \
        else torch.empty(int(n), dtype=torch.uint8)
    dist.broadcast(buf, src=src, group=group)
    return pickle.loads(buf.numpy().tobytes())


def all_gather_objects(obj: Any) -> list:
    """One object per rank, in rank order, on every rank (``[obj]`` in one
    process). Lengths first, then the payloads padded to the longest;
    each rank fills its own row of a zero buffer and one all-reduce sums
    the rows."""
    if _alone():
        return [obj]
    group = _object_group()
    rank, world = process_index(), process_count()
    payload = pickle.dumps(obj)
    lens = torch.zeros(world, dtype=torch.int64)
    lens[rank] = len(payload)
    dist.all_reduce(lens, group=group)
    buf = torch.zeros(world, int(lens.max()), dtype=torch.uint8)
    buf[rank, :len(payload)] = torch.frombuffer(bytearray(payload),
                                                dtype=torch.uint8)
    dist.all_reduce(buf, group=group)
    return [pickle.loads(buf[i, :int(lens[i])].numpy().tobytes())
            for i in range(world)]
