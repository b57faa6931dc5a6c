"""The ``data x model`` mesh and tensor-parallel sharding of a model.

The port of ``gaiaseg_tpu/parallel/mesh.py:27-123`` under the JAX names
(``DATA_AXIS``, ``MODEL_AXIS``, ``make_mesh``, ``tp_spec``,
``shard_state``, ``shard_report``). JAX reshapes the devices to ``[n // K,
K]``; here the ranks are: rank ``r`` is data index ``r // K`` and model
index ``r % K``. ``make_mesh(K)`` makes each axis's subgroups
(``parallel.distributed`` then reduces the data collectives over the data
group) and returns the mesh; at ``K = 1`` it makes nothing and every path
runs as without a mesh.

``tp_spec`` is JAX's rule, copied verbatim: on a leaf of at least
``min_size`` elements, the row dim (``shape[-2]``) of a leaf under a path
segment ``proj`` or ``fc2`` when K divides it, else the last dim when K
divides it; 1-D leaves whole. ``shard_state`` applies it to the JAX leaf
each port parameter comes from (``_jax_leaf``): a conv kernel is JAX's
``HWIO`` (its last dim the port's dim 0), a transposed conv's ``[kh, kw,
in, out]`` (the port's ``[in, out, kh, kw]``), a linear kernel ``[in,
out]``; the elastic ViT's fused ``qkv`` is JAX's three leaves ``w_q``,
``w_k``, ``w_v`` (``[E, inner]`` each, so ``min_size`` counts ``E *
inner`` and each block is split on its own), declared by its owner in
``jax_fused``, and a submodule whose owner names it otherwise in
``jax_names`` takes JAX's name (the timm ``patch_embed.proj`` is JAX's
``patch_embed``: no row rule). A rule on the port's own names would read
both otherwise.

A sharded parameter keeps only this rank's shard (``tensor_parallel``),
so an optimizer built after ``shard_state`` holds its momentum and Adam
moments at the shard's shape, as JAX's mirror the parameter's sharding.
The elastic transformer's attention and FFN run as Megatron column/row
pairs when the pair splits by whole heads (``ElasticMHA.megatron_split``);
every other sharded parameter is gathered on use.
``shard_report`` lists the sharded parameters with their torch dim, K and
route. ``gather_state_dict`` / ``shard_state_dict`` and their optimizer
counterparts carry full-shape checkpoints in and out.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .distributed import (MeshAxes, mesh_axes, process_count, process_index,
                          set_mesh_axes)
from .tensor_parallel import (Shard, gather_full, install_gather_on_use,
                              shard_of, tp_info)

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_MIN_SIZE = 1 << 16


class Mesh:
    """A ``data x model`` layout of the ranks: ``shape`` (JAX's
    ``mesh.shape``) and this rank's index on each axis."""

    def __init__(self, data_size: int, model_size: int):
        self.shape = {DATA_AXIS: data_size, MODEL_AXIS: model_size}
        self.data_index, self.model_index = divmod(process_index(),
                                                   model_size)


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The ``data x model`` mesh over the process group's ranks.

    Raises when the world size is not a multiple of ``model_parallel``
    (JAX asserts it) and when ``model_parallel > 1`` has no process group.
    Every rank makes every subgroup, in one order; a mesh of the same K
    that already stands is returned as it is."""
    k = int(model_parallel)
    world = process_count()
    if k < 1 or world % k:
        raise ValueError(f"model_parallel={k} does not divide the world "
                         f"size {world}")
    axes = mesh_axes()
    if axes is not None:
        if axes.model_size != k:
            raise RuntimeError(f"a mesh of model_parallel={axes.model_size} "
                               f"stands; cannot make one of {k}")
        return Mesh(world // k, k)
    if k == 1:
        return Mesh(world, 1)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"model_parallel={k} needs a process group of a "
                           f"multiple of {k} ranks; there is none")
    d_size, rank = world // k, dist.get_rank()
    data_index, model_index = divmod(rank, k)
    model_group = data_group = None
    model_ranks = data_ranks = None
    for d in range(d_size):        # the model groups: one a data index
        ranks = [d * k + m for m in range(k)]
        group = dist.new_group(ranks=ranks)
        if d == data_index:
            model_group, model_ranks = group, ranks
    for m in range(k):             # the data groups: one a model index
        ranks = [d * k + m for d in range(d_size)]
        group = dist.new_group(ranks=ranks)
        if m == model_index:
            data_group, data_ranks = group, ranks
    axes = MeshAxes(data_index, d_size, model_index, k, data_group,
                    model_group, data_ranks, model_ranks)
    set_mesh_axes(axes)
    return Mesh(d_size, k)


def tp_spec(path: str, shape, tp: int,
            min_size: int = DEFAULT_MIN_SIZE) -> Tuple[Optional[str], ...]:
    """JAX's ``tp_spec`` for one leaf, as a tuple (``()`` replicated, else
    one entry a dim with ``MODEL_AXIS`` on the sharded one): the
    Megatron row rule for a whole path segment ``proj`` / ``fc2`` (JAX's
    attention out-projection and second FFN linear), else the last
    (output) dim, each when ``tp`` divides the dim and the leaf has at
    least ``min_size`` elements; small and 1-D leaves replicated."""
    if tp <= 1 or len(shape) < 2:
        return ()
    nd = len(shape)
    segs = path.split("/")
    numel = math.prod(int(s) for s in shape)
    if any(k in segs for k in ("proj", "fc2")) and shape[-2] % tp == 0 \
            and numel >= min_size:
        return (None,) * (nd - 2) + (MODEL_AXIS, None)
    if shape[-1] % tp == 0 and numel >= min_size:
        return (None,) * (nd - 1) + (MODEL_AXIS,)
    return ()


# --------------------------------------------------------------------- #
# the JAX leaf of a port parameter
# --------------------------------------------------------------------- #
def _module_kind(module: nn.Module) -> str:
    """'conv', 'deconv' or 'linear' for the port's layer classes."""
    # imported here: the dynamic layers import this package's collectives
    from ..ops.dynamic_layers import DynConv2d, DynLinear
    if isinstance(module, nn.ConvTranspose2d):
        return "deconv"
    if isinstance(module, (nn.Conv2d, DynConv2d)):
        return "conv"
    if isinstance(module, (nn.Linear, DynLinear)):
        return "linear"
    return "array"


def _jax_names(model: nn.Module) -> Dict[str, str]:
    """``{port name prefix: JAX path prefix}`` of the submodules whose
    owner declares another JAX name in ``jax_names`` (the timm
    ``patch_embed.proj`` of the ViT and BEiT is JAX's ``patch_embed``)."""
    out = {}
    for mod_name, module in model.named_modules():
        for port, jax in getattr(module, "jax_names", {}).items():
            pre = f"{mod_name}." if mod_name else ""
            out[pre + port] = pre + jax
    return out


def _jax_leaf(name: str, module: nn.Module, parent: Optional[nn.Module],
              child: str, pname: str, shape, renames: Dict[str, str]
              ) -> Tuple[str, Tuple[int, ...], Dict[int, int], int]:
    """``(path, JAX shape, {JAX dim: torch dim}, blocks)`` of the JAX leaf
    that the port parameter ``name`` (``module.<pname>`` of ``shape``)
    comes from; ``renames`` is ``_jax_names`` of the model. Only dims -1
    and -2 are mapped: the rule shards no other."""
    owner = name.rsplit(".", 1)[0]
    if owner in renames:
        name = renames[owner] + name[len(owner):]
    path = name.lower().replace(".", "/")
    kind = _module_kind(module) if pname == "weight" else "array"
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    fused = getattr(parent, "jax_fused", {}).get(child) \
        if parent is not None else None
    if kind == "linear" and fused:
        # JAX's w_q / w_k / w_v, [E, inner] each, concatenated on dim 0
        parent_path = path.rsplit("/", 2)[0]
        jshape = (shape[1], shape[0] // len(fused))
        return f"{parent_path}/{fused[0]}/kernel", jshape, {-1: 0, -2: 1}, \
            len(fused)
    if kind == "conv" and nd == 4:          # OIHW <- HWIO
        o, i, kh, kw = shape
        return path, (kh, kw, i, o), {-1: 0, -2: 1}, 1
    if kind == "deconv" and nd == 4:        # [in, out, kh, kw] <- [kh, kw, in, out]
        i, o, kh, kw = shape
        return path, (kh, kw, i, o), {-1: 1, -2: 0}, 1
    if kind == "linear" and nd == 2:        # [out, in] <- [in, out]
        return path, (shape[1], shape[0]), {-1: 0, -2: 1}, 1
    return path, shape, {-1: nd - 1, -2: nd - 2}, 1


def _parents(model: nn.Module) -> Dict[int, Tuple[nn.Module, str]]:
    out = {}
    for m in model.modules():
        for child_name, child in m.named_children():
            out[id(child)] = (m, child_name)
    return out


def tp_plan(model: nn.Module, model_parallel: int,
            min_size: int = DEFAULT_MIN_SIZE
            ) -> Dict[str, Tuple[int, int, str]]:
    """``{parameter name: (torch dim, K, route)}`` of every parameter that
    ``shard_state`` shards at ``model_parallel`` K (no process group
    needed): JAX's ``tp_spec`` on each parameter's JAX leaf, then the
    route: ``column`` / ``row`` for a Megatron pair (a module with
    ``tp_pair`` whose column weight is sharded on dim 0, its row weight on
    dim 1, and whose ``megatron_split(K)`` holds), ``gather`` for the
    rest."""
    k = int(model_parallel)
    plan: Dict[str, Tuple[int, int, str]] = {}
    if k <= 1:
        return plan
    parents, renames = _parents(model), _jax_names(model)
    for mod_name, module in model.named_modules():
        parent, child = parents.get(id(module), (None, ""))
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            info = tp_info(p)
            shape = info.full_shape if info is not None else p.shape
            path, jshape, dims, _ = _jax_leaf(name, module, parent, child,
                                              pname, shape, renames)
            spec = tp_spec(path, jshape, k, min_size)
            if spec:
                jdim = spec.index(MODEL_AXIS) - len(spec)
                plan[name] = (dims[jdim], k, "gather")
    for mod_name, module in model.named_modules():
        pair = getattr(module, "tp_pair", None)
        if pair is None:
            continue
        col, row = (f"{mod_name}.{p}.weight" if mod_name else f"{p}.weight"
                    for p in pair)
        if plan.get(col, (None,))[0] == 0 and plan.get(row, (None,))[0] == 1 \
                and module.megatron_split(k):
            plan[col], plan[row] = (0, k, "column"), (1, k, "row")
    return plan


def _blocks(model: nn.Module) -> Dict[str, int]:
    """The block count of each fused parameter (the ViT's ``qkv``: 3)."""
    out = {}
    for mod_name, module in model.named_modules():
        for child, fused in getattr(module, "jax_fused", {}).items():
            out[f"{mod_name}.{child}.weight" if mod_name
                else f"{child}.weight"] = len(fused)
    return out


def shard_state(model: nn.Module, mesh: Mesh,
                min_size: int = DEFAULT_MIN_SIZE) -> nn.Module:
    """Shard ``model``'s parameters over the mesh's model axis as JAX's
    ``shard_state`` places them (``tp_plan``): each sharded parameter
    becomes a new ``nn.Parameter`` holding this rank's shard, the owners
    of gathered ones read the full weight on use, the Megatron pairs'
    modules learn their model index. Build the optimizer afterwards. At
    K = 1, or on a model already sharded, nothing changes. Returns
    ``model``."""
    k = mesh.shape[MODEL_AXIS]
    if k == 1 or any(tp_info(p) is not None for p in model.parameters()):
        return model
    m = mesh.model_index
    plan = tp_plan(model, k, min_size)
    blocks = _blocks(model)
    gathered: Dict[int, Tuple[nn.Module, list]] = {}
    for mod_name, module in list(model.named_modules()):
        for pname, p in list(module.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            if name not in plan:
                continue
            dim, _, route = plan[name]
            b = blocks.get(name, 1)
            data = shard_of(p.detach(), dim, b, m, k).clone()
            shard = nn.Parameter(data, requires_grad=p.requires_grad)
            shard.tp = Shard(dim, b, m, k, tuple(p.shape), route)
            module._parameters[pname] = shard
            if route == "gather":
                gathered.setdefault(id(module), (module, []))[1].append(pname)
    for module, names in gathered.values():
        install_gather_on_use(module, names)
    for module in model.modules():
        pair = getattr(module, "tp_pair", None)
        if pair is not None:
            route = tp_info(module.get_submodule(pair[0])
                            ._parameters["weight"])
            module.tp_megatron = (m, k) if route is not None \
                and route.route == "column" else None
    return model


def shard_report(model: nn.Module) -> Dict[str, Tuple[int, int, str]]:
    """``{parameter name: (torch dim, K, route)}`` of every sharded
    parameter of ``model`` (JAX's audit of ``shard_state``, with the route
    each takes: ``gather``, or ``column`` / ``row`` of a Megatron pair)."""
    return {name: (i.dim, i.size, i.route)
            for name, p in model.named_parameters()
            for i in [tp_info(p)] if i is not None}


# --------------------------------------------------------------------- #
# full-shape state in and out (checkpoints)
# --------------------------------------------------------------------- #
@torch.no_grad()
def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded parameter at its full
    shape (a collective on the model group: every model rank calls it)."""
    sd = model.state_dict()
    for name, p in model.named_parameters():
        info = tp_info(p)
        if info is not None:
            sd[name] = gather_full(p.detach(), info)
    return sd


def shard_state_dict(model: nn.Module, sd: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """``sd`` with each full-shape entry of a sharded parameter cut to
    this rank's shard (entries already at the shard's shape, and every
    other key, as they are)."""
    out = dict(sd)
    for name, p in model.named_parameters():
        info = tp_info(p)
        v = out.get(name)
        if info is not None and isinstance(v, torch.Tensor) \
                and tuple(v.shape) == info.full_shape:
            out[name] = shard_of(v, info.dim, info.blocks, info.index,
                                 info.size).clone()
    return out


def _optimizer_params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


@torch.no_grad()
def gather_optimizer_state(optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with the state of each sharded parameter
    (momentum, Adam moments) at the full shape (a collective on the model
    group). The live state is not touched."""
    sd = optimizer.state_dict()
    state = dict(sd["state"])
    for i, p in enumerate(_optimizer_params(optimizer)):
        info, st = tp_info(p), state.get(i)
        if info is None or not st:
            continue
        state[i] = {key: gather_full(v, info)
                    if isinstance(v, torch.Tensor) and v.shape == p.shape
                    and v.dim() > 0 else v for key, v in st.items()}
    return {**sd, "state": state}


def shard_optimizer_state(optimizer, sd: Dict[str, Any]) -> Dict[str, Any]:
    """A full-shape ``optimizer.state_dict()`` cut to this rank's shards,
    for ``optimizer.load_state_dict``."""
    state = dict(sd.get("state", {}))
    for i, p in enumerate(_optimizer_params(optimizer)):
        info, st = tp_info(p), state.get(i)
        if info is None or not st:
            continue
        state[i] = {key: shard_of(v, info.dim, info.blocks, info.index,
                                  info.size).clone()
                    if isinstance(v, torch.Tensor)
                    and tuple(v.shape) == info.full_shape else v
                    for key, v in st.items()}
    return {**sd, "state": state}
