"""DynamicConvNeXt (mmcls ``ConvNeXt``, Liu et al., arXiv:2201.03545): a
4x4/4 conv stem with bias and a channels-first layer norm, four stages of
blocks with a layer norm and a 2x2/2 conv between them, and a layer norm
``norm{i}`` on each output. A block is a depthwise 7x7 conv with bias, a
layer norm over the channels-last map, a linear to 4C, the exact GELU, a
linear back to C, the layer scale ``gamma``, stochastic depth on the
branch, and the residual add. Every layer norm has eps 1e-6.

The arch picks each stage's width and depth: a stage runs its first
``depth`` blocks on prefix slices of the MAX parameters. The stochastic
depth rate of block ``i`` (counted over the MAX blocks) is
``drop_path_rate * i / (sum(depths) - 1)``; a branch is kept for a sample
where a uniform draw in [0, 1) lies below ``1 - rate`` and is then scaled
by ``1 / (1 - rate)``. The draws, one a sample, come from the step's
generator (``gen``) in the activation dtype the model runs in
(``Numerics.draw_dtype``), block by block, before any head's dropout.

``nets.features`` hands a backbone no generator, so where the caller gives
none, ``forward`` looks for the reference's train step among its callers
(``_step_generator``): inside ``nets.train_loss`` it draws from that step's
generator, the one the heads' dropout draws from next; inside
``train.full_step_stats`` (the first full step's running statistics, which
the UPer and FCN heads' batch norms take from the dropped features) it
seeds a generator as ``train.follow`` does and replays the draws of every
step before the full one. Elsewhere a rate above 0 in training raises.

``Numerics(fault="branch_wgrad")`` plants its fault here: each block's
depthwise conv takes its weight gradient from the first half of the batch
only (forward and input gradient whole).
"""
from __future__ import annotations

import inspect
import sys
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ...lib.macs import _conv, _out
from .. import nets
from ..nets import Specs, conv, layer_norm

TYPES = ("DynamicConvNeXt",)
ROLE = "backbone"
DIMS = (96, 192, 384, 768)       # the port's defaults (ConvNeXt-T)
DEPTHS = (3, 3, 9, 3)
KERNEL = 7                       # the depthwise conv's


def _dims(bb: Dict[str, Any]) -> List[int]:
    return [int(d) for d in bb.get("dims", DIMS)]


def _depths(bb: Dict[str, Any]) -> List[int]:
    return [int(d) for d in bb.get("depths", DEPTHS)]


def _out_indices(bb: Dict[str, Any]) -> List[int]:
    return [int(i) for i in bb.get("out_indices", (0, 1, 2, 3))]


def max_arch(bb: Dict[str, Any]) -> Dict[str, Any]:
    return {"body": {"width": _dims(bb), "depth": _depths(bb)}}


def specs(bb: Dict[str, Any], S: Specs) -> List[int]:
    dims, depths = _dims(bb), _depths(bb)
    S.conv("backbone.downsample_layers.0.0", int(bb.get("in_chans", 3)),
           dims[0], 4, bias=True)
    S.norm("backbone.downsample_layers.0.1", dims[0])
    for i in range(1, 4):
        S.norm(f"backbone.downsample_layers.{i}.0", dims[i - 1])
        S.conv(f"backbone.downsample_layers.{i}.1", dims[i - 1], dims[i], 2,
               bias=True)
    scaled = float(bb.get("layer_scale_init_value", 1e-6)) > 0
    for i, (c, depth) in enumerate(zip(dims, depths)):
        for j in range(depth):
            pre = f"backbone.stages.{i}.{j}."
            S.add(pre + "dwconv.weight", (c, 1, KERNEL, KERNEL))
            S.add(pre + "dwconv.bias", (c,))
            S.norm(pre + "norm", c)
            S.add(pre + "pwconv1.weight", (4 * c, c))
            S.add(pre + "pwconv1.bias", (4 * c,))
            S.add(pre + "pwconv2.weight", (c, 4 * c))
            S.add(pre + "pwconv2.bias", (c,))
            if scaled:
                S.add(pre + "gamma", (c,))
    outs = _out_indices(bb)
    for i in outs:
        S.norm(f"backbone.norm{i}", dims[i])
    return [dims[i] for i in outs]


def _drop_rates(bb: Dict[str, Any]) -> List[float]:
    total = sum(_depths(bb))
    rate = float(bb.get("drop_path_rate", 0.0))
    return [rate * i / max(total - 1, 1) for i in range(total)]


def _channel_norm(P, name, x):
    """A layer norm over the channels of an NCHW map."""
    return layer_norm(P, name, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _dwconv(nm, x, w, b):
    return nm.g(F.conv2d(nm.q(x), nm.q(w), b, 1, KERNEL // 2, 1, x.shape[1]))


def _depthwise(nm, P, name, x, half_wgrad: bool = False):
    c = x.shape[1]
    w, b = P[name + ".weight"][:c], P[name + ".bias"][:c]
    if half_wgrad:       # the planted fault: no weight gradient from rows n:
        n = len(x) // 2
        return torch.cat([_dwconv(nm, x[:n], w, b),
                          _dwconv(nm, x[n:], w.detach(), b)])
    return _dwconv(nm, x, w, b)


def _drop_path(nm, y, rate: float, gen: Optional[torch.Generator]):
    keep = 1.0 - rate
    u = torch.rand((y.shape[0],) + (1,) * (y.dim() - 1), generator=gen,
                   device=y.device, dtype=nm.draw_dtype)
    return y / keep * (u < keep).to(y.dtype)


def _block(nm, P, pre: str, x, rate: float, train: bool,
           gen: Optional[torch.Generator]):
    c = x.shape[1]
    y = _depthwise(nm, P, pre + "dwconv", x, nm.fault == "branch_wgrad")
    y = layer_norm(P, pre + "norm", y.permute(0, 2, 3, 1))
    y = F.gelu(nm.linear(y, P[pre + "pwconv1.weight"][:4 * c, :c],
                         P[pre + "pwconv1.bias"][:4 * c]))
    y = nm.linear(y, P[pre + "pwconv2.weight"][:c, :4 * c],
                  P[pre + "pwconv2.bias"][:c])
    gamma = P.get(pre + "gamma")
    if gamma is not None:
        y = y * gamma[:c]
    y = y.permute(0, 3, 1, 2)
    if train and rate > 0:
        if gen is None:
            raise ValueError(f"{pre}: stochastic depth at rate {rate} needs "
                             "the step's generator: nets.features hands a "
                             "backbone none, and no caller is the "
                             "reference's train step")
        y = _drop_path(nm, y, rate, gen)
    return x + y


def _active_rates(cfg: Dict[str, Any], arch: Dict[str, Any]) -> List[float]:
    """The stochastic depth rate of each block the arch runs, in order."""
    rates, first, out = _drop_rates(cfg), 0, []
    for max_depth, depth in zip(_depths(cfg), arch["body"]["depth"]):
        out += rates[first:first + int(depth)]
        first += max_depth
    return out


def _head_draw_shapes(model_cfg: Dict[str, Any], arch: Dict[str, Any],
                      batch: int, hw) -> List[tuple]:
    """The shapes of the heads' dropout draws in a step, decode head first:
    each head's ``channels`` at the size of its first input level (UPer's
    fused map is its finest level's, FCN's its one level's)."""
    if model_cfg.get("neck"):
        raise ValueError("the replay of the draws knows no neck")
    feats = macs(model_cfg["backbone"], arch, hw)[1]
    shapes = []
    for name in ("decode_head", "auxiliary_head"):
        head = model_cfg.get(name)
        if not head or float(head.get("dropout_ratio", 0.1)) <= 0:
            continue
        if not head["type"].endswith(("UPerHead", "FCNHead")):
            raise ValueError(f"the replay of the draws knows no {name} of "
                             f"type {head['type']!r}")
        idx = head.get("in_index", -1)
        level = idx[0] if isinstance(idx, (list, tuple)) else idx
        shapes.append((batch, int(head["channels"])) + tuple(feats[level][1]))
    return shapes


def _replayed(nm, cfg: Dict[str, Any], seed: int, step: int,
              device: torch.device) -> torch.Generator:
    """A generator seeded as ``train.follow`` seeds the step's, after the
    draws of steps ``0 .. step - 1``: each step's stochastic depth (one
    draw a sample for each block the step's arch runs at a rate above 0),
    then the decode and auxiliary heads' dropout, at the config's batch."""
    from .. import schedule
    model_cfg, batch = cfg["model"], int(cfg["batch"])
    bb = model_cfg["backbone"]
    hw = tuple(cfg["pipe"]["crop_size"])
    template = schedule.max_arch(model_cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for meta in schedule.sampler_metas(cfg["train_sampler"], step):
        arch = schedule.arch_of(template, meta)["backbone"]
        shapes = [(batch, 1, 1, 1) for r in _active_rates(bb, arch) if r > 0]
        for shape in shapes + _head_draw_shapes(model_cfg, arch, batch, hw):
            torch.rand(shape, generator=gen, device=device,
                       dtype=nm.draw_dtype)
    return gen


def _step_generator(nm, device: torch.device
                    ) -> Optional[torch.Generator]:
    """The generator of the reference's train step that runs this forward,
    found among the callers (``nets.train_loss``'s ``gen``), or one
    replayed to the full step that ``train.full_step_stats`` works out;
    None under any other caller."""
    from .. import train as ref_train
    step = inspect.unwrap(nets.train_loss).__code__
    full = inspect.unwrap(ref_train.full_step_stats).__code__
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code is step:
            return frame.f_locals["gen"]
        if frame.f_code is full:
            loc = frame.f_locals
            return _replayed(nm, loc["cfg"], int(loc["seed"]),
                             int(loc["step"]), device)
        frame = frame.f_back
    return None


def forward(nm, P, x, arch, cfg, train, stats=None,
            gen: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    widths = [int(w) for w in arch["body"]["width"]]
    depths = [int(d) for d in arch["body"]["depth"]]
    rates, first = _drop_rates(cfg), 0
    if train and gen is None and any(r > 0 for r in
                                     _active_rates(cfg, arch)):
        gen = _step_generator(nm, x.device)
    outs, out_indices = [], _out_indices(cfg)
    x = conv(nm, P, "backbone.downsample_layers.0.0", x, widths[0], 4,
             padding=0)
    x = _channel_norm(P, "backbone.downsample_layers.0.1", x)
    for i, max_depth in enumerate(_depths(cfg)):
        for j in range(depths[i]):
            x = _block(nm, P, f"backbone.stages.{i}.{j}.", x,
                       rates[first + j], train, gen)
        first += max_depth
        if i in out_indices:
            outs.append(_channel_norm(P, f"backbone.norm{i}", x))
        if i < 3:
            x = conv(nm, P, f"backbone.downsample_layers.{i + 1}.1",
                     _channel_norm(P, f"backbone.downsample_layers.{i + 1}.0",
                                   x), widths[i + 1], 2, padding=0)
    return outs


def macs(bb: Dict[str, Any], arch: Dict[str, Any], hw):
    """(MACs, [(channels, (h, w)) at ``out_indices``]): the stem and
    downsample convs, each block's depthwise conv (``KERNEL**2`` a
    channel and pixel) and its two linears."""
    widths = [int(w) for w in arch["body"]["width"]]
    depths = [int(d) for d in arch["body"]["depth"]]
    h, w = _out(hw[0], 4, 4, 0), _out(hw[1], 4, 4, 0)
    total = _conv((h, w), int(bb.get("in_chans", 3)), widths[0], 4)
    feats, outs = [], _out_indices(bb)
    for i, c in enumerate(widths):
        if i:
            h, w = _out(h, 2, 2, 0), _out(w, 2, 2, 0)
            total += _conv((h, w), widths[i - 1], c, 2)
        total += depths[i] * (_conv((h, w), 1, c, KERNEL)
                              + 2 * h * w * c * 4 * c)
        if i in outs:
            feats.append((c, (h, w)))
    return total, feats
