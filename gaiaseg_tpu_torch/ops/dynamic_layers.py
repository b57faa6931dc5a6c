"""Sliced dynamic layers: DynConv2d, DynBatchNorm, DynLinear, DynLayerNorm
(and its NCHW form DynChannelLayerNorm).

Port of ``gaiaseg_tpu/ops/dynamic_layers.py``. The JAX package keeps every
parameter at MAX shape and MASKS inactive channels, so one XLA program
serves every subnet. PyTorch runs eagerly and has no compile to amortise,
so the port does what the reference's gaiavision ops do: parameters live at
MAX shape and a subnet runs on PREFIX SLICES of them. ``tests/
test_dynamic_ops.py`` holds masking equal to slicing, so the two agree on
every active channel.

Layout is NCHW, parameters OIHW and linear weights ``[out, in]`` (the
reference mmseg / timm ``state_dict``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import all_reduce_sum, data_parallel
from ..utils.tracing import region


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class DynConv2d(nn.Module):
    """Conv2d over a prefix slice of a MAX-shape ``[out, in, kh, kw]`` weight.

    The input rows follow ``x``: a narrower input takes kernel rows
    ``[:in_ch]``. ``in_tail`` marks an input that is a concat of
    ``[elastic prefix, static tail]`` (the PSP bottleneck): the prefix takes
    rows ``[:in_ch - in_tail]`` and the tail the LAST ``in_tail`` rows
    (``gaiaseg_tpu/ops/dynamic_layers.py:137-151``). ``out_channels``
    truncates the produced channels. ``padding=None`` is torch's symmetric
    ``dilation * (k - 1) // 2``; an int or pair pads symmetrically by that
    (0 for the ViT patch embed).

    ``groups=in_channels`` (with ``out_channels == in_channels``) is a
    depthwise conv, the separable ASPP's (JAX ``aspp_head.py:34``): the
    weight is ``[C, 1, kh, kw]`` at MAX and a narrower input of ``c``
    channels takes ``weight[:c]`` with ``groups=c``, the extracted
    subnet's conv. Other group counts have no sliced meaning and raise.
    A depthwise call runs under ``region("conv.depthwise")`` (a profiler
    range while one records, and a call counter).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1,
                 dilation: Union[int, Tuple[int, int]] = 1,
                 bias: bool = False,
                 padding: Optional[Union[int, Tuple[int, int]]] = None,
                 groups: int = 1):
        super().__init__()
        if groups != 1 and not groups == in_channels == out_channels:
            raise ValueError(f"DynConv2d groups={groups}: 1 or depthwise "
                             f"(groups == in == out channels, here "
                             f"{in_channels} -> {out_channels})")
        self.depthwise = groups != 1
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.padding = (self.dilation[0] * (kh - 1) // 2,
                        self.dilation[1] * (kw - 1) // 2) \
            if padding is None else _pair(padding)
        self.weight = nn.Parameter(torch.empty(
            out_channels, 1 if self.depthwise else in_channels, kh, kw))
        # the JAX init: variance_scaling(2.0, "fan_out", truncated normal)
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor, out_channels: Optional[int] = None,
                in_tail: int = 0) -> torch.Tensor:
        w, b = self.weight, self.bias
        if self.depthwise:
            c = x.shape[1]
            if c > w.shape[0] or out_channels not in (None, c):
                raise ValueError(f"depthwise conv of {w.shape[0]} channels "
                                 f"given {c} (out_channels={out_channels})")
            with region("conv.depthwise"):
                return F.conv2d(x, w[:c], b[:c] if b is not None else None,
                                self.stride, self.padding, self.dilation, c)
        in_ch, in_max = x.shape[1], w.shape[1]
        if in_ch > in_max:
            raise ValueError(f"input has {in_ch} channels, the weight {in_max}")
        if in_ch < in_max:
            if in_tail:
                w = torch.cat([w[:, :in_ch - in_tail], w[:, in_max - in_tail:]],
                              dim=1)
            else:
                w = w[:, :in_ch]
        if out_channels is not None and out_channels < w.shape[0]:
            w = w[:out_channels]
            b = b[:out_channels] if b is not None else None
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation)


class DynBatchNorm(nn.Module):
    """Batch norm over the first ``x.shape[1]`` channels of MAX-shape
    parameters and running statistics.

    ``F.batch_norm`` on prefix views updates the running stats of the active
    channels in place and leaves the rest alone, which is the JAX module's
    gated update (``dynamic_layers.py:304-320``). ``momentum=0.1`` is torch's
    weight of the NEW statistic: the JAX ``momentum=0.9`` is the decay of the
    old one (``:238``). Both unbias the running variance by ``n/(n-1)``.

    ``update_stats=False`` (set by ``frozen_bn_stats``) is the JAX silent
    step's ``mutable=[]``: in train mode it still normalizes with the batch
    statistics, and no running statistic changes.

    Across the data axis (``parallel.data_parallel()`` size W > 1) the
    train-mode statistics are those of the global batch, as the JAX
    module's under a sharded batch: ``sync_batch_norm``. ``stat_groups=G``
    (JAX ``:242``, ``:273-296``) takes them per contiguous group of
    ``global batch / G`` samples instead, the running statistics tracking
    the group average; a global batch that G does not divide falls back to
    global statistics, as in JAX. Under W data indices a group must lie
    inside one (G a multiple of W). Eval mode reads the running statistics
    and calls no collective.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, stat_groups: int = 1):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.stat_groups = int(stat_groups)
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        if self.training:
            world = data_parallel()[1]
            groups = self._local_groups(x.shape[0], world)
            if groups:
                return self._grouped(x, groups, world)
            if world > 1:
                run = (self.running_mean[:c], self.running_var[:c]) \
                    if self.update_stats else (None, None)
                return sync_batch_norm(x, self.weight[:c], self.bias[:c],
                                       *run, self.momentum, self.eps)
            if x.numel() == c:
                return self._one_value_per_channel(x)
            if not self.update_stats:
                return F.batch_norm(x, None, None, self.weight[:c],
                                    self.bias[:c], True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean[:c], self.running_var[:c],
                            self.weight[:c], self.bias[:c], self.training,
                            self.momentum, self.eps)

    def _local_groups(self, batch: int, world: int) -> int:
        """The statistic groups in this rank's ``batch`` (0: none, the
        statistics are global)."""
        g = self.stat_groups
        if g <= 1 or (batch * world) % g:
            return 0
        if g % world:
            raise ValueError(
                f"stat_groups={g} over {world} ranks of batch {batch}: a "
                "group must lie inside one rank (stat_groups a multiple of "
                "the world size)")
        return g // world

    def _grouped(self, x: torch.Tensor, groups: int,
                 world: int) -> torch.Tensor:
        """Per-group statistics (JAX ``:273-285``), in float32 and
        two-pass; the running statistics move by the average over all
        ``groups * world`` groups."""
        n, c = x.shape[:2]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        xg = xf.reshape(groups, n // groups, *xf.shape[1:])
        dims = [1] + list(range(3, xg.dim()))
        var, mean = torch.var_mean(xg, dim=dims, unbiased=False)  # [g, C]
        shape = (groups, 1, c) + (1,) * (xg.dim() - 3)
        inv = torch.rsqrt(var + self.eps).reshape(shape)
        y = (xg - mean.reshape(shape)) * inv
        y = y * self.weight[:c].reshape(shape[1:]) \
            + self.bias[:c].reshape(shape[1:])
        if self.update_stats:
            per = xg[0].numel() // c
            with torch.no_grad():
                stats = all_reduce_sum(torch.stack(
                    [mean.sum(0), var.sum(0)])) / (groups * world)
                self._update_running(stats[0], stats[1]
                                     * (per / max(per - 1.0, 1.0)))
        return y.reshape(x.shape).to(x.dtype)

    def _update_running(self, mean: torch.Tensor,
                        unbiased_var: torch.Tensor) -> None:
        c, m = mean.shape[0], self.momentum
        self.running_mean[:c].mul_(1 - m).add_(
            mean.to(self.running_mean.dtype), alpha=m)
        self.running_var[:c].mul_(1 - m).add_(
            unbiased_var.to(self.running_var.dtype), alpha=m)

    def _one_value_per_channel(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode on one value a channel (batch 1 through a 1x1 pool):
        ``F.batch_norm`` refuses it, since its unbiasing ``n/(n-1)``
        divides by zero. The JAX module's ``n/max(n-1, 1)`` is 1 there: the
        batch variance 0 enters the running variance as it is."""
        c = x.shape[1]
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        y = (x - mean) * torch.rsqrt(x.new_tensor(self.eps))
        y = y * self.weight[:c, None, None] + self.bias[:c, None, None]
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean[:c].mul_(1 - m).add_(
                    mean.flatten().to(self.running_mean.dtype), alpha=m)
                self.running_var[:c].mul_(1 - m)
        return y


class _SyncBatchNorm(torch.autograd.Function):
    """Batch norm over the batch of every rank (the JAX module's global
    statistics under a sharded batch). Forward: each rank's count, mean
    and sum of squared deviations per channel (two-pass, in float32) go
    into its row of a ``[W, 3, C]`` buffer; one all-reduce, and every rank
    combines the rows in rank order (Chan et al.), so all hold the same
    statistics. The running variance is unbiased by the global
    ``n / max(n - 1, 1)``. Backward: one all-reduce of ``[sum dy, sum dy *
    xhat]``; the weight and bias gradients are this rank's share, summed
    with the other gradients after the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        rank, world = data_parallel()
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var_r, mean_r = torch.var_mean(xf, dim=dims, unbiased=False)
        rows = xf.new_zeros(world, 3, c)
        rows[rank, 0] = x.numel() // c
        rows[rank, 1] = mean_r
        rows[rank, 2] = var_r * (x.numel() // c)
        count, means, m2 = all_reduce_sum(rows).unbind(1)     # [W, C] each
        n = count.sum(0)
        mean = (count * means).sum(0) / n
        var = (m2.sum(0) + (count * (means - mean).square()).sum(0)) / n
        invstd = torch.rsqrt(var + eps)
        if running_mean is not None:
            nn_ = float(n[0])
            running_mean.mul_(1 - momentum).add_(
                mean.to(running_mean.dtype), alpha=momentum)
            running_var.mul_(1 - momentum).add_(
                (var * (nn_ / max(nn_ - 1.0, 1.0))).to(running_var.dtype),
                alpha=momentum)
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (xf - mean.reshape(shape)) * invstd.reshape(shape)
        y = xhat * weight.reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n = float(n[0])
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (x.to(invstd.dtype) - mean.reshape(shape)) \
            * invstd.reshape(shape)
        dyf = dy.to(invstd.dtype)
        local = torch.cat([dyf.sum(dim=dims), (dyf * xhat).sum(dim=dims)])
        sums = all_reduce_sum(local.clone()) / ctx.n
        dx = (dyf - sums[:c].reshape(shape)
              - xhat * sums[c:].reshape(shape)) \
            * (weight * invstd).reshape(shape)
        return (dx.to(x.dtype), local[c:].to(weight.dtype),
                local[:c].to(weight.dtype), None, None, None, None)


def sync_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor,
                    running_mean: Optional[torch.Tensor] = None,
                    running_var: Optional[torch.Tensor] = None,
                    momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode batch norm of ``x`` ``[N, C, ...]`` with statistics over
    every rank's batch (``parallel.data_parallel()``; one process: its own
    batch). ``running_mean``/``running_var`` (views of the active prefix)
    move by ``momentum`` when given; None leaves them alone (the silent
    step). Statistics in float32 (float64 for float64 input); the output
    in ``x``'s dtype."""
    return _SyncBatchNorm.apply(x, weight, bias, running_mean, running_var,
                                momentum, eps)


@contextlib.contextmanager
def frozen_bn_stats(model: nn.Module):
    """Within the block, every ``DynBatchNorm`` of ``model`` leaves its
    running statistics alone (each module's flag is restored after)."""
    bns = [m for m in model.modules() if isinstance(m, DynBatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


class DynLinear(nn.Module):
    """Linear over a prefix slice of a MAX-shape ``[out, in]`` weight
    (``gaiaseg_tpu/ops/dynamic_layers.py:189-219``): the input width picks
    the columns, ``out_features`` truncates the rows."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        # the JAX init: lecun_normal (truncated normal, variance 1/fan_in)
        nn.init.trunc_normal_(self.weight, std=in_features ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor,
                out_features: Optional[int] = None) -> torch.Tensor:
        w, b = self.weight[:, :x.shape[-1]], self.bias
        if out_features is not None and out_features < w.shape[0]:
            w = w[:out_features]
            b = b[:out_features] if b is not None else None
        return F.linear(x, w, b)


class DynLayerNorm(nn.Module):
    """LayerNorm over the last ``x.shape[-1]`` channels with the prefix of
    MAX-shape ``weight``/``bias`` (``gaiaseg_tpu/ops/dynamic_layers.py:
    341-386``: mean and variance over the active channels only). ``eps``
    is the JAX module's 1e-6, not torch's 1e-5."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        return F.layer_norm(x, (c,), self.weight[:c], self.bias[:c], self.eps)


class DynChannelLayerNorm(DynLayerNorm):
    """``DynLayerNorm`` over dim 1 of an NCHW map: the JAX module over the
    channels of its NHWC map (ConvNeXt's stem, downsample and output
    norms). At full width it is the plain channels-first LayerNorm (BEiT's
    ``fpn1.1``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
