"""What every model component of the plain reference shares, and the
dispatch to the components (``parts/``, one file a config ``type``) over a
dict of MAX-shape tensors named as the published state dicts name them.

A subnet runs on prefix slices of the MAX parameters (GAIA's dynamic ops):
a conv or linear takes the first ``out`` rows and as many input columns as
its input has, a norm the first channels. Batch norm normalizes with the
batch's statistics in training (biased variance, eps 1e-5) and with the
running ones otherwise; layer norm has eps 1e-6; GELU is exact. Dropout
keeps a value where a uniform draw in [0, 1) lies below ``1 - p`` and
scales it by ``1 / (1 - p)``; the draws come from the step's generator, in
the activation dtype the model runs in (``Numerics.draw_dtype``), decode
head first.

``Numerics("float32")`` is the reference; ``Numerics("fp8")`` the control,
float8 training: its convs and matmuls read both operands rounded to float8
e4m3 and pass their output's gradient back rounded to float8 e5m2 (a scale
per tensor each), with float32 accumulation. ``Numerics(...,
fault="branch_wgrad")`` plants a fault confined to a backward pass, in the
backbone that has residual branches (``parts/dynamic_resnet.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import parts

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0           # float8 e4m3
FP8_GRAD_MAX = 57344.0    # float8 e5m2


class _GradToFp8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 (a scale per
    tensor) on its way back, as float8 training keeps it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale = g.abs().amax().clamp(min=1e-30) / FP8_GRAD_MAX
        return (g / scale).to(torch.float8_e5m2).to(g.dtype) * scale


class Numerics:
    def __init__(self, precision: str = "float32",
                 draw_dtype: torch.dtype = torch.float32,
                 fault: Optional[str] = None):
        if precision not in ("float32", "bf16", "fp8") or \
                fault not in (None, "branch_wgrad"):
            raise ValueError((precision, fault))
        self.precision = precision
        self.draw_dtype = draw_dtype
        self.fault = fault

    def autocast(self, device: torch.device):
        """bf16 autocast around the steps of ``precision="bf16"`` (the
        program's own precision, a witness); a no-op otherwise."""
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.precision == "bf16")

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision != "fp8":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        low = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (low - x).detach()

    def g(self, y: torch.Tensor) -> torch.Tensor:
        return _GradToFp8.apply(y) if self.precision == "fp8" else y

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return self.g(F.conv2d(self.q(x), self.q(w), b, stride, padding,
                               dilation))

    def linear(self, x, w, b=None):
        return self.g(F.linear(self.q(x), self.q(w), b))

    def bmm(self, a, b, eq: str):
        return self.g(torch.einsum(eq, self.q(a), self.q(b)))


def _slice_conv(w: torch.Tensor, cin: int, cout: Optional[int],
                in_tail: int = 0) -> torch.Tensor:
    if cin < w.shape[1]:
        w = torch.cat([w[:, :cin - in_tail], w[:, w.shape[1] - in_tail:]],
                      1) if in_tail else w[:, :cin]
    return w if cout is None else w[:cout]


def conv(nm: Numerics, P: Params, name: str, x, cout=None, stride=1,
         dilation=1, in_tail=0, padding=None, half_wgrad=False):
    w = _slice_conv(P[name + ".weight"], x.shape[1], cout, in_tail)
    b = P.get(name + ".bias")
    if b is not None:
        b = b[:w.shape[0]]
    k = w.shape[-1]
    pad = dilation * (k - 1) // 2 if padding is None else padding
    if half_wgrad:       # the planted fault: no weight gradient from rows n:
        n = len(x) // 2
        return torch.cat([nm.conv(x[:n], w, b, stride, pad, dilation),
                          nm.conv(x[n:], w.detach(), b, stride, pad,
                                  dilation)])
    return nm.conv(x, w, b, stride, pad, dilation)


def batch_norm(P: Params, name: str, x, train: bool,
               stats: Optional[Dict[str, Any]] = None):
    """Train: batch statistics (recorded into ``stats[name]`` as (mean,
    unbiased var, count) when given); eval: ``P``'s running ones."""
    c = x.shape[1]
    w, b = P[name + ".weight"][:c], P[name + ".bias"][:c]
    dtype, x = x.dtype, x.float()     # statistics in float32
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            n = x.numel() // c
            stats[name] = (mean.detach(), var.detach() * n / max(n - 1, 1))
    else:
        mean = P[name + ".running_mean"][:c]
        var = P[name + ".running_var"][:c]
    inv = torch.rsqrt(var + 1e-5)
    return ((x - mean[None, :, None, None]) * (inv * w)[None, :, None, None]
            + b[None, :, None, None]).to(dtype)


def conv_bn_relu(nm, P, name, x, train, stats, cout=None, stride=1,
                 in_tail=0, relu=True):
    y = batch_norm(P, name + ".bn", conv(nm, P, name + ".conv", x, cout,
                                         stride, in_tail=in_tail), train,
                   stats)
    return F.relu(y) if relu else y


def resize(x, hw):
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def dropout(nm: Numerics, x, p: float, gen: Optional[torch.Generator]):
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=gen, device=x.device,
                   dtype=nm.draw_dtype)
    return x * (u < keep).to(x.dtype) / keep


def layer_norm(P, name, x):
    c = x.shape[-1]
    return F.layer_norm(x, (c,), P[name + ".weight"][:c],
                        P[name + ".bias"][:c], 1e-6)


def cls_seg(nm, P, name, feat, head, train, gen):
    if train and head.get("dropout_ratio", 0.1) > 0:
        feat = dropout(nm, feat, float(head.get("dropout_ratio", 0.1)), gen)
    return conv(nm, P, name + ".conv_seg", feat)


# --------------------------------------------------------------------- #
# the segmentor: backbone, neck, heads, each the part of its config type
# --------------------------------------------------------------------- #
def features(nm, P, img, arch, model_cfg, train, stats=None):
    bb = model_cfg["backbone"]
    feats = parts.get(bb["type"], "backbone").forward(
        nm, P, img, arch["backbone"], bb, train, stats)
    neck = model_cfg.get("neck")
    if neck:
        feats = parts.get(neck["type"], "neck").forward(nm, P, feats, neck,
                                                        train, stats)
    return feats


def _head(nm, P, feats, head, train, stats, gen, name):
    return parts.get(head["type"], "head").forward(nm, P, feats, head, train,
                                                   stats, gen, name)


def head_logits(nm, P, feats, model_cfg, train, stats, gen, aux: bool):
    """[(logits, loss weight)] of the decode head, then the aux head."""
    dec = model_cfg["decode_head"]
    out = [(_head(nm, P, feats, dec, train, stats, gen, "decode_head"),
            float(dec["loss_decode"].get("loss_weight", 1.0)))]
    a = model_cfg.get("auxiliary_head")
    if aux and a:
        out.append((_head(nm, P, feats, a, train, stats, gen,
                          "auxiliary_head"),
                    float(a["loss_decode"].get("loss_weight", 1.0))))
    return out


def upsampled_ce(logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Bilinear upsample to the labels (half-pixel, float32), softmax CE
    averaged over the pixels not labelled 255."""
    up = resize(logits.float(), gt.shape[1:])
    return F.cross_entropy(up, gt.long(), ignore_index=255)


def train_loss(nm, P, img, gt, arch, model_cfg, gen) -> torch.Tensor:
    feats = features(nm, P, img, arch, model_cfg, True)
    return sum(w * upsampled_ce(lg, gt) for lg, w in head_logits(
        nm, P, feats, model_cfg, True, None, gen, aux=True))


# --------------------------------------------------------------------- #
# the parameters' names and MAX shapes
# --------------------------------------------------------------------- #
class Specs:
    """The parameters' names and MAX shapes in the order the parts lay
    them out (``shapes``), and the names of the batch norms among them,
    each with running statistics (``batch_norms``)."""

    def __init__(self):
        self.shapes: List[Tuple[str, Tuple[int, ...]]] = []
        self.batch_norms: List[str] = []

    def add(self, name, shape):
        self.shapes.append((name, tuple(shape)))

    def conv(self, name, cin, cout, k, bias=False):
        self.add(name + ".weight", (cout, cin, k, k))
        if bias:
            self.add(name + ".bias", (cout,))

    def norm(self, name, c):
        """A layer norm: a scale and a shift, no running statistics."""
        self.add(name + ".weight", (c,))
        self.add(name + ".bias", (c,))

    def bn(self, name, c):
        self.norm(name, c)
        self.batch_norms.append(name)

    def cbr(self, name, cin, cout, k):
        self.conv(name + ".conv", cin, cout, k)
        self.bn(name + ".bn", cout)

    def cls_seg(self, name, head):
        self.conv(f"{name}.conv_seg", int(head["channels"]),
                  int(head["num_classes"]), 1, bias=True)


def _specs(model_cfg) -> Specs:
    S = Specs()
    bb = model_cfg["backbone"]
    chans = parts.get(bb["type"], "backbone").specs(bb, S)
    neck = model_cfg.get("neck")
    if neck:
        chans = parts.get(neck["type"], "neck").specs(neck, chans, S)
    for name in ("decode_head", "auxiliary_head"):
        head = model_cfg.get(name)
        if head:
            parts.get(head["type"], "head").specs(head, chans, S, name)
    return S


def param_specs(model_cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    return _specs(model_cfg).shapes


def bn_names(model_cfg) -> List[str]:
    """The batch norms' names (each has running statistics), as the parts
    declare them."""
    return _specs(model_cfg).batch_norms


def as_params(weights: Dict[str, torch.Tensor], requires_grad: bool
              ) -> Params:
    return {k: v.detach().clone().requires_grad_(requires_grad)
            for k, v in weights.items()}

