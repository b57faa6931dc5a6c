"""The two supernets, written out plainly over a dict of MAX-shape tensors
named as the published state dicts name them.

A subnet runs on prefix slices of the MAX parameters (GAIA's dynamic ops):
a conv or linear takes the first ``out`` rows and as many input columns as
its input has, a norm the first channels. The PSP bottleneck's input is
``[elastic features, static pool branches]``: the branches take the LAST
rows of its kernel. Batch norm normalizes with the batch's statistics in
training (biased variance, eps 1e-5) and with the running ones otherwise;
layer norm has eps 1e-6; GELU is exact; attention runs dense with a
float32 softmax at 64 lanes a head. Dropout keeps a value where a uniform
draw in [0, 1) lies below ``1 - p`` and scales it by ``1 / (1 - p)``; the
draws come from the step's generator, in the activation dtype the model
runs in (``Numerics.draw_dtype``), decode head first.

``Numerics("float32")`` is the reference; ``Numerics("fp8")`` the control,
float8 training: its convs and matmuls read both operands rounded to float8
e4m3 and pass their output's gradient back rounded to float8 e5m2 (a scale
per tensor each), with float32 accumulation. ``Numerics(...,
fault="branch_wgrad")`` plants a fault confined to a backward pass: each
bottleneck's 3x3 conv takes its weight gradient from the first half of
the batch only (forward and input gradient whole).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
HEAD_DIM = 64
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


# --------------------------------------------------------------------- #
# DynamicResNet (7x7 stem, bottlenecks), PSP and FCN heads
# --------------------------------------------------------------------- #
def resnet(nm, P, x, arch, cfg, train, stats=None) -> List[torch.Tensor]:
    strides = cfg.get("strides", (1, 2, 2, 2))
    x = conv(nm, P, "backbone.conv1", x, int(arch["stem"]["width"]), 2)
    x = F.relu(batch_norm(P, "backbone.bn1", x, train, stats))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = []
    for i, (w, d) in enumerate(zip(arch["body"]["width"],
                                   arch["body"]["depth"])):
        w = int(w)
        for blk in range(int(d)):
            pre = f"backbone.layer{i + 1}.{blk}."
            s = int(strides[i]) if blk == 0 else 1
            y = F.relu(batch_norm(P, pre + "bn1", conv(
                nm, P, pre + "conv1", x, w), train, stats))
            y = F.relu(batch_norm(P, pre + "bn2", conv(
                nm, P, pre + "conv2", y, w, s,
                half_wgrad=nm.fault == "branch_wgrad"), train, stats))
            y = batch_norm(P, pre + "bn3", conv(nm, P, pre + "conv3", y,
                                                4 * w), train, stats)
            if blk == 0:
                x = batch_norm(P, pre + "downsample.1", conv(
                    nm, P, pre + "downsample.0", x, 4 * w, s, padding=0),
                    train, stats)
            x = F.relu(y + x)
        feats.append(x)
    return feats


def _pyramid(nm, P, name, x, scales, train, stats):
    outs = [x]
    for j, s in enumerate(scales):
        y = F.adaptive_avg_pool2d(x, int(s))
        y = conv_bn_relu(nm, P, f"{name}.psp_modules.{j}.1", y, train, stats)
        outs.append(resize(y, x.shape[2:]))
    return conv_bn_relu(nm, P, f"{name}.bottleneck", torch.cat(outs, 1),
                        train, stats, in_tail=(len(outs) - 1) *
                        P[f"{name}.bottleneck.conv.weight"].shape[0])


def cls_seg(nm, P, name, feat, head, train, gen):
    if train and head.get("dropout_ratio", 0.1) > 0:
        feat = dropout(nm, feat, float(head.get("dropout_ratio", 0.1)), gen)
    return conv(nm, P, name + ".conv_seg", feat)


def psp_head(nm, P, feats, head, train, stats, gen, name="decode_head"):
    x = feats[head.get("in_index", -1)]
    feat = _pyramid(nm, P, name, x, head.get("pool_scales", (1, 2, 3, 6)),
                    train, stats)
    return cls_seg(nm, P, name, feat, head, train, gen)


def fcn_head(nm, P, feats, head, train, stats, gen,
             name="auxiliary_head"):
    x = feats[head.get("in_index", -1)]
    for i in range(int(head.get("num_convs", 2))):
        x = conv_bn_relu(nm, P, f"{name}.convs.{i}", x, train, stats)
    return cls_seg(nm, P, name, x, head, train, gen)


# --------------------------------------------------------------------- #
# ElasticTransformer (ViT), the multi-level neck, the UPer head
# --------------------------------------------------------------------- #
def layer_norm(P, name, x):
    c = x.shape[-1]
    return F.layer_norm(x, (c,), P[name + ".weight"][:c],
                        P[name + ".bias"][:c], 1e-6)


def vit(nm, P, x, arch, cfg, train) -> List[torch.Tensor]:
    p = int(cfg.get("patch_size", 16))
    emb = int(arch["embedding"]["width"])
    enc = arch["encoder"]
    b = x.shape[0]
    gh, gw = x.shape[2] // p, x.shape[3] // p
    x = conv(nm, P, "backbone.patch_embed.proj", x, emb, p, padding=0)
    x = x.flatten(2).transpose(1, 2)
    pos = P["backbone.pos_embed"]
    if pos.shape[1] - 1 != gh * gw:
        raise ValueError("the reference runs the ViT at its own grid only")
    x = x + pos[:, 1:, :emb]
    with_cls = cfg.get("with_cls_token", True)
    if with_cls:
        cls = (P["backbone.cls_token"] + pos[:, :1])[..., :emb]
        x = torch.cat([cls.expand(b, -1, -1), x], 1)
    outs = []
    out_indices = list(cfg.get("out_indices", (2, 5, 8, 11)))
    for i in range(int(cfg.get("depth", 12))):
        if i < int(enc["depth"]):
            pre = f"backbone.blocks.{i}."
            x = x + _attention(nm, P, pre + "attn", layer_norm(
                P, pre + "norm1", x), int(enc["num_heads"][i]))
            f = int(enc["ffn_channels"][i])
            y = layer_norm(P, pre + "norm2", x)
            y = F.gelu(nm.linear(y, P[pre + "mlp.fc1.weight"][:f, :emb],
                                 P[pre + "mlp.fc1.bias"][:f]))
            x = x + nm.linear(y, P[pre + "mlp.fc2.weight"][:emb, :f],
                              P[pre + "mlp.fc2.bias"][:emb])
        if i in out_indices:
            t = x[:, 1:] if with_cls else x
            outs.append(t.transpose(1, 2).reshape(b, emb, gh, gw))
    return outs


def _attention(nm, P, name, x, heads: int):
    b, n, c = x.shape
    w_all, b_all = P[name + ".qkv.weight"], P[name + ".qkv.bias"]
    inner = w_all.shape[0] // 3
    width = heads * HEAD_DIM
    w = w_all.view(3, inner, -1)[:, :width, :c].reshape(3 * width, c)
    bias = b_all.view(3, inner)[:, :width].reshape(-1)
    q, k, v = nm.linear(x, w, bias).view(b, n, 3, heads,
                                         HEAD_DIM).unbind(2)
    logits = nm.bmm(q, k, "bnhd,bmhd->bhnm") / math.sqrt(HEAD_DIM)
    attn = torch.softmax(logits, -1)
    out = nm.bmm(attn, v, "bhnm,bmhd->bnhd").reshape(b, n, width)
    return nm.linear(out, P[name + ".proj.weight"][:c, :width],
                     P[name + ".proj.bias"][:c])


def mln_neck(nm, P, feats, neck):
    outs = []
    scales = neck.get("scales", (0.5, 1, 2, 4))
    for i, (x, s) in enumerate(zip(feats, scales)):
        lat = conv(nm, P, f"neck.lateral_convs.{i}.conv", x)
        h, w = lat.shape[2:]
        outs.append(conv(nm, P, f"neck.convs.{i}.conv",
                         resize(lat, (int(h * s), int(w * s)))))
    return outs


def uper_head(nm, P, feats, head, train, stats, gen, name="decode_head"):
    levels = [feats[i] for i in head.get("in_index", (0, 1, 2, 3))]
    psp = _pyramid(nm, P, name, levels[-1],
                   head.get("pool_scales", (1, 2, 3, 6)), train, stats)
    lats = [conv_bn_relu(nm, P, f"{name}.lateral_convs.{i}", f, train, stats)
            for i, f in enumerate(levels[:-1])] + [psp]
    for i in range(len(lats) - 1, 0, -1):
        lats[i - 1] = lats[i - 1] + resize(lats[i], lats[i - 1].shape[2:])
    outs = [conv_bn_relu(nm, P, f"{name}.fpn_convs.{i}", lat, train, stats)
            for i, lat in enumerate(lats[:-1])] + [lats[-1]]
    outs = [resize(o, outs[0].shape[2:]) for o in outs]
    feat = conv_bn_relu(nm, P, f"{name}.fpn_bottleneck", torch.cat(outs, 1),
                        train, stats)
    return cls_seg(nm, P, name, feat, head, train, gen)


HEADS = {"DynamicPSPHead": psp_head, "DynamicFCNHead": fcn_head,
         "DynamicUPerHead": uper_head}


def features(nm, P, img, arch, model_cfg, train, stats=None):
    bb = model_cfg["backbone"]
    if bb["type"] == "DynamicResNet":
        feats = resnet(nm, P, img, arch["backbone"], bb, train, stats)
    else:
        feats = vit(nm, P, img, arch["backbone"], bb, train)
    if model_cfg.get("neck"):
        feats = mln_neck(nm, P, feats, model_cfg["neck"])
    return feats


def head_logits(nm, P, feats, model_cfg, train, stats, gen, aux: bool):
    """[(logits, loss weight)] of the decode head, then the aux head."""
    dec = model_cfg["decode_head"]
    out = [(HEADS[dec["type"]](nm, P, feats, dec, train, stats, gen),
            float(dec["loss_decode"].get("loss_weight", 1.0)))]
    a = model_cfg.get("auxiliary_head")
    if aux and a:
        out.append((HEADS[a["type"]](nm, P, feats, a, train, stats, gen,
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
def _conv_spec(name, cin, cout, k, bias=False):
    out = [(name + ".weight", (cout, cin, k, k))]
    return out + [(name + ".bias", (cout,))] if bias else out


def _bn_spec(name, c):
    return [(name + ".weight", (c,)), (name + ".bias", (c,))]


def _cbr_spec(name, cin, cout, k):
    return _conv_spec(name + ".conv", cin, cout, k) + _bn_spec(name + ".bn",
                                                               cout)


def _head_spec(head, chans, name) -> List[Tuple[str, Tuple[int, ...]]]:
    ch, classes = int(head["channels"]), int(head["num_classes"])
    scales = head.get("pool_scales", (1, 2, 3, 6))
    out = []
    if head["type"] == "DynamicPSPHead":
        c = chans[head.get("in_index", -1)]
        for j in range(len(scales)):
            out += _cbr_spec(f"{name}.psp_modules.{j}.1", c, ch, 1)
        out += _cbr_spec(f"{name}.bottleneck", c + len(scales) * ch, ch, 3)
    elif head["type"] == "DynamicUPerHead":
        ins = [chans[i] for i in head.get("in_index", (0, 1, 2, 3))]
        for j in range(len(scales)):
            out += _cbr_spec(f"{name}.psp_modules.{j}.1", ins[-1], ch, 1)
        out += _cbr_spec(f"{name}.bottleneck", ins[-1] + len(scales) * ch,
                         ch, 3)
        for i, c in enumerate(ins[:-1]):
            out += _cbr_spec(f"{name}.lateral_convs.{i}", c, ch, 1)
            out += _cbr_spec(f"{name}.fpn_convs.{i}", ch, ch, 3)
        out += _cbr_spec(f"{name}.fpn_bottleneck", len(ins) * ch, ch, 3)
    elif head["type"] == "DynamicFCNHead":
        c = chans[head.get("in_index", -1)]
        for i in range(int(head.get("num_convs", 2))):
            out += _cbr_spec(f"{name}.convs.{i}", c if i == 0 else ch, ch,
                             int(head.get("kernel_size", 3)))
        if head.get("concat_input", True):
            raise ValueError("the reference has no FCN conv_cat")
    else:
        raise ValueError(head["type"])
    return out + _conv_spec(f"{name}.conv_seg", ch, classes, 1, bias=True)


def param_specs(model_cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    bb = model_cfg["backbone"]
    out = []
    if bb["type"] == "DynamicResNet":
        sw = int(bb.get("stem_width", 64))
        out += _conv_spec("backbone.conv1", 3, sw, 7)
        out += _bn_spec("backbone.bn1", sw)
        cin, chans = sw, []
        for i, (w, d) in enumerate(zip(bb["body_width"], bb["body_depth"])):
            for blk in range(d):
                pre = f"backbone.layer{i + 1}.{blk}."
                out += _conv_spec(pre + "conv1", cin, w, 1)
                out += _bn_spec(pre + "bn1", w)
                out += _conv_spec(pre + "conv2", w, w, 3)
                out += _bn_spec(pre + "bn2", w)
                out += _conv_spec(pre + "conv3", w, 4 * w, 1)
                out += _bn_spec(pre + "bn3", 4 * w)
                if blk == 0:
                    out += _conv_spec(pre + "downsample.0", cin, 4 * w, 1)
                    out += _bn_spec(pre + "downsample.1", 4 * w)
                cin = 4 * w
            chans.append(cin)
    else:
        emb, depth = int(bb.get("embed_dim", 768)), int(bb.get("depth", 12))
        inner = int(bb.get("num_heads", 12)) * HEAD_DIM
        ffn = int(bb.get("ffn_ratio", 4.0) * emb)
        p = int(bb.get("patch_size", 16))
        grid = int(bb.get("img_size", 224)) // p
        out += _conv_spec("backbone.patch_embed.proj", 3, emb, p, bias=True)
        out.append(("backbone.pos_embed", (1, grid * grid + 1, emb)))
        if bb.get("with_cls_token", True):
            out.append(("backbone.cls_token", (1, 1, emb)))
        for i in range(depth):
            pre = f"backbone.blocks.{i}."
            out += _bn_spec(pre + "norm1", emb)
            out += [(pre + "attn.qkv.weight", (3 * inner, emb)),
                    (pre + "attn.qkv.bias", (3 * inner,)),
                    (pre + "attn.proj.weight", (emb, inner)),
                    (pre + "attn.proj.bias", (emb,))]
            out += _bn_spec(pre + "norm2", emb)
            out += [(pre + "mlp.fc1.weight", (ffn, emb)),
                    (pre + "mlp.fc1.bias", (ffn,)),
                    (pre + "mlp.fc2.weight", (emb, ffn)),
                    (pre + "mlp.fc2.bias", (emb,))]
        chans = [emb] * len(bb.get("out_indices", (2, 5, 8, 11)))
    neck = model_cfg.get("neck")
    if neck:
        oc = int(neck["out_channels"])
        for i, c in enumerate(chans):
            out += _conv_spec(f"neck.lateral_convs.{i}.conv", c, oc, 1, True)
        for i in range(len(neck.get("scales", (0.5, 1, 2, 4)))):
            out += _conv_spec(f"neck.convs.{i}.conv", oc, oc, 3, True)
        chans = [oc] * len(neck.get("scales", (0.5, 1, 2, 4)))
    out += _head_spec(model_cfg["decode_head"], chans, "decode_head")
    if model_cfg.get("auxiliary_head"):
        out += _head_spec(model_cfg["auxiliary_head"], chans,
                          "auxiliary_head")
    return out


def bn_names(model_cfg) -> List[str]:
    """The batch norms' names (each has running statistics): every norm
    but the ViT's layer norms."""
    return [n[:-len(".weight")] for n, s in param_specs(model_cfg)
            if n.endswith(".weight") and len(s) == 1 and ".norm" not in n]


def as_params(weights: Dict[str, torch.Tensor], requires_grad: bool
              ) -> Params:
    return {k: v.detach().clone().requires_grad_(requires_grad)
            for k, v in weights.items()}

