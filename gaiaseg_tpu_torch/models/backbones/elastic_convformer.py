"""ElasticConvformer: the dual-branch (CNN + transformer) supernet backbone,
elastic by slicing.

Port of ``gaiaseg_tpu/models/backbones/elastic_convformer.py``: a 7x7/2
stem conv, BN, ReLU and a 3x3/2 max pool; a first bottleneck ``conv_1``
beside a patch conv ``trans_patch_conv`` whose tokens, behind a cls token,
go through ``trans_1``; three depth-elastic stages of fusion blocks, each a
CNN bottleneck whose mid feature is average-pooled into tokens (FCU down:
1x1 ``squeeze_conv`` with bias, LayerNorm, tanh GELU, a zero cls slot,
added to the token stream), a transformer block on the tokens, and the
tokens expanded back (FCU up: 1x1 ``expand_conv`` with bias, BN, ReLU, a
bilinear resize) and added to the mid feature of a second bottleneck; then
a last fusion block that downsamples in its second bottleneck. The
outputs are the CNN branch's four maps.

The arch is JAX's nested meta: ``stem.width``, ``body.depth[3]``,
``body.block.convblock.width[3]``, ``body.block.embed_dim.width``,
``body.block.transblock.MHA.num_heads[3]`` and
``body.block.transblock.FFN.feedforward_channels[3]`` (ten times the FFN
ratio of the ACTIVE embed width). A bottleneck of width ``w`` runs its two
inner convs at ``w // 4``; a stage runs its first ``depth`` fusion blocks
(a block past the depth passes both branches on). ``norm_eval`` (the
default, as in JAX) keeps every BN of the backbone in eval mode under
``train()``: they normalize with their running statistics and never update
them. The transformer blocks are the ViT's pre-norm layers (fused ``qkv``,
heads of 64) with a tanh GELU.

Names follow JAX's modules in PyTorch form: ``conv1``, ``bn1``,
``conv_1``, ``trans_patch_conv``, ``cls_token``, ``trans_1``,
``stages.{s}.{b}`` and ``last_fusion``; a bottleneck's ``conv{1,2,3}``,
``bn{1,2,3}``, ``conv_res``, ``bn_res``; a transformer block's timm names
``norm1``, ``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp.fc1``,
``mlp.fc2``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dynamic_layers import DynBatchNorm, DynConv2d, DynLayerNorm
from ...ops.resize import resize_bilinear
from ...utils.registry import BACKBONES
from .elastic_transformer import ElasticEncoderLayer


def trans_block(embed_dim: int, max_heads: int,
                max_ffn: int) -> ElasticEncoderLayer:
    """Conformer's transformer block: the ViT's layer with a tanh GELU."""
    return ElasticEncoderLayer(embed_dim, max_heads, max_ffn, gelu="tanh")


class ElasticConvBlock(nn.Module):
    """The CNN branch's bottleneck; returns (out, mid feature)."""

    def __init__(self, inplanes: int, outplanes: int, stride: int = 1,
                 res_conv: bool = False):
        super().__init__()
        med = outplanes // 4
        self.conv1 = DynConv2d(inplanes, med, 1)
        self.bn1 = DynBatchNorm(med)
        self.conv2 = DynConv2d(med, med, 3, stride)
        self.bn2 = DynBatchNorm(med)
        self.conv3 = DynConv2d(med, outplanes, 1)
        self.bn3 = DynBatchNorm(outplanes)
        if res_conv:
            self.conv_res = DynConv2d(inplanes, outplanes, 1, stride)
            self.bn_res = DynBatchNorm(outplanes)
        else:
            self.conv_res = self.bn_res = None

    def forward(self, x: torch.Tensor, width: int,
                x_t_r: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        med = width // 4
        y = F.relu(self.bn1(self.conv1(x, med)))
        mid = F.relu(self.bn2(self.conv2(y, med)))
        # FCU up: the expanded tokens join the mid feature before conv3
        y = mid if x_t_r is None else mid + x_t_r
        y = self.bn3(self.conv3(y, width))
        residual = x if self.conv_res is None \
            else self.bn_res(self.conv_res(x, width))
        return F.relu(y + residual), mid


class FusionBlock(nn.Module):
    """One CNN <-> transformer fusion step. ``last_fusion``: the first
    bottleneck runs at stride 1 and the second one downsamples (and holds
    ``res_conv``)."""

    def __init__(self, inplanes: int, outplanes: int, embed_dim: int,
                 max_heads: int, max_ffn: int, dw_stride: int,
                 stride: int = 1, res_conv: bool = False,
                 last_fusion: bool = False):
        super().__init__()
        med = outplanes // 4
        self.dw_stride = int(dw_stride)
        self.fusion_stride = stride if last_fusion else 1
        self.cnn_block = ElasticConvBlock(
            inplanes, outplanes, 1 if last_fusion else stride,
            res_conv and not last_fusion)
        self.squeeze_conv = DynConv2d(med, embed_dim, 1, bias=True)
        self.squeeze_ln = DynLayerNorm(embed_dim)
        self.trans_block = trans_block(embed_dim, max_heads, max_ffn)
        self.expand_conv = DynConv2d(embed_dim, med, 1, bias=True)
        self.expand_bn = DynBatchNorm(med)
        self.fusion_block = ElasticConvBlock(
            outplanes, outplanes, self.fusion_stride,
            res_conv and last_fusion)

    def forward(self, x: torch.Tensor, x_t: torch.Tensor, width: int,
                num_heads: int, ffn_channels: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, emb = x_t.shape[0], x_t.shape[2]
        out, mid = self.cnn_block(x, width)
        # FCU down (the pool floors, as JAX's VALID window)
        tok = mid if self.dw_stride == 1 \
            else F.avg_pool2d(mid, self.dw_stride, self.dw_stride)
        tok = self.squeeze_conv(tok, emb)
        gh, gw = tok.shape[2:]
        tok = F.gelu(self.squeeze_ln(tok.flatten(2).transpose(1, 2)),
                     approximate="tanh")
        tok = torch.cat([torch.zeros_like(tok[:, :1]), tok], dim=1)
        x_t = self.trans_block(tok + x_t, num_heads, ffn_channels)
        # FCU up
        grid = x_t[:, 1:].transpose(1, 2).reshape(b, emb, gh, gw)
        up = F.relu(self.expand_bn(self.expand_conv(grid, width // 4)))
        up = resize_bilinear(up, (out.shape[2] // self.fusion_stride,
                                  out.shape[3] // self.fusion_stride))
        return self.fusion_block(out, width, x_t_r=up)[0], x_t


@BACKBONES.register_module()
class ElasticConvformer(nn.Module):
    def __init__(self, stem_width: int = 64,
                 body_width: Sequence[int] = (256, 512, 1024),
                 body_depth: Sequence[int] = (4, 4, 4),
                 embed_dim: int = 576, num_heads: int = 9,
                 mlp_ratio: int = 40, patch_size: int = 16,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 norm_eval: bool = True):
        super().__init__()
        self.stem_width = int(stem_width)
        self.body_width = [int(w) for w in body_width]
        self.body_depth = [int(d) for d in body_depth]
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.mlp_ratio = int(mlp_ratio)
        self.out_indices = tuple(int(i) for i in out_indices)
        self.norm_eval = bool(norm_eval)
        max_ffn = self.mlp_ratio * self.embed_dim // 10
        bw = self.body_width
        self.conv1 = DynConv2d(3, self.stem_width, 7, 2)
        self.bn1 = DynBatchNorm(self.stem_width)
        self.conv_1 = ElasticConvBlock(self.stem_width, bw[0], 1, True)
        dw = int(patch_size) // 4
        self.trans_patch_conv = DynConv2d(self.stem_width, self.embed_dim,
                                          dw, dw, bias=True, padding=0)
        self.cls_token = nn.Parameter(torch.empty(1, 1, self.embed_dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        self.trans_1 = trans_block(self.embed_dim, self.num_heads, max_ffn)
        dw_strides = (dw, dw // 2, max(dw // 4, 1))
        self.stages = nn.ModuleList()
        for si, (planes, depth) in enumerate(zip(bw, self.body_depth)):
            down = si > 0      # each later stage opens at stride 2
            self.stages.append(nn.ModuleList([FusionBlock(
                bw[si - 1] if down and bi == 0 else planes, planes,
                self.embed_dim, self.num_heads, max_ffn, dw_strides[si],
                stride=2 if down and bi == 0 else 1,
                res_conv=down and bi == 0) for bi in range(depth)]))
        self.last_fusion = FusionBlock(
            bw[2], bw[2], self.embed_dim, self.num_heads, max_ffn,
            dw_strides[2], stride=2, res_conv=True, last_fusion=True)

    @staticmethod
    def max_arch_of(cfg: Dict[str, Any]) -> Dict[str, Any]:
        """JAX's nested arch at MAX, from a backbone config."""
        heads = int(cfg.get("num_heads", 9))
        ratio = int(cfg.get("mlp_ratio", 40))
        return {
            "stem": {"width": int(cfg.get("stem_width", 64))},
            "body": {
                "depth": [int(d) for d in cfg.get("body_depth", (4, 4, 4))],
                "block": {
                    "convblock": {"width": [int(w) for w in cfg.get(
                        "body_width", (256, 512, 1024))]},
                    "embed_dim": {"width": int(cfg.get("embed_dim", 576))},
                    "transblock": {
                        "MHA": {"num_heads": [heads] * 3},
                        "FFN": {"feedforward_channels": [ratio] * 3}}}}}

    def out_channels(self) -> Tuple[int, ...]:
        chans = self.body_width + [self.body_width[-1]]
        return tuple(chans[i] for i in self.out_indices)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, DynBatchNorm):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor, arch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """``generator`` is unused: the backbone draws nothing."""
        stem_w = int(arch["stem"]["width"])
        body, block = arch["body"], arch["body"]["block"]
        depths = [int(d) for d in body["depth"]]
        widths = [int(w) for w in block["convblock"]["width"]]
        emb = int(block["embed_dim"]["width"])
        heads = [int(h) for h in block["transblock"]["MHA"]["num_heads"]]
        ffcs = [int(f) for f in
                block["transblock"]["FFN"]["feedforward_channels"]]
        ffns = [f * emb // 10 for f in ffcs]     # of the ACTIVE embed width
        max_ffn = self.mlp_ratio * self.embed_dim // 10
        ok = 1 <= stem_w <= self.stem_width \
            and 1 <= emb <= self.embed_dim and all(
                1 <= depths[i] <= self.body_depth[i]
                and 4 <= widths[i] <= self.body_width[i]
                and 1 <= heads[i] <= self.num_heads
                and 1 <= ffns[i] <= max_ffn for i in range(3))
        if not ok:
            raise ValueError(f"arch {arch} is outside the MAX net")
        b = x.shape[0]
        x = F.relu(self.bn1(self.conv1(x, stem_w)))
        x_base = F.max_pool2d(x, 3, 2, 1)
        x = self.conv_1(x_base, widths[0])[0]
        tok = self.trans_patch_conv(x_base, emb).flatten(2).transpose(1, 2)
        cls = self.cls_token[..., :emb].expand(b, -1, -1).to(tok.dtype)
        x_t = self.trans_1(torch.cat([cls, tok], dim=1), heads[0], ffns[0])
        outs = []
        for si, stage in enumerate(self.stages):
            for block_m in stage[:depths[si]]:
                x, x_t = block_m(x, x_t, widths[si], heads[si], ffns[si])
            outs.append(x)
        x = self.last_fusion(x, x_t, widths[2], heads[2], ffns[2])[0]
        outs.append(x)
        return [outs[i] for i in self.out_indices]
