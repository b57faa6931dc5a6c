"""ElasticTransformer: the elastic ViT supernet backbone, elastic by slicing.

Port of ``gaiaseg_tpu/models/backbones/elastic_transformer.py``: a conv
patch embed, (resized) position embeddings and an optional cls token,
pre-norm encoder layers with multi-head attention of fixed head width 64
and an exact-GELU FFN, outputs reshaped to ``[N, C, H/p, W/p]`` maps at
``out_indices``. The arch ``{'embedding': {'width'}, 'encoder': {'depth',
'num_heads': [L], 'ffn_channels': [L]}}`` picks the active embed width, the
layer count and each layer's heads and FFN width; a layer runs on prefix
slices of the MAX-shape parameters (heads are a prefix of the MAX heads),
where the JAX module masks.

Parameter names follow timm/mmseg (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.norm1/attn.qkv/attn.proj/norm2/mlp.fc1/
mlp.fc2``; q, k and v are the row ranges ``[0, h*64)``, ``[inner, inner +
h*64)`` and ``[2*inner, 2*inner + h*64)`` of the fused ``qkv`` weight), so
a converted ViT checkpoint loads as it is.

Attention takes the flash kernels (``ops/cuda/flash_attention.py``) under
the JAX gate: ``use_flash``, a CUDA tensor, a sequence length that is a
multiple of 128 and no relative positions. With the cls token a 512x512
crop at patch 16 has 1025 tokens, so the flash route needs
``with_cls_token=False`` (1024 tokens).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cuda.flash_attention import flash_attention
from ...ops.dynamic_layers import DynConv2d, DynLayerNorm, DynLinear
from ...utils.registry import BACKBONES

HEAD_DIM = 64   # fixed head width; heads are elastic


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (``jax.image``'s
    bicubic), of ``|distance|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=32)
def bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` float32 weights of ``jax.image.resize(...,
    'bicubic')`` along one axis: half-pixel centres, the kernel widened by
    the inverse scale when shrinking (antialias), each column normalised
    to sum 1 (``jax/_src/image/scale.py`` ``compute_weight_mat``)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(in_size)[:, None])
                    / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_pos_grid(grid: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """``[1, g*g, C]`` grid position embeddings -> ``[1, H*W, C]`` by the
    separable bicubic weights, as two matmuls."""
    g = int(round(math.sqrt(grid.shape[1])))
    rows = torch.from_numpy(bicubic_matrix(g, out_hw[0])).to(grid)
    cols = torch.from_numpy(bicubic_matrix(g, out_hw[1])).to(grid)
    out = torch.einsum("ihc,iy,hx->yxc", grid.reshape(g, g, -1), rows, cols)
    return out.reshape(1, out_hw[0] * out_hw[1], -1)


class ElasticMHA(nn.Module):
    """Multi-head self-attention over the first ``num_heads`` heads of the
    MAX ``qkv``/``proj`` weights and the active embed width."""

    def __init__(self, embed_dim: int, max_heads: int,
                 use_flash: bool = False):
        super().__init__()
        self.max_heads = int(max_heads)
        self.use_flash = bool(use_flash)
        inner = self.max_heads * HEAD_DIM
        self.qkv = DynLinear(embed_dim, 3 * inner)
        self.proj = DynLinear(inner, embed_dim)

    def forward(self, x: torch.Tensor, num_heads: int) -> torch.Tensor:
        b, n, c = x.shape
        inner, width = self.max_heads * HEAD_DIM, num_heads * HEAD_DIM
        w, bias = self.qkv.weight, self.qkv.bias
        if num_heads < self.max_heads:   # rows of the active heads of q, k, v
            w = torch.cat([w[i * inner:i * inner + width] for i in range(3)])
            bias = torch.cat([bias[i * inner:i * inner + width]
                              for i in range(3)])
        qkv = F.linear(x, w[:, :c], bias).view(b, n, 3, num_heads, HEAD_DIM)
        q, k, v = qkv.unbind(2)          # [B, N, h, 64] strided views
        scale = 1.0 / math.sqrt(HEAD_DIM)
        if self.use_flash and x.is_cuda and n % 128 == 0:
            out = flash_attention(q * scale, k, v)
        else:
            logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * scale
            attn = torch.softmax(logits, dim=-1).to(q.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self.proj(out.reshape(b, n, width), c)


class ElasticEncoderLayer(nn.Module):
    """Pre-norm transformer layer: x + attn(norm1(x)), then + mlp(norm2)."""

    def __init__(self, embed_dim: int, max_heads: int, max_ffn: int,
                 use_flash: bool = False):
        super().__init__()
        self.norm1 = DynLayerNorm(embed_dim)
        self.attn = ElasticMHA(embed_dim, max_heads, use_flash)
        self.norm2 = DynLayerNorm(embed_dim)
        self.mlp = nn.ModuleDict({"fc1": DynLinear(embed_dim, max_ffn),
                                  "fc2": DynLinear(max_ffn, embed_dim)})

    def forward(self, x: torch.Tensor, num_heads: int,
                ffn_channels: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), num_heads)
        z = self.mlp["fc1"](self.norm2(x), ffn_channels)
        return x + self.mlp["fc2"](F.gelu(z), x.shape[-1])  # exact (erf)


@BACKBONES.register_module(name=["ElasticTransformer", "ElasticTransformer1"])
class ElasticTransformer(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, ffn_ratio: float = 4.0,
                 patch_size: int = 16, img_size: int = 224,
                 out_indices: Sequence[int] = (2, 5, 8, 11),
                 with_cls_token: bool = True, use_flash: bool = False,
                 with_rel_pos: bool = False, rel_max_dist: int = 14,
                 drop_rate: float = 0.0):
        super().__init__()
        waiting = {"with_rel_pos": with_rel_pos, "drop_rate": drop_rate > 0}
        if any(waiting.values()):
            raise NotImplementedError(
                f"ElasticTransformer options "
                f"{[k for k, v in waiting.items() if v]} wait for a later "
                "slice of the port")
        self.embed_dim = int(embed_dim)
        self.depth = int(depth)
        self.num_heads = int(num_heads)
        self.max_ffn = int(ffn_ratio * embed_dim)
        self.patch_size = int(patch_size)
        self.ref_grid = int(img_size) // self.patch_size
        self.with_cls_token = bool(with_cls_token)
        self.out_indices = [i if i >= 0 else self.depth + i
                            for i in out_indices]
        self.patch_embed = nn.ModuleDict({"proj": DynConv2d(
            3, self.embed_dim, self.patch_size, self.patch_size, bias=True,
            padding=0)})
        # the cls slot of pos_embed exists with or without the cls token
        self.pos_embed = nn.Parameter(torch.empty(
            1, self.ref_grid ** 2 + 1, self.embed_dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        if self.with_cls_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, self.embed_dim))
            nn.init.trunc_normal_(self.cls_token, std=0.02)
        self.blocks = nn.ModuleList([
            ElasticEncoderLayer(self.embed_dim, self.num_heads, self.max_ffn,
                                use_flash) for _ in range(self.depth)])

    @staticmethod
    def max_arch_of(cfg: Dict[str, Any]) -> Dict[str, Any]:
        """Nested arch dict at MAX, from a backbone config."""
        embed, depth = int(cfg.get("embed_dim", 768)), int(cfg.get("depth",
                                                                   12))
        return {"embedding": {"width": embed},
                "encoder": {"depth": depth,
                            "num_heads": [int(cfg.get("num_heads", 12))]
                            * depth,
                            "ffn_channels": [int(cfg.get("ffn_ratio", 4.0)
                                                 * embed)] * depth}}

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim for _ in self.out_indices)

    def _check_arch(self, emb, depth, heads, ffns) -> None:
        ok = 1 <= emb <= self.embed_dim and 1 <= depth <= self.depth \
            and len(heads) == len(ffns) == self.depth \
            and all(1 <= h <= self.num_heads for h in heads[:depth]) \
            and all(1 <= f <= self.max_ffn for f in ffns[:depth])
        if not ok:
            raise ValueError(f"arch (width {emb}, depth {depth}, heads "
                             f"{heads}, ffn {ffns}) is outside the MAX net")

    def forward(self, x: torch.Tensor,
                arch: Dict[str, Any]) -> List[torch.Tensor]:
        emb = int(arch["embedding"]["width"])
        enc = arch["encoder"]
        depth = int(enc["depth"])
        heads = [int(h) for h in enc["num_heads"]]
        ffns = [int(f) for f in enc["ffn_channels"]]
        self._check_arch(emb, depth, heads, ffns)
        b = x.shape[0]
        gh, gw = x.shape[2] // self.patch_size, x.shape[3] // self.patch_size
        x = self.patch_embed["proj"](x, emb).flatten(2).transpose(1, 2)
        cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (self.ref_grid, self.ref_grid):
            grid_pos = resize_pos_grid(grid_pos, (gh, gw))
        x = x + grid_pos[..., :emb]
        if self.with_cls_token:
            cls = (self.cls_token + cls_pos)[..., :emb]
            x = torch.cat([cls.expand(b, -1, -1).to(x.dtype), x], dim=1)

        def as_map(t: torch.Tensor) -> torch.Tensor:
            t = t[:, 1:] if self.with_cls_token else t
            return t.transpose(1, 2).reshape(b, emb, gh, gw)

        outs = []
        for i in range(self.depth):
            if i < depth:   # a layer past the active depth passes x on
                x = self.blocks[i](x, heads[i], ffns[i])
            if i in self.out_indices:
                outs.append(as_map(x))
        if not outs:
            outs.append(as_map(x))
        return outs
