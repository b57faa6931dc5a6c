"""ElasticMixViT: the SegFormer-style hierarchical transformer supernet,
elastic by slicing.

Port of ``gaiaseg_tpu/models/backbones/elastic_mixvit.py``. Four stages,
each an overlapping patch embed (a 7x7/4 conv with padding 3 in stage 0,
3x3/2 with padding 1 after it, each with a bias) and its LayerNorm, then
blocks of spatial-reduction attention and MixFFN, then the stage's output
LayerNorm ``out_norm{i}``. Every LayerNorm has eps 1e-6.

- ``SRAttention``: q from the tokens; k and v from the tokens pooled by the
  ``sr`` conv (kernel = stride = ``sr_ratio``, no padding, a bias) and its
  LayerNorm ``sr_norm`` when ``sr_ratio > 1``; heads of dim 32. The scores
  ``q . k`` are divided by ``sqrt(32)`` and go through a float32 softmax
  (float64 for float64 inputs), as JAX's dense einsums, then back to the
  compute type. k's bias is not added: a bias on every key of a row moves
  no softmax (the official BEiT layout drops it for that reason), so its
  exact gradient is zero and it takes none.
- ``MixFFN``: ``fc1`` to the FFN width, a 3x3 depthwise conv ``dwconv``
  with a bias, flax's tanh GELU, ``fc2`` back to the stage width.

The arch ``{'body': {'width': [4], 'depth': [4], 'num_heads': [4],
'ffn_ratio10': [4]}}`` picks each stage's active width, depth, heads and
FFN ratio (times 10). q, k and v take the input columns of the active width
and the output rows of the active heads (``num_heads * 32``, which may
exceed the width); ``proj`` the reverse. The FFN width is ``ratio10 *
width // 10``. A block past the stage's depth passes its input on (JAX's
``where(active, out, x)``), so it is not run.

Parameter names are JAX's in PyTorch form: ``patch{i}``, ``patch_norm{i}``,
``stage{i}_block{j}.{norm1, attn.{q, k, v, sr, sr_norm, proj}, norm2,
ffn.{fc1, dwconv, fc2}}``, ``out_norm{i}``; linear weights are ``[out,
in]``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dynamic_layers import DynConv2d, DynLayerNorm, DynLinear
from ...utils.registry import BACKBONES

HEAD_DIM = 32


def _to_map(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Tokens ``[B, H*W, C]`` -> map ``[B, C, H, W]``."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *hw)


class SRAttention(nn.Module):
    """Self-attention with the keys and values taken from a map reduced by
    a strided conv."""

    def __init__(self, dim: int, max_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.max_heads = int(max_heads)
        self.sr_ratio = int(sr_ratio)
        inner = self.max_heads * HEAD_DIM
        self.q = DynLinear(dim, inner)
        self.k = DynLinear(dim, inner)
        self.v = DynLinear(dim, inner)
        self.proj = DynLinear(inner, dim)
        if self.sr_ratio > 1:
            self.sr = DynConv2d(dim, dim, self.sr_ratio, self.sr_ratio,
                                bias=True, padding=0)
            self.sr_norm = DynLayerNorm(dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                num_heads: int) -> torch.Tensor:
        b, n, c = x.shape
        width = num_heads * HEAD_DIM
        kv = x
        if self.sr_ratio > 1:
            kv = self.sr_norm(self.sr(_to_map(x, hw), c).flatten(2)
                              .transpose(1, 2))

        def heads(t):                    # [B, M, h*32] -> [B, h, M, 32]
            return t.view(b, -1, num_heads, HEAD_DIM).transpose(1, 2)

        q = heads(self.q(x, width))
        # k's bias adds one value to every score of a row, which moves no
        # softmax: its gradient is zero in exact arithmetic and rounding
        # noise otherwise, so it is left out (it stays in the state dict)
        k = heads(F.linear(kv, self.k.weight[:width, :c]))
        v = heads(self.v(kv, width))
        wide = torch.promote_types(q.dtype, torch.float32)
        scores = torch.matmul(q, k.transpose(-1, -2)).to(wide) \
            / math.sqrt(HEAD_DIM)
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, width)
        return self.proj(out, c)


class MixFFN(nn.Module):
    def __init__(self, dim: int, max_ffn: int):
        super().__init__()
        self.fc1 = DynLinear(dim, max_ffn)
        self.dwconv = DynConv2d(max_ffn, max_ffn, 3, 1, bias=True,
                                groups=max_ffn)
        self.fc2 = DynLinear(max_ffn, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                ffn_channels: int) -> torch.Tensor:
        y = self.dwconv(_to_map(self.fc1(x, ffn_channels), hw))
        y = F.gelu(y.flatten(2).transpose(1, 2), approximate="tanh")
        return self.fc2(y, x.shape[-1])


class MixViTBlock(nn.Module):
    def __init__(self, dim: int, max_heads: int, max_ffn: int,
                 sr_ratio: int = 1):
        super().__init__()
        self.norm1 = DynLayerNorm(dim)
        self.attn = SRAttention(dim, max_heads, sr_ratio)
        self.norm2 = DynLayerNorm(dim)
        self.ffn = MixFFN(dim, max_ffn)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int], num_heads: int,
                ffn_channels: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw, num_heads)
        return x + self.ffn(self.norm2(x), hw, ffn_channels)


@BACKBONES.register_module(name=["ElasticMixViT", "ElasticSegFormer"])
class ElasticMixViT(nn.Module):
    def __init__(self, widths: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 4, 6, 3),
                 num_heads: Sequence[int] = (2, 4, 10, 16),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 ffn_ratio10: int = 40,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 in_chans: int = 3):
        super().__init__()
        self.widths = [int(w) for w in widths]
        self.depths = [int(d) for d in depths]
        self.num_heads = [int(h) for h in num_heads]
        self.sr_ratios = [int(s) for s in sr_ratios]
        self.ffn_ratio10 = int(ffn_ratio10)
        self.out_indices = tuple(int(i) for i in out_indices)
        prev = int(in_chans)
        for i, dim in enumerate(self.widths):
            k, s = (7, 4) if i == 0 else (3, 2)
            self.add_module(f"patch{i}", DynConv2d(prev, dim, k, s,
                                                   bias=True))
            self.add_module(f"patch_norm{i}", DynLayerNorm(dim))
            max_ffn = self.ffn_ratio10 * dim // 10
            for j in range(self.depths[i]):
                self.add_module(f"stage{i}_block{j}", MixViTBlock(
                    dim, self.num_heads[i], max_ffn, self.sr_ratios[i]))
            self.add_module(f"out_norm{i}", DynLayerNorm(dim))
            prev = dim

    @staticmethod
    def max_arch_of(cfg: Dict[str, Any]) -> Dict[str, Any]:
        """Nested arch dict at MAX, from a backbone config."""
        return {"body": {
            "width": [int(w) for w in cfg.get("widths", (64, 128, 320, 512))],
            "depth": [int(d) for d in cfg.get("depths", (3, 4, 6, 3))],
            "num_heads": [int(h) for h in cfg.get("num_heads",
                                                  (2, 4, 10, 16))],
            "ffn_ratio10": [int(cfg.get("ffn_ratio10", 40))] * 4}}

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.widths[i] for i in self.out_indices)

    def forward(self, x: torch.Tensor, arch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """Per-stage NCHW maps at ``out_indices``; ``generator`` is the
        step's (this backbone draws nothing)."""
        body = arch["body"]
        widths = [int(w) for w in body["width"]]
        depths = [int(d) for d in body["depth"]]
        heads = [int(h) for h in body["num_heads"]]
        ratios = [int(r) for r in body["ffn_ratio10"]]
        for i in range(4):
            ffn = ratios[i] * widths[i] // 10
            if not (1 <= widths[i] <= self.widths[i]
                    and 0 <= depths[i] <= self.depths[i]
                    and 1 <= heads[i] <= self.num_heads[i]
                    and 1 <= ffn <= self.ffn_ratio10 * self.widths[i] // 10):
                raise ValueError(
                    f"stage {i} arch (width {widths[i]}, depth {depths[i]}, "
                    f"heads {heads[i]}, ffn {ffn}) is outside the MAX net")
        outs = []
        for i in range(4):
            x = getattr(self, f"patch{i}")(x, widths[i])
            hw = (x.shape[2], x.shape[3])
            x = getattr(self, f"patch_norm{i}")(x.flatten(2).transpose(1, 2))
            ffn = ratios[i] * widths[i] // 10
            for j in range(depths[i]):
                x = getattr(self, f"stage{i}_block{j}")(x, hw, heads[i], ffn)
            x = _to_map(getattr(self, f"out_norm{i}")(x), hw)
            if i in self.out_indices:
                outs.append(x)
        return outs
