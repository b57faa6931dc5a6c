"""BEiT: the static ViT backbone of the distillation teacher.

Port of ``gaiaseg_tpu/models/backbones/beit.py``: a conv patch embed and a
cls token, pre-norm blocks (LayerNorm eps 1e-6, a fused ``qkv`` weight with
separate q and v biases and the k bias fixed at zero, per-block or shared
2D relative-position bias tables, layer-scale ``gamma_1``/``gamma_2``, an
exact-GELU MLP), the token maps at ``out_indices`` (duplicates allowed) and
the four FPN adapters of the patch-16 variant: ``fpn1`` = deconv x2, a
LayerNorm over the channels, tanh-GELU (flax's ``nn.gelu`` default, where
the blocks use the exact one), deconv x2; ``fpn2`` = deconv x2; ``fpn3``
the map as it is; ``fpn4`` a 2x2 max pool.

Parameter names follow the official BEiT layout (``patch_embed.proj``,
``cls_token``, ``blocks.{i}.norm1/attn.qkv/attn.q_bias/attn.v_bias/
attn.proj/attn.relative_position_bias_table/gamma_1/norm2/mlp.fc1/mlp.fc2/
gamma_2``, a shared ``rel_pos_bias.relative_position_bias_table``), so a
reference teacher's backbone loads with no converter but the table
surgery (``engine/ckpt_surgery.py``); the adapters are ``fpn1.{0,1,3}`` and
``fpn2.0``, the reference's Sequential slots. The index into the tables is
a buffer left out of the state dict.

JAX sizes the tables at the first call, from the train crop; here the
window is fixed at construction from ``img_size`` (the builder fills it
from the config's crop), and an input of another grid raises. The
attention adds the bias, so it runs as matmuls and a float32 softmax, off
the flash kernels, as the JAX module does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dynamic_layers import DynChannelLayerNorm, _pair
from ...utils.registry import BACKBONES


def relative_position_index(h: int, w: int) -> np.ndarray:
    """BEiT window relative-position index incl. cls token:
    [(h*w+1), (h*w+1)] into a table of (2h-1)*(2w-1)+3 entries."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                  indexing="ij"))      # [2, h, w]
    flat = coords.reshape(2, -1)                        # [2, hw]
    rel = flat[:, :, None] - flat[:, None, :]           # [2, hw, hw]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    num = (2 * h - 1) * (2 * w - 1)
    idx = np.zeros((h * w + 1, h * w + 1), np.int32)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num
    idx[0:, 0] = num + 1
    idx[0, 0] = num + 2
    return idx


def table_rows(window: Tuple[int, int]) -> int:
    return (2 * window[0] - 1) * (2 * window[1] - 1) + 3


def _linear(d_in: int, d_out: int, bias: bool = True) -> nn.Linear:
    lin = nn.Linear(d_in, d_out, bias=bias)
    nn.init.trunc_normal_(lin.weight, std=0.02)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def gather_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``[heads, N+1, N+1]`` of a ``[rows, heads]`` table at the flattened
    index ``[(N+1)^2]``, gathered head-major so the result is contiguous
    (JAX's ``table[idx].transpose(2, 0, 1)``, the same values)."""
    n = int(round(index.numel() ** 0.5))
    return table.t()[:, index].reshape(-1, n, n)


class BEiTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 window: Optional[Tuple[int, int]]):
        super().__init__()
        self.num_heads = int(num_heads)
        self.qkv = _linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = _linear(dim, dim)
        if window is not None:
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(table_rows(window), num_heads))

    def forward(self, x: torch.Tensor,
                rel_bias: Optional[torch.Tensor]) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias).view(b, n, 3,
                                                      self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)    # [B, heads, N, hd]
        attn = torch.matmul(q, k.transpose(-2, -1)) / hd ** 0.5
        if rel_bias is not None:
            attn = attn + rel_bias[None].to(attn.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        return self.proj(out)


class BEiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 init_values: float, window: Optional[Tuple[int, int]]):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BEiTAttention(dim, num_heads, window)
        self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.ModuleDict({"fc1": _linear(dim, hidden),
                                  "fc2": _linear(hidden, dim)})
        self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor,
                rel_bias: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rel_bias) * self.gamma_1
        z = F.gelu(self.mlp["fc1"](self.norm2(x)))        # exact (erf)
        return x + self.mlp["fc2"](z) * self.gamma_2


@BACKBONES.register_module(name=["BEiT", "Beit"])
class BEiT(nn.Module):
    # JAX names the timm patch embedding's conv ``patch_embed``
    jax_names = {"patch_embed.proj": "patch_embed"}

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 mlp_ratio: float = 4.0, init_values: float = 0.1,
                 use_rel_pos_bias: bool = True,
                 use_shared_rel_pos_bias: bool = False,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 img_size: Union[int, Sequence[int]] = 512):
        super().__init__()
        d = int(embed_dim)
        self.embed_dim, self.depth = d, int(depth)
        self.patch_size = int(patch_size)
        h, w = _pair(img_size)
        self.window = (h // self.patch_size, w // self.patch_size)
        self.out_indices = [i if i >= 0 else self.depth + i
                            for i in out_indices]
        if len(self.out_indices) != 4 or not all(
                0 <= i < self.depth for i in self.out_indices):
            raise ValueError(f"BEiT's FPN adapters take 4 out_indices of "
                             f"its {self.depth} blocks, got "
                             f"{list(out_indices)}")
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, self.patch_size,
                                          self.patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        shared = bool(use_shared_rel_pos_bias)
        per_block = bool(use_rel_pos_bias) and not shared
        self.rel_pos_bias = None
        if shared:      # the tables start at zero, as in JAX
            self.rel_pos_bias = nn.Module()
            self.rel_pos_bias.relative_position_bias_table = nn.Parameter(
                torch.zeros(table_rows(self.window), num_heads))
        self.blocks = nn.ModuleList([
            BEiTBlock(d, num_heads, mlp_ratio, init_values,
                      self.window if per_block else None)
            for _ in range(self.depth)])
        if shared or per_block:
            self.register_buffer("relative_position_index", torch.from_numpy(
                relative_position_index(*self.window).reshape(-1)
                .astype(np.int64)), persistent=False)
        else:
            self.relative_position_index = None

        def deconv():
            return nn.ConvTranspose2d(d, d, 2, 2)
        # flax's nn.gelu (fpn1) is the tanh form, the blocks' the exact one
        self.fpn1 = nn.Sequential(deconv(), DynChannelLayerNorm(d),
                                  nn.GELU(approximate="tanh"), deconv())
        self.fpn2 = nn.Sequential(deconv())
        self.fpn3 = nn.Identity()
        self.fpn4 = nn.MaxPool2d(2, 2)

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim for _ in self.out_indices)

    def forward(self, x: torch.Tensor, arch: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """``[N,3,H,W]`` -> four maps ``[N, D, .]`` at strides 4, 8, 16, 32
        of the patch grid's 16. ``arch`` and ``generator`` are ignored (the
        teacher is static and draws nothing)."""
        b = x.shape[0]
        gh, gw = x.shape[2] // self.patch_size, x.shape[3] // self.patch_size
        if (gh, gw) != self.window and self.relative_position_index \
                is not None:
            raise ValueError(
                f"BEiT was built for a {self.window} patch grid (img_size "
                f"{self.window[0] * self.patch_size}x"
                f"{self.window[1] * self.patch_size}); the input gives "
                f"{(gh, gw)}")
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype), x], 1)
        idx = self.relative_position_index
        shared = None if self.rel_pos_bias is None else gather_bias(
            self.rel_pos_bias.relative_position_bias_table, idx)
        feats = {}
        for i, blk in enumerate(self.blocks):
            bias = shared
            if hasattr(blk.attn, "relative_position_bias_table"):
                bias = gather_bias(blk.attn.relative_position_bias_table, idx)
            x = blk(x, bias)
            if i in self.out_indices:
                feats[i] = x[:, 1:].transpose(1, 2).reshape(
                    b, self.embed_dim, gh, gw)
        outs = [feats[i] for i in self.out_indices]
        return [self.fpn1(outs[0]), self.fpn2(outs[1]), self.fpn3(outs[2]),
                self.fpn4(outs[3])]
