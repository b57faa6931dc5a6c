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

``drop_rate`` is JAX's ``pos_drop``: dropout on the tokens after the cls
concat, in training only, drawn from the step's generator.

``with_rel_pos`` adds JAX's 2D relative positions to every layer
(``ElasticRelativePosition2D``): per layer a score-side table pair
``attn.rel_pos_embed_k.{rel_rows,rel_cols}`` and a value-side pair
``attn.rel_pos_embed_v.{rel_rows,rel_cols}``, each ``[2 * rel_max_dist +
2, 64]``, indexed by the clipped row and column distances of two tokens
(the last entry is the cls token's). The score ``q . (T_r[dr] + T_c[dc])``
is added unscaled to the scaled ``q . k`` logits; the value side ``sum_j
attn[i, j] (T_r[dr] + T_c[dc])`` is added to each active head's output
before ``proj``. A row distance depends only on the two tokens' rows, so
both sides run on per-row and per-column groups of the keys (``[n, gh +
1, 64]`` gathered tables); no ``[n, n, 64]`` tensor is built.

Attention takes the flash kernels (``ops/cuda/flash_attention.py``) under
the JAX gate: ``use_flash``, a CUDA tensor, a sequence length that is a
multiple of 128 and no relative positions. With the cls token a 512x512
crop at patch 16 has 1025 tokens, so the flash route needs
``with_cls_token=False`` (1024 tokens).

Under tensor parallelism (``parallel.mesh.shard_state`` over K model
ranks) the attention and the FFN of a layer run as Megatron pairs when
the heads split evenly and there are no relative positions: rank ``m``
holds the q, k and v rows of heads ``[m*H/K, (m+1)*H/K)`` of ``qkv`` and
the matching input columns of ``proj``, and FFN rows ``[m*F/K,
(m+1)*F/K)`` of ``fc1`` with those columns of ``fc2``. The active heads
and FFN width stay prefixes: a rank works on the part of the prefix in its
shard (possibly none, when its zero-width products still join the
collectives) and the flash kernels run on its active heads.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cuda.flash_attention import flash_attention
from ...ops.dropout import dropout
from ...ops.dynamic_layers import DynConv2d, DynLayerNorm, DynLinear
from ...parallel.tensor_parallel import copy_to_model, row_linear
from ...utils.registry import BACKBONES
from ...utils.tracing import region

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


def relative_index_2d(gh: int, gw: int, max_dist: int,
                      with_cls: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Clipped row and column distance indices ``[N, N]`` of a ``gh x gw``
    grid (a copy of the JAX function): entries ``0 .. 2*max_dist`` are the
    distances ``clip(a - b, -max_dist, max_dist) + max_dist``, and with the
    cls token (token 0) its row and column hold ``2*max_dist + 1``."""
    rows = np.arange(gh).repeat(gw)
    cols = np.tile(np.arange(gw), gh)
    dr = np.clip(rows[:, None] - rows[None, :], -max_dist, max_dist) \
        + max_dist
    dc = np.clip(cols[:, None] - cols[None, :], -max_dist, max_dist) \
        + max_dist
    if with_cls:
        cls_idx = 2 * max_dist + 1
        n = gh * gw + 1
        full_r = np.full((n, n), cls_idx, np.int32)
        full_c = np.full((n, n), cls_idx, np.int32)
        full_r[1:, 1:] = dr
        full_c[1:, 1:] = dc
        return full_r, full_c
    return dr.astype(np.int32), dc.astype(np.int32)


@functools.lru_cache(maxsize=16)
def relative_groups(gh: int, gw: int, max_dist: int,
                    with_cls: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The table index of each (query, key group): ``[N, G_r]`` for the
    row groups (the cls key, then one group per grid row) and ``[N, G_c]``
    for the column groups. ``relative_index_2d``'s ``[i, j]`` entry is the
    entry of ``j``'s group: row groups are keys ``[0], [1, 1 + gw), ...``,
    column groups ``[0], {1, 1 + gw, ...}, ...`` (without the cls token,
    the same less the first group and the offset 1)."""
    rel_r, rel_c = relative_index_2d(gh, gw, max_dist, with_cls)
    off = int(with_cls)
    rep_r = [0] * off + [off + y * gw for y in range(gh)]
    rep_c = [0] * off + [off + x for x in range(gw)]
    return (rel_r[:, rep_r].astype(np.int64),
            rel_c[:, rep_c].astype(np.int64))


def expand_groups(s_r: torch.Tensor, s_c: torch.Tensor,
                  with_cls: bool) -> torch.Tensor:
    """Per-group values ``[..., G_r]`` and ``[..., G_c]`` -> their sum at
    every key ``[..., N]`` (key ``1 + y*gw + x`` takes row group ``y`` and
    column group ``x``)."""
    if not with_cls:
        return (s_r[..., :, None] + s_c[..., None, :]).flatten(-2)
    grid = (s_r[..., 1:, None] + s_c[..., None, 1:]).flatten(-2)
    return torch.cat([s_r[..., :1] + s_c[..., :1], grid], dim=-1)


def sum_groups(attn: torch.Tensor, gh: int, gw: int, with_cls: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adjoint of ``expand_groups``: ``attn [..., N]`` summed over the
    keys of each row group and of each column group."""
    off = int(with_cls)
    grid = attn[..., off:].unflatten(-1, (gh, gw))
    a_r, a_c = grid.sum(-1), grid.sum(-2)
    if with_cls:
        a_r = torch.cat([attn[..., :1], a_r], dim=-1)
        a_c = torch.cat([attn[..., :1], a_c], dim=-1)
    return a_r, a_c


class ElasticRelativePosition2D(nn.Module):
    """A row table and a column table of per-distance embeddings (JAX
    ``ElasticRelativePosition2D``): ``R[i, j] = T_r[dr] + T_c[dc]``.
    ``index`` is ``(groups_r, groups_c, gh, gw, with_cls)`` with the groups
    of ``relative_groups`` on the device."""

    def __init__(self, max_dist: int = 14, head_dim: int = HEAD_DIM):
        super().__init__()
        entries = 2 * int(max_dist) + 2     # + the cls slot
        self.rel_rows = nn.Parameter(torch.empty(entries, head_dim))
        self.rel_cols = nn.Parameter(torch.empty(entries, head_dim))
        nn.init.trunc_normal_(self.rel_rows, std=0.02)
        nn.init.trunc_normal_(self.rel_cols, std=0.02)

    def _tables(self, index, dtype):
        groups_r, groups_c = index[:2]
        return F.embedding(groups_r, self.rel_rows).to(dtype), \
            F.embedding(groups_c, self.rel_cols).to(dtype)   # [N, G, d]

    def scores(self, q: torch.Tensor, index) -> torch.Tensor:
        """``q [B, N, h, d]`` -> ``q_i . R[i, j]`` as ``[B, h, N, N]``."""
        e_r, e_c = self._tables(index, q.dtype)
        s_r = torch.einsum("bnhd,ngd->bhng", q, e_r)
        s_c = torch.einsum("bnhd,ngd->bhng", q, e_c)
        return expand_groups(s_r, s_c, index[4])

    def values(self, attn: torch.Tensor, index) -> torch.Tensor:
        """``attn [B, h, N, N]`` -> ``sum_j attn[i, j] R[i, j]`` as ``[B,
        N, h, d]``."""
        e_r, e_c = self._tables(index, attn.dtype)
        a_r, a_c = sum_groups(attn, index[2], index[3], index[4])
        return torch.einsum("bhng,ngd->bnhd", a_r, e_r) \
            + torch.einsum("bhng,ngd->bnhd", a_c, e_c)


def _local_width(active: int, per_rank: int, index: int) -> int:
    """The part of an active prefix of ``active`` that falls in the shard
    ``[index * per_rank, (index + 1) * per_rank)``."""
    return min(max(active - index * per_rank, 0), per_rank)


class ElasticMHA(nn.Module):
    """Multi-head self-attention over the first ``num_heads`` heads of the
    MAX ``qkv``/``proj`` weights and the active embed width, with JAX's
    relative positions when ``with_rel_pos``. ``tp_megatron = (m, K)``
    (set by ``shard_state``) runs it as a column/row pair on model rank
    ``m``'s heads."""

    # the JAX leaves of the fused qkv, and the Megatron pair (column, row)
    jax_fused = {"qkv": ("w_q", "w_k", "w_v")}
    tp_pair = ("qkv", "proj")
    tp_megatron = None

    def __init__(self, embed_dim: int, max_heads: int,
                 use_flash: bool = False, with_rel_pos: bool = False,
                 rel_max_dist: int = 14):
        super().__init__()
        self.max_heads = int(max_heads)
        self.use_flash = bool(use_flash)
        inner = self.max_heads * HEAD_DIM
        self.qkv = DynLinear(embed_dim, 3 * inner)
        self.proj = DynLinear(inner, embed_dim)
        self.rel_pos_embed_k = self.rel_pos_embed_v = None
        if with_rel_pos:
            self.rel_pos_embed_k = ElasticRelativePosition2D(rel_max_dist)
            self.rel_pos_embed_v = ElasticRelativePosition2D(rel_max_dist)

    def megatron_split(self, k: int) -> bool:
        """Whether the pair runs as Megatron layers over ``k`` ranks: whole
        heads a rank and no relative-position tables (whose gradient every
        head adds to)."""
        return self.max_heads % k == 0 and self.rel_pos_embed_k is None

    def forward(self, x: torch.Tensor, num_heads: int,
                rel_index=None) -> torch.Tensor:
        """The active heads of this rank's shard (all of them in one
        process): its rows of q, k and v and of the replicated bias,
        attention on them, its columns of ``proj``; under a Megatron pair
        the partial outputs are summed over the model group before
        ``proj``'s bias."""
        m, k = self.tp_megatron or (0, 1)
        b, n, c = x.shape
        per = self.max_heads // k
        heads = _local_width(num_heads, per, m)
        width = heads * HEAD_DIM
        x, bias = copy_to_model(k, x, self.qkv.bias)
        w = self.qkv.weight.view(3, per * HEAD_DIM, -1)[:, :width, :c]
        off = m * per * HEAD_DIM
        bias = bias.view(3, -1)[:, off:off + width]
        qkv = F.linear(x, w.reshape(3 * width, c), bias.reshape(-1))
        q, k_, v = qkv.view(b, n, 3, heads, HEAD_DIM).unbind(2)
        # no head here: the empty products still carry the input's gradient
        out = self._attend(q, k_, v, rel_index) if heads else q + k_ + v
        return row_linear(k, out.reshape(b, n, width),
                          self.proj.weight[:c, :width], self.proj.bias[:c])

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                rel_index) -> torch.Tensor:
        """Attention of ``q``, ``k``, ``v`` ``[B, N, h, 64]`` -> ``[B, N,
        h, 64]``: the flash kernels under the gate, else dense (the range
        and counter ``attention.flash`` or ``attention.dense``)."""
        n = q.shape[1]
        scale = 1.0 / math.sqrt(HEAD_DIM)
        rel = self.rel_pos_embed_k is not None and rel_index is not None
        if self.use_flash and q.is_cuda and n % 128 == 0 and not rel:
            with region("attention.flash"):
                return flash_attention(q * scale, k, v)
        with region("attention.dense"):
            # float32 logits and softmax (float64 for float64 inputs)
            wide = torch.promote_types(q.dtype, torch.float32)
            logits = torch.einsum("bnhd,bmhd->bhnm", q, k).to(wide) * scale
            if rel:      # unscaled, as JAX adds it
                logits = logits + self.rel_pos_embed_k.scores(
                    q, rel_index).to(wide)
            attn = torch.softmax(logits, dim=-1).to(q.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
            if rel:
                out = out + self.rel_pos_embed_v.values(attn, rel_index)
            return out


class ElasticEncoderLayer(nn.Module):
    """Pre-norm transformer layer: x + attn(norm1(x)), then + mlp(norm2).
    ``gelu`` is the MLP's GELU: ``'none'`` the exact (erf) form of the
    ViT's layers, ``'tanh'`` flax's default of Conformer's blocks.
    ``tp_megatron = (m, K)`` runs the FFN as a column/row pair on model
    rank ``m``'s features."""

    tp_pair = ("mlp.fc1", "mlp.fc2")
    tp_megatron = None

    @staticmethod
    def megatron_split(k: int) -> bool:
        return True      # the rule shards fc1/fc2 only when K divides F

    def __init__(self, embed_dim: int, max_heads: int, max_ffn: int,
                 use_flash: bool = False, with_rel_pos: bool = False,
                 rel_max_dist: int = 14, gelu: str = "none"):
        super().__init__()
        self.gelu = gelu
        self.norm1 = DynLayerNorm(embed_dim)
        self.attn = ElasticMHA(embed_dim, max_heads, use_flash, with_rel_pos,
                               rel_max_dist)
        self.norm2 = DynLayerNorm(embed_dim)
        self.mlp = nn.ModuleDict({"fc1": DynLinear(embed_dim, max_ffn),
                                  "fc2": DynLinear(max_ffn, embed_dim)})

    def forward(self, x: torch.Tensor, num_heads: int,
                ffn_channels: int, rel_index=None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), num_heads, rel_index)
        return x + self._mlp(self.norm2(x), ffn_channels)

    def _mlp(self, x: torch.Tensor, ffn: int) -> torch.Tensor:
        """The FFN on this rank's features (all of them in one process):
        its rows of ``fc1`` and of the replicated bias in the active
        width, its columns of ``fc2``; under a Megatron pair the partial
        outputs are summed over the model group before ``fc2``'s bias."""
        m, k = self.tp_megatron or (0, 1)
        fc1, fc2 = self.mlp["fc1"], self.mlp["fc2"]
        per = fc1.weight.shape[0]
        f = _local_width(ffn, per, m)
        c = x.shape[-1]
        x, b1 = copy_to_model(k, x, fc1.bias)
        z = F.linear(x, fc1.weight[:f, :c], b1[m * per:m * per + f])
        return row_linear(k, F.gelu(z, approximate=self.gelu),
                          fc2.weight[:c, :f], fc2.bias[:c])


@BACKBONES.register_module(name=["ElasticTransformer", "ElasticTransformer1"])
class ElasticTransformer(nn.Module):
    # JAX names the timm patch embedding's conv ``patch_embed``
    jax_names = {"patch_embed.proj": "patch_embed"}

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, ffn_ratio: float = 4.0,
                 patch_size: int = 16, img_size: int = 224,
                 out_indices: Sequence[int] = (2, 5, 8, 11),
                 with_cls_token: bool = True, use_flash: bool = False,
                 with_rel_pos: bool = False, rel_max_dist: int = 14,
                 drop_rate: float = 0.0):
        super().__init__()
        self.with_rel_pos = bool(with_rel_pos)
        self.rel_max_dist = int(rel_max_dist)
        self.drop_rate = float(drop_rate)
        self._rel_index = {}     # (grid, device) -> the groups on the device
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
                                use_flash, self.with_rel_pos,
                                self.rel_max_dist)
            for _ in range(self.depth)])

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

    def _relative_index(self, gh: int, gw: int, device: torch.device):
        """The layers' ``rel_index`` for a ``gh x gw`` grid, uploaded once
        a device (an upload a forward would wait on the card's queue)."""
        key = (gh, gw, str(device))
        if key not in self._rel_index:
            groups = relative_groups(gh, gw, self.rel_max_dist,
                                     self.with_cls_token)
            self._rel_index[key] = tuple(
                torch.from_numpy(g).to(device) for g in groups) + (
                gh, gw, self.with_cls_token)
        return self._rel_index[key]

    def forward(self, x: torch.Tensor, arch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """``generator`` draws ``pos_drop`` in training."""
        emb = int(arch["embedding"]["width"])
        enc = arch["encoder"]
        depth = int(enc["depth"])
        heads = [int(h) for h in enc["num_heads"]]
        ffns = [int(f) for f in enc["ffn_channels"]]
        self._check_arch(emb, depth, heads, ffns)
        b = x.shape[0]
        gh, gw = x.shape[2] // self.patch_size, x.shape[3] // self.patch_size
        x = self.patch_embed["proj"](x, emb).flatten(2).transpose(1, 2)
        pos = self.pos_embed     # one read (a gather under tensor parallelism)
        cls_pos, grid_pos = pos[:, :1], pos[:, 1:]
        if (gh, gw) != (self.ref_grid, self.ref_grid):
            grid_pos = resize_pos_grid(grid_pos, (gh, gw))
        x = x + grid_pos[..., :emb]
        if self.with_cls_token:
            cls = (self.cls_token + cls_pos)[..., :emb]
            x = torch.cat([cls.expand(b, -1, -1).to(x.dtype), x], dim=1)
        if self.training and self.drop_rate > 0:
            x = dropout(x, self.drop_rate, generator)
        rel_index = self._relative_index(gh, gw, x.device) \
            if self.with_rel_pos else None

        def as_map(t: torch.Tensor) -> torch.Tensor:
            t = t[:, 1:] if self.with_cls_token else t
            return t.transpose(1, 2).reshape(b, emb, gh, gw)

        outs = []
        for i in range(self.depth):
            if i < depth:   # a layer past the active depth passes x on
                x = self.blocks[i](x, heads[i], ffns[i], rel_index)
            if i in self.out_indices:
                outs.append(as_map(x))
        if not outs:
            outs.append(as_map(x))
        return outs
