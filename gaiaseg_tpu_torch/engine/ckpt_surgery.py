"""Checkpoint surgery: resolution transfer for BEiT / ViT checkpoints.

A copy of ``gaiaseg_tpu/engine/ckpt_surgery.py`` (the reference's
``deal_with_position_embedding``) on the port's state dicts: stale
``relative_position_index`` buffers are dropped, each
``relative_position_bias_table`` is resampled onto the new window's
relative-coordinate grid through the geometric-progression coordinates
(scipy's cubic ``RegularGridInterpolator``), and absolute ``pos_embed``
grids are resized with ``jax.image.resize``'s bicubic weights (Keys a =
-0.5, antialiased when shrinking: ``bicubic_matrix``), not
``F.interpolate``'s (a = -0.75, no antialias).

numpy / scipy on the host, once at load.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.backbones.elastic_transformer import bicubic_matrix

EXTRA_ROWS = 3      # cls-to-token, token-to-cls, cls-to-cls


def _geometric_coords(n_side: int, dst_side: int) -> np.ndarray:
    """Geometric-progression sample coordinates (reference :60-88): build a
    symmetric grid whose spacing grows geometrically from the center so the
    resampled table extrapolates gracefully beyond the source extent."""
    def geometric(n, span):
        # find ratio q with sum of gp(1..n) == span
        lo, hi = 1.0001, 1.1
        for _ in range(100):
            q = (lo + hi) / 2
            gp = (q ** (n // 2) - 1) / (q - 1)
            if gp > span:
                hi = q
            else:
                lo = q
        q = (lo + hi) / 2
        dis = []
        cur = 1.0
        for i in range(n // 2):
            dis.append(cur)
            cur += q ** (i + 1)
        r_ids = [-d for d in reversed(dis)]
        return r_ids + ([0] if n % 2 else []) + dis

    return np.asarray(geometric(n_side, dst_side // 2), np.float64)


def resample_rel_pos_bias_table(table: np.ndarray, src_size: int,
                                dst_size: int) -> np.ndarray:
    """[ (2*src-1)**2 + extra, heads ] -> [ (2*dst-1)**2 + extra, heads ].

    The last ``extra`` rows (cls-token interactions) pass through unchanged
    (reference :55-98 keeps num_extra_tokens=3).
    """
    from scipy import interpolate
    n_src = 2 * src_size - 1
    n_dst = 2 * dst_size - 1
    heads = table.shape[1]
    body = table[: n_src * n_src].reshape(n_src, n_src, heads)
    extra_rows = table[n_src * n_src:]

    # source coords: geometric progression covering the dst half-extent
    src_coords = _geometric_coords(n_src, n_dst)
    dst_half = (n_dst - 1) // 2
    dst_coords = np.arange(-dst_half, dst_half + 1, dtype=np.float64)
    out = np.zeros((n_dst, n_dst, heads), table.dtype)
    for h in range(heads):
        f = interpolate.RegularGridInterpolator(
            (src_coords, src_coords), body[:, :, h].astype(np.float64),
            bounds_error=False, fill_value=None, method="cubic")
        yy, xx = np.meshgrid(dst_coords, dst_coords, indexing="ij")
        out[:, :, h] = f(np.stack([yy, xx], -1))
    return np.concatenate([out.reshape(n_dst * n_dst, heads), extra_rows], 0)


def table_window(rows: int) -> int:
    """The square window of a table of ``(2s-1)**2 + 3`` rows."""
    return (int(round((rows - EXTRA_ROWS) ** 0.5)) + 1) // 2


def resize_pos_embed(pos: np.ndarray, src_grid: Tuple[int, int],
                     dst_grid: Tuple[int, int],
                     num_prefix_tokens: int = 1) -> np.ndarray:
    """Bicubic [1, src_h*src_w + p, C] -> [1, dst_h*dst_w + p, C]
    (reference :101-123), with ``jax.image.resize``'s weights."""
    prefix = pos[:, :num_prefix_tokens]
    c = pos.shape[-1]
    grid = pos[0, num_prefix_tokens:].reshape(src_grid[0], src_grid[1], c)
    rows = bicubic_matrix(int(src_grid[0]), int(dst_grid[0]))
    cols = bicubic_matrix(int(src_grid[1]), int(dst_grid[1]))
    out = np.einsum("ijc,iy,jx->yxc", grid.astype(np.float32), rows, cols)
    return np.concatenate(
        [prefix, out.reshape(1, dst_grid[0] * dst_grid[1], c)
         .astype(pos.dtype)], axis=1)


def surgery_beit_checkpoint(state_dict: Dict[str, torch.Tensor],
                            dst_window: int) -> Dict[str, torch.Tensor]:
    """A BEiT state dict for a ``dst_window`` square patch grid: every
    ``relative_position_bias_table`` of another window resampled (the
    source window read from its row count), every
    ``relative_position_index`` dropped; the rest as it is."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith("relative_position_index"):
            continue
        if k.endswith("relative_position_bias_table"):
            src = table_window(v.shape[0])
            if src != dst_window:
                v = torch.from_numpy(resample_rel_pos_bias_table(
                    v.detach().cpu().float().numpy(), src, dst_window))
        out[k] = v
    return out
