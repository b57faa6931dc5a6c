"""Fused bilinear-upsample + softmax cross-entropy, with its two CUDA kernels.

Port of ``gaiaseg_tpu/ops/pallas/resize_ce.py``. The mmseg loss resizes the
head's logits to LABEL resolution before the CE; only the scalar loss and
the gradient at SOURCE resolution are wanted, so the full-resolution logits
need never be written.

The JAX split is kept. Bilinear resize is separable, ``up = A_H @ src @
A_W``: the width interpolation ``mid = logits @ A_W`` (``[N, h, C, W]``
float32) and its adjoint are torch matmuls, as the JAX package left them to
XLA; the row interpolation, logsumexp, pick and the reductions are the
kernels of ``csrc/resize_ce.cu``:

- K1 ``resize_ce_sums`` (replaces ``_fwd_kernel`` via ``_sums``): the sum of
  the CE over valid pixels and the number of valid pixels, in one launch
  that keeps its per-block partial sums and its ticket in a workspace held
  here, one per (card, stream).
- K2 ``resize_ce_grad_mid`` (replaces ``_bwd_kernel`` via ``_frc_bwd``): the
  gradient at the mid rows.

``fused_resize_ce`` is the ``torch.autograd.Function`` over both. A wrapper
takes its kernel's plain torch version (the ``*_reference`` functions) only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Interpolation runs in float32 whatever the logits' dtype, as in the JAX
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...parallel.distributed import sum_over_ranks
from ...utils.tracing import count, counters
from . import build
from .build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)

# K2's launches of its any-C instance (every class count but 19), beside
# ``launch.resize_ce_bwd``, which counts both: ``launch.resize_ce_bwd.any``
# in the tracer's rows, 0 in those of a 19-class model
ANY_C_LAUNCHES = counters("launch.resize_ce_bwd", ("any",))


def interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32: column X holds the (<=2-tap) half-pixel
    bilinear weights with edge clamp (``gaiaseg_tpu`` ``_interp_matrix``)."""
    A = np.zeros((in_size, out_size), np.float32)
    if in_size == out_size:
        np.fill_diagonal(A, 1.0)
        return A
    scale = in_size / out_size
    for X in range(out_size):
        fx = (X + 0.5) * scale - 0.5
        lo = int(np.floor(fx))
        w = fx - lo
        A[min(max(lo, 0), in_size - 1), X] += 1.0 - w
        A[min(max(lo + 1, 0), in_size - 1), X] += w
    return A


@functools.lru_cache(maxsize=64)
def _interp_tensor(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(interp_matrix(in_size, out_size)).to(device)


def supports_fused_resize_ce(src_hw, out_hw, align_corners: bool) -> bool:
    """Static gate: integer even row factor >= 2, >= 3 source rows, and the
    half-pixel (align_corners=False) grid."""
    h, _ = src_hw
    H, _ = out_hw
    return (not align_corners) and h >= 3 and H % h == 0 \
        and (H // h) % 2 == 0 and H // h >= 2


def _f32(device: torch.device):
    """Interpolation stays float32 inside a bf16 autocast region."""
    return torch.autocast(device.type, enabled=False)


def width_interp(logits: torch.Tensor, out_w: int) -> torch.Tensor:
    """``[N, C, h, w]`` logits -> ``mid`` ``[N, h, C, W]`` float32."""
    A_W = _interp_tensor(logits.shape[3], out_w, logits.device)
    with _f32(logits.device):
        return torch.matmul(logits.float().permute(0, 2, 1, 3), A_W)


def _up_rows(mid: torch.Tensor, out_h: int) -> torch.Tensor:
    A_H = _interp_tensor(mid.shape[1], out_h, mid.device)
    return torch.einsum("nhcX,hY->nYcX", mid.float(), A_H)    # [N, H, C, W]


def resize_ce_sums_reference(mid: torch.Tensor, label: torch.Tensor,
                             out_h: int, ignore_index: int = 255
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (sum of CE over valid pixels, valid count)."""
    with _f32(mid.device):
        up = _up_rows(mid, out_h)
        valid = label != ignore_index
        safe = torch.where(valid, label, 0).long()
        lse = torch.logsumexp(up, dim=2)
        pick = up.gather(2, safe[:, :, None, :]).squeeze(2)
        validf = valid.float()
        return ((lse - pick) * validf).sum(), validf.sum()


def resize_ce_grad_mid_reference(mid: torch.Tensor, label: torch.Tensor,
                                 scale: torch.Tensor, out_h: int,
                                 ignore_index: int = 255) -> torch.Tensor:
    """Plain version of K2: the row-interpolation adjoint of
    ``(softmax - onehot) * valid * scale``."""
    with _f32(mid.device):
        up = _up_rows(mid, out_h)
        valid = label != ignore_index
        safe = torch.where(valid, label, 0).long()
        onehot = F.one_hot(safe, up.shape[2]).permute(0, 1, 3, 2).float()
        d = (torch.softmax(up, dim=2) - onehot) \
            * (valid[:, :, None, :].float() * scale.float().reshape(()))
        A_H = _interp_tensor(mid.shape[1], out_h, mid.device)
        return torch.einsum("nYcX,hY->nhcX", d, A_H)


def _check(mid: torch.Tensor, label: torch.Tensor, out_h: int) -> int:
    """Validate the kernels' inputs; returns the row factor f."""
    if mid.dtype != torch.float32 or mid.dim() != 4 \
            or not mid.is_contiguous():
        raise ValueError("mid must be a contiguous float32 [N, h, C, W] "
                         f"tensor, got {mid.dtype} {tuple(mid.shape)}")
    n, h, c, w = mid.shape
    if label.dtype != torch.int32 or not label.is_contiguous() \
            or tuple(label.shape) != (n, out_h, w):
        raise ValueError(f"label must be a contiguous int32 [{n}, {out_h}, "
                         f"{w}] tensor, got {label.dtype} "
                         f"{tuple(label.shape)}")
    if label.device != mid.device:
        raise ValueError("mid and label lie on different devices")
    if not supports_fused_resize_ce((h, w), (out_h, w), False):
        raise ValueError(f"rows {h} -> {out_h} fail the fused resize+CE gate")
    if c > 256:
        raise ValueError(f"the kernels take at most 256 classes, got {c}")
    return out_h // h


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (built at the
    first launch, never at import)."""
    return bind(build.load("resize_ce"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``resize_ce`` library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.resize_ce_fwd_partials.argtypes = [i, i, i]
    lib.resize_ce_fwd_partials.restype = i
    lib.resize_ce_fwd.argtypes = [p, p, p, i, p, i, i, i, i, i, i, p]
    lib.resize_ce_fwd.restype = i
    lib.resize_ce_bwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.resize_ce_bwd.restype = i
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


# K1's workspaces by (card, stream): the blocks' partial sums and the ticket
# that finds the last block. Zeroed once; each launch leaves its ticket at 0,
# and launches on one stream run in turn, so a stream needs one workspace.
_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}


def _fwd_workspace(words: int, device: torch.device,
                   stream: int) -> torch.Tensor:
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < words:
        ws = _WORKSPACES[key] = torch.zeros(words, dtype=torch.int32,
                                            device=device)
    return ws


def resize_ce_sums(mid: torch.Tensor, label: torch.Tensor, out_h: int,
                   ignore_index: int = 255
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (sum of CE over valid pixels, valid count) as 0-d tensors."""
    if mid.device.type == "cpu":
        return resize_ce_sums_reference(mid, label, out_h, ignore_index)
    if mid.device.type != "cuda":
        raise ValueError(f"resize_ce_sums runs on cuda or cpu, not "
                         f"{mid.device.type}")
    f = _check(mid, label, out_h)
    n, h, c, w = mid.shape
    lib = _lib()
    sums = torch.empty(2, dtype=torch.float32, device=mid.device)
    with torch.cuda.device(mid.device):    # launch on mid's card
        stream = torch.cuda.current_stream().cuda_stream
        work = _fwd_workspace(lib.resize_ce_fwd_partials(n, h, w),
                              mid.device, stream)
        err = lib.resize_ce_fwd(mid.data_ptr(), label.data_ptr(),
                                work.data_ptr(), work.numel(),
                                sums.data_ptr(), n, h, c, w, f, ignore_index,
                                stream)
    _raise_on(err, "resize_ce_fwd")
    count("launch.resize_ce_fwd")
    return sums[0], sums[1]


def resize_ce_grad_mid(mid: torch.Tensor, label: torch.Tensor,
                       scale: torch.Tensor, out_h: int,
                       ignore_index: int = 255) -> torch.Tensor:
    """K2: gradient at the mid rows, ``[N, h, C, W]`` float32. ``scale`` is
    a one-element float32 tensor, ``g / max(valid count, 1)``."""
    if mid.device.type == "cpu":
        return resize_ce_grad_mid_reference(mid, label, scale, out_h,
                                            ignore_index)
    if mid.device.type != "cuda":
        raise ValueError(f"resize_ce_grad_mid runs on cuda or cpu, not "
                         f"{mid.device.type}")
    f = _check(mid, label, out_h)
    if scale.dtype != torch.float32 or scale.numel() != 1 \
            or scale.device != mid.device:
        raise ValueError("scale must be a one-element float32 tensor on "
                         "mid's device")
    scale = scale.contiguous()
    n, h, c, w = mid.shape
    gmid = torch.empty_like(mid)
    with torch.cuda.device(mid.device):
        err = _lib().resize_ce_bwd(mid.data_ptr(), label.data_ptr(),
                                   scale.data_ptr(), gmid.data_ptr(), n, h, c,
                                   w, f, ignore_index,
                                   torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "resize_ce_bwd")
    count("launch.resize_ce_bwd")
    if c != 19:
        count("launch.resize_ce_bwd.any")
    return gmid


class _FusedResizeCE(torch.autograd.Function):
    """Custom VJP of ``gaiaseg_tpu`` ``fused_resize_ce``: K1 forward, K2
    backward, the width interpolation and its adjoint as matmuls. Across
    ranks the divisor is the valid count of the global batch: each rank's
    loss is its share of the global mean, and the gradients summed over
    the ranks are the global mean's."""

    @staticmethod
    def forward(ctx, logits, label, out_hw, ignore_index):
        H, W = out_hw
        mid = width_interp(logits, W)
        loss_sum, valid_sum = resize_ce_sums(mid, label, H, ignore_index)
        valid_sum = sum_over_ranks(valid_sum)
        ctx.save_for_backward(mid, label, valid_sum)
        ctx.out_h, ctx.ignore_index = H, ignore_index
        ctx.logits_dtype, ctx.src_w = logits.dtype, logits.shape[3]
        return loss_sum / valid_sum.clamp_min(1.0)

    @staticmethod
    def backward(ctx, g):
        mid, label, valid_sum = ctx.saved_tensors
        scale = (g.float() / valid_sum.clamp_min(1.0)).reshape(1)
        gmid = resize_ce_grad_mid(mid, label, scale, ctx.out_h,
                                  ctx.ignore_index)
        A_W = _interp_tensor(ctx.src_w, mid.shape[3], mid.device)
        with _f32(mid.device):
            glogits = torch.matmul(gmid, A_W.t()).permute(0, 2, 1, 3)
        return glogits.to(ctx.logits_dtype), None, None, None


def fused_resize_ce(logits: torch.Tensor, label: torch.Tensor,
                    out_hw: Tuple[int, int],
                    ignore_index: int = 255) -> torch.Tensor:
    """Mean over valid pixels of the softmax CE of ``[N, C, h, w]`` logits
    upsampled bilinearly (half-pixel) to ``out_hw``; ``label`` is
    ``[N, H, W]`` int32. Equal (float32) to
    ``softmax_cross_entropy(resize_bilinear(logits, out_hw), label)``."""
    return _FusedResizeCE.apply(logits, label,
                                (int(out_hw[0]), int(out_hw[1])),
                                int(ignore_index))


def fused_resize_ce_reference(logits: torch.Tensor, label: torch.Tensor,
                              out_hw: Tuple[int, int],
                              ignore_index: int = 255) -> torch.Tensor:
    """Plain torch version of ``fused_resize_ce`` end to end: the separable
    float32 interpolation, logsumexp and pick, differentiated by autograd
    (across ranks, this rank's share of the global mean)."""
    mid = width_interp(logits, int(out_hw[1]))
    loss_sum, valid_sum = resize_ce_sums_reference(mid, label,
                                                   int(out_hw[0]),
                                                   ignore_index)
    return loss_sum / sum_over_ranks(valid_sum).clamp_min(1.0)
