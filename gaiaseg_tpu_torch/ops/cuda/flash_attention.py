"""Flash attention (non-causal, head dim 64) with its three CUDA kernels.

Port of ``gaiaseg_tpu/ops/pallas/flash_attention.py`` and
``flash_attention_bwd.py``. The public function keeps the JAX layout:
``flash_attention(q, k, v)`` on ``[B, N, H, 64]`` tensors, ``q`` pre-scaled
by ``1/sqrt(64)``. The kernels of ``csrc/flash_attention.cu`` read q, k and
v through their strides (head dim contiguous), so views into the fused qkv
projection need no copy:

- K3 ``flash_fwd`` (replaces ``_fa_kernel`` via ``_flash_fwd``): the output
  and the softmax residuals ``m`` (row max) and ``l`` (unnormalised row
  sum), ``[B, H, N]`` float32.
- K4 ``flash_bwd_dkv`` (replaces ``_dkv_kernel``): dK and dV.
- K5 ``flash_bwd_dq`` (replaces ``_dq_kernel``): dQ.

In bf16, all three read q, k, v (and dO) by TMA through 4-D tensor maps
(``tensor_map_layout``), built inside the C entry points from the same
strides.

``di = rowsum(dO * O)`` is a torch op, as the JAX package leaves it to XLA.
The 128-lane padding of the TPU residuals is a Mosaic layout rule and is
not kept. A wrapper takes its kernel's plain torch version (the
``*_reference`` functions, which follow the JAX kernels' casts: P cast to
v's dtype before P.V in the forward, float32 products in the backward) only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ...utils.tracing import count
from . import build
from .build import LAUNCHES  # noqa: F401  (re-exported)

HEAD_DIM = 64
TILE_ROWS = 64      # rows of one staged tile (a TMA box of the bf16 kernels)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _f32(device: torch.device):
    """The plain versions compute in float32 inside an autocast region."""
    return torch.autocast(device.type, enabled=False)


def _probs(q, k, m, l):
    """P = exp(S - m) / max(l, 1e-30), ``[B, H, N, N]`` float32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    return torch.exp(s - m[..., None]) / l.clamp_min(1e-30)[..., None]


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3: (o in q's dtype, m, l)."""
    with _f32(q.device):
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        o = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float())
        o = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
        return o.to(q.dtype), m, l


def flash_bwd_dkv_reference(q, k, v, do, m, l, di
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: (dk, dv) in q's dtype."""
    with _f32(q.device):
        p = _probs(q, k, m, l)
        dof = do.float()
        dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
        dp = torch.einsum("bnhd,bmhd->bhnm", dof, v.float())
        dk = torch.einsum("bhnm,bnhd->bmhd", p * (dp - di[..., None]),
                          q.float())
        return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_reference(q, k, v, do, m, l, di) -> torch.Tensor:
    """Plain version of K5: dq in q's dtype."""
    with _f32(q.device):
        p = _probs(q, k, m, l)
        dp = torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())
        dq = torch.einsum("bhnm,bmhd->bnhd", p * (dp - di[..., None]),
                          k.float())
        return dq.to(q.dtype)


# --------------------------------------------------------------------- #
def tensor_map_layout(t: torch.Tensor):
    """The 4-D TMA tensor map through which the bf16 kernels read
    a strided ``[B, N, H, 64]`` view (``csrc/hopper.cuh``
    ``encode_bnhd_map`` builds the same map from the element strides):
    ``(dims, byte_strides, box)`` with dims ``(64, H, N, B)`` innermost
    first, the byte strides of h, n and b, and the box ``(64, 1, 64, 1)``,
    64 rows of one (b, h). Raises ``ValueError`` unless the head dim is
    contiguous, the other strides are multiples of 16 bytes and the base is
    16-byte aligned, which TMA needs (and the other kernels' 16-byte
    loads)."""
    b, n, h, d = t.shape
    size = t.element_size()
    strides = (t.stride(2) * size, t.stride(1) * size, t.stride(0) * size)
    if t.stride(3) != 1 or any(s % 16 for s in strides) \
            or t.data_ptr() % 16:
        raise ValueError(f"unsupported strides {t.stride()} of a {t.dtype} "
                         "tensor (head dim contiguous, the other strides "
                         "multiples of 16 bytes, 16-byte aligned base)")
    return (d, h, n, b), strides, (d, 1, TILE_ROWS, 1)


def _check_inputs(*ts: torch.Tensor) -> None:
    """q, k, v (and dO): CUDA, one device, bf16 or float32, equal
    ``[B, N, H, 64]`` shapes, strides as ``tensor_map_layout`` takes
    them."""
    ref = ts[0]
    for t in ts:
        if t.device != ref.device or t.dtype != ref.dtype \
                or t.shape != ref.shape:
            raise ValueError("q, k, v, dO must share device, dtype and shape; "
                             f"got {t.device} {t.dtype} {tuple(t.shape)} vs "
                             f"{ref.device} {ref.dtype} {tuple(ref.shape)}")
        if t.dim() != 4 or t.shape[3] != HEAD_DIM:
            raise ValueError(f"the kernels take [B, N, H, {HEAD_DIM}] "
                             f"tensors, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"the kernels take bf16 or float32, not "
                             f"{t.dtype}")
        tensor_map_layout(t)
    b, n, h, _ = ref.shape
    if n < 1 or not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(f"shape {tuple(ref.shape)} out of the kernels' range")


def _check_stats(ref: torch.Tensor, *stats: torch.Tensor) -> None:
    b, n, h, _ = ref.shape
    for s in stats:
        if s.dtype != torch.float32 or tuple(s.shape) != (b, h, n) \
                or not s.is_contiguous() or s.device != ref.device:
            raise ValueError(f"m, l, di must be contiguous float32 [{b}, {h}, "
                             f"{n}] on {ref.device}, got {s.dtype} "
                             f"{tuple(s.shape)}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (built at the
    first launch, never at import)."""
    return bind(build.load("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``flash_attention`` library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [i, p, p, p, p, p, p, i, i, i, p, p]
    lib.flash_bwd_dkv.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, p, p]
    lib.flash_bwd_dq.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, p, p]
    for f in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq):
        f.restype = i
    return lib


def _strides(*ts: torch.Tensor):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device.type}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: (o ``[B, N, H, 64]`` contiguous in q's dtype, m, l)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v)
    _require_cuda(q, "flash_fwd")
    _check_inputs(q, k, v)
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _lib().flash_fwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), o.data_ptr(), m.data_ptr(),
                               l.data_ptr(), b, n, h, _strides(q, k, v),
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "flash_fwd")
    count("launch.flash_fwd")
    return o, m, l


def flash_bwd_dkv(q, k, v, do, m, l, di) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (dk, dv), ``[B, N, H, 64]`` contiguous in q's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, m, l, di)
    _require_cuda(q, "flash_bwd_dkv")
    _check_inputs(q, k, v, do)
    _check_stats(q, m, l, di)
    b, n, h, _ = q.shape
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        err = _lib().flash_bwd_dkv(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, n, h, _strides(q, k, v, do),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "flash_bwd_dkv")
    count("launch.flash_bwd_dkv")
    return dk, dv


def flash_bwd_dq(q, k, v, do, m, l, di) -> torch.Tensor:
    """K5: dq, ``[B, N, H, 64]`` contiguous in q's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, m, l, di)
    _require_cuda(q, "flash_bwd_dq")
    _check_inputs(q, k, v, do)
    _check_stats(q, m, l, di)
    b, n, h, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().flash_bwd_dq(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
            dq.data_ptr(), b, n, h, _strides(q, k, v, do),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "flash_bwd_dq")
    count("launch.flash_bwd_dq")
    return dq


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) in float32, ``[B, H, N]`` contiguous."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    """Custom VJP of ``gaiaseg_tpu`` ``_flash``: K3 forward, K4 + K5
    backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, m, l = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        if do.stride(3) != 1 or any(s % 8 for s in do.stride()[:3]):
            do = do.contiguous()
        di = attention_di(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, m, l, di)
        dq = flash_bwd_dq(q, k, v, do, m, l, di)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention on ``[B, N, H, 64]`` (q pre-scaled by
    1/sqrt(64)); equal to dense softmax attention with P rounded to v's
    dtype before P.V."""
    return _FlashAttention.apply(q, k, v)
