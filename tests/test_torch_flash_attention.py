"""Port's flash attention (ops/cuda/flash_attention.py) vs the JAX Pallas
kernels, run in interpret mode on the CPU as tests/test_backbones2.py runs
them.

- K3: ``flash_fwd_reference`` (o, m, l) against ``flash_attention`` and the
  residuals of ``_flash_fwd`` at (1, 256, 2, 64) and the ragged
  (1, 200, 1, 64) with block 128, within 2e-4; and, at the lengths the
  bf16 CUDA forward special-cases (N = 64: one key tile; 129: a 128-row
  block with one real row; 200: a ragged second stage), 3 heads, in float32
  and bf16: o within 1e-4 / 2e-2 of max|ref| (bf16 outputs round to half an
  ulp, 2^-9), m and l within 1e-4.
- K4/K5: each backward plain version, fed the JAX forward's own
  (q, k, v, o, m, l) and dO, against ``flash_attention_bwd`` at
  (1, 200, 2, 64) and the ragged (1, 130, 3, 64), block 128; and the
  port's autograd path (``flash_attention`` on CPU tensors, whose wrappers
  take the plain versions) against ``jax.grad`` through the kernels, at
  (1, 200, 2, 64), within 5e-4.

Inputs are made with numpy from a seed; float32 on both sides.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch.ops.cuda import LAUNCHES
from gaiaseg_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(1)
jfa = importlib.import_module("gaiaseg_tpu.ops.pallas.flash_attention")
jfab = importlib.import_module("gaiaseg_tpu.ops.pallas.flash_attention_bwd")


@pytest.fixture
def interpret(monkeypatch):
    orig = jfa.pl.pallas_call
    monkeypatch.setattr(jfa.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, interpret=True, **kw))
    monkeypatch.setattr(jfab.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, interpret=True, **kw))


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(*shape) * 0.125).astype(np.float32)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    do = rng.randn(*shape).astype(np.float32)
    return q, k, v, do


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("shape,block", [((1, 256, 2, 64), None),
                                         ((1, 200, 1, 64), 128)])
def test_fwd_reference_matches_pallas_interpret(interpret, shape, block):
    q, k, v, _ = _inputs(shape, 0)
    kw = {} if block is None else {"block_q": block, "block_k": block}
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    # the residuals, [B, H, Npad, 128] lane-padded on the TPU side
    bq = block or jfa.DEFAULT_BLOCK_Q
    bk = block or jfa.DEFAULT_BLOCK_K
    tq, tk, tv = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    _, (_, _, _, _, jm, jl) = jfa._flash_fwd(tq, tk, tv, bq, bk,
                                             save_residuals=True)
    o, m, l = fa.flash_fwd_reference(_t(q), _t(k), _t(v))
    n = shape[1]
    _close(o.numpy(), want, 2e-4, "o")
    _close(m.numpy(), np.asarray(jm)[:, :, :n, 0], 2e-4, "m")
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[:, :, :n, 0],
                               rtol=2e-4, err_msg="l")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 129, 200])
def test_fwd_reference_matches_pallas_at_kernel_edge_lengths(interpret, n,
                                                             dtype):
    """The plain forward (what the CUDA forward is held to on the card)
    against interpret-mode ``_flash_fwd(..., save_residuals=True)`` on the
    same values: both sides get the inputs already rounded to ``dtype``."""
    q, k, v, _ = _inputs((1, n, 3, 64), 10 + n)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(x.transpose(0, 2, 1, 3)).astype(jdt)
                  for x in (q, k, v))
    jo, (_, _, _, _, jm, jl) = jfa._flash_fwd(jq, jk, jv, 128, 128,
                                              save_residuals=True)
    tdt = getattr(torch, dtype)
    # the same rounded values on the port's side, in its [B, N, H, 64]
    tq, tk, tv = (_t(np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1, 3))
                  .to(tdt) for x in (jq, jk, jv))
    o, m, l = fa.flash_fwd_reference(tq, tk, tv)
    assert o.dtype == tdt and m.dtype == l.dtype == torch.float32
    want_o = np.asarray(jo.astype(jnp.float32))[:, :, :n].transpose(0, 2, 1,
                                                                    3)
    for got, want, tol, name in (
            (o.float().numpy(), want_o, 1e-4 if dtype == "float32" else 2e-2,
             "o"),
            (m.numpy(), np.asarray(jm)[:, :, :n, 0], 1e-4, "m"),
            (l.numpy(), np.asarray(jl)[:, :, :n, 0], 1e-4, "l")):
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), name


def _jax_residuals(q, k, v, block):
    """The JAX forward's padded [B, H, Npad, D] (q, k, v, o) and lane-
    padded m, l."""
    tq, tk, tv = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    _, res = jfa._flash_fwd(tq, tk, tv, block, block, save_residuals=True)
    return res


def _check_bwd_references(shape, block, seed):
    """K4 and K5's plain versions fed the JAX forward's residuals against
    the interpret-mode ``_dkv_kernel`` and ``_dq_kernel``."""
    q, k, v, do = _inputs(shape, seed)
    n = shape[1]
    qp, kp, vp, op, m, l = _jax_residuals(q, k, v, block)
    dop = jnp.pad(jnp.asarray(do.transpose(0, 2, 1, 3)),
                  ((0, 0), (0, 0), (0, qp.shape[2] - n), (0, 0)))
    jdq, jdk, jdv = jfab.flash_attention_bwd(qp, kp, vp, op, m, l, dop,
                                             block, block, n)

    def bnhd(x):     # [B, H, Npad, D] -> the port's [B, N, H, D]
        return _t(np.asarray(x)[:, :, :n].transpose(0, 2, 1, 3))

    pm = _t(np.asarray(m)[:, :, :n, 0])
    pl_ = _t(np.asarray(l)[:, :, :n, 0])
    o = bnhd(op)
    di = fa.attention_di(o, _t(do))
    args = (_t(q), _t(k), _t(v), _t(do), pm, pl_, di)
    dk, dv = fa.flash_bwd_dkv_reference(*args)
    dq = fa.flash_bwd_dq_reference(*args)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        _close(got.numpy(), bnhd(want).numpy(), 5e-4, name)


def test_bwd_references_match_pallas_bwd(interpret):
    _check_bwd_references((1, 200, 2, 64), 128, seed=1)


def test_bwd_references_match_pallas_bwd_ragged_vit_width(interpret):
    """At the ViT's head width a sequence of 130: the last 64-row tile of
    the CUDA kernels holds 2 rows, the Pallas block of 128 holds 2."""
    _check_bwd_references((1, 130, 3, 64), 128, seed=5)


def test_autograd_matches_jax_grad_through_kernels(interpret):
    """The port's flash_attention autograd Function on CPU tensors (K4/K5
    wrappers take their plain versions) against jax.grad through the
    interpret-mode Pallas forward and backward; loss sum(o^2)."""
    shape = (1, 200, 2, 64)
    q, k, v, _ = _inputs(shape, 2)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, block_q=128,
                                           block_k=128) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    before = dict(LAUNCHES)
    (fa.flash_attention(*xs) ** 2).sum().backward()
    assert LAUNCHES == before      # CPU tensors launch no kernel
    for x, w, name in zip(xs, want, "qkv"):
        _close(x.grad.numpy(), w, 5e-4, f"d{name}")


def test_wrappers_take_plain_versions_on_cpu():
    q, k, v, do = (_t(x) for x in _inputs((2, 70, 3, 64), 3))
    o, m, l = fa.flash_fwd(q, k, v)
    ro, rm, rl = fa.flash_fwd_reference(q, k, v)
    assert torch.equal(o, ro) and torch.equal(m, rm) and torch.equal(l, rl)
    di = fa.attention_di(o, do)
    for got, want in zip(fa.flash_bwd_dkv(q, k, v, do, m, l, di),
                         fa.flash_bwd_dkv_reference(q, k, v, do, m, l, di)):
        assert torch.equal(got, want)
    assert torch.equal(fa.flash_bwd_dq(q, k, v, do, m, l, di),
                       fa.flash_bwd_dq_reference(q, k, v, do, m, l, di))


def test_forward_rounds_p_to_v_dtype():
    """The plain forward casts P to v's dtype before P.V, as the JAX kernel
    does (flash_attention.py:67-68): bf16 inputs give o from bf16 P."""
    q, k, v, _ = (_t(x).to(torch.bfloat16) for x in _inputs((1, 64, 1, 64),
                                                           4))
    o, m, l = fa.flash_fwd_reference(q, k, v)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.exp(s - m[..., None]).to(torch.bfloat16).float()
    want = torch.einsum("bhnm,bmhd->bnhd", p, v.float()) \
        / l.transpose(1, 2)[..., None]
    assert o.dtype == torch.bfloat16
    assert torch.equal(o, want.to(torch.bfloat16))
