"""Port's fused upsample+CE (gaiaseg_tpu_torch/ops/cuda/resize_ce.py) vs the
JAX Pallas kernel run in interpret mode.

On the CPU the port's autograd Function takes the plain torch versions of
its two kernels; ``fused_resize_ce_reference`` is the plain version end to
end. Both are held against ``gaiaseg_tpu`` ``fused_resize_ce(...,
interpret=True)`` at the shapes of tests/test_resize_ce.py, and at the
shapes the CUDA backward special-cases: 150 classes (its any-C instance)
with h = 3 (one tile spans every mid row), and row factors 4, 16 and 32 (1,
2 and 4 output rows per row lane and interval). K1's plain version is also
held against the JAX ``_sums`` alone (loss sum and valid count, each on its
own), there and with both edge intervals ignored. The CUDA kernels
themselves are held against the plain versions by
tests/test_torch_kernels_gpu.py (skipped without a card) and by
chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.ops.pallas import resize_ce as jrc
from gaiaseg_tpu_torch.ops.cuda import resize_ce as rc

torch.set_num_threads(1)

SHAPES = [
    (2, 8, 8, 19, 32, 32),     # production-like: f=4, square
    (1, 4, 6, 7, 16, 20),      # non-square, odd C, W factor != H factor
    (2, 3, 3, 5, 12, 9),       # h=3 minimum, W downscale-ish irregular
]


def _rand(n, h, w, c, H, W, seed=0, ignore_frac=0.1):
    """NHWC logits and labels, as tests/test_resize_ce.py draws them."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, h, w, c).astype(np.float32)
    lab = rng.randint(0, c, (n, H, W)).astype(np.int32)
    lab[rng.rand(n, H, W) < ignore_frac] = 255
    return logits, lab


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(shape):
    n, h, w, c, H, W = shape
    logits, lab = _rand(*shape)
    loss, grad = jax.value_and_grad(
        lambda lg: jrc.fused_resize_ce(lg, jnp.asarray(lab), (H, W), 255,
                                       True))(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


def _port_loss_and_grad(fn, logits_nhwc, lab, out_hw, dtype=torch.float32):
    x = torch.from_numpy(logits_nhwc.transpose(0, 3, 1, 2).copy()).to(dtype)
    x.requires_grad_()
    loss = fn(x, torch.from_numpy(lab), out_hw)
    grad, = torch.autograd.grad(loss, x)
    return loss.detach(), grad.permute(0, 2, 3, 1)


@pytest.mark.parametrize("path", ["function", "reference"])
@pytest.mark.parametrize("shape", SHAPES)
def test_loss_and_grad_match_jax(shape, path):
    n, h, w, c, H, W = shape
    assert rc.supports_fused_resize_ce((h, w), (H, W), False)
    fn = rc.fused_resize_ce if path == "function" \
        else rc.fused_resize_ce_reference
    logits, lab = _rand(*shape)
    loss, grad = _port_loss_and_grad(fn, logits, lab, (H, W))
    j_loss, j_grad = _jax_loss_and_grad(shape)
    assert abs(float(loss) - j_loss) <= 1e-5
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=0, atol=1e-7)


# (n, h, w, c, H, W) at which the CUDA backward changes its tiling
KERNEL_EDGE_SHAPES = {
    "c150_h3": (1, 3, 4, 150, 12, 8),
    "f4": (1, 4, 3, 19, 16, 6),
    "f16": (1, 3, 3, 19, 48, 6),
    "f32": (1, 3, 2, 19, 96, 4),
}


@pytest.mark.parametrize("case", sorted(KERNEL_EDGE_SHAPES))
def test_loss_and_grad_match_jax_at_kernel_edge_shapes(case):
    """The port's ``fused_resize_ce`` (on the CPU: K1's and K2's plain
    versions plus the width adjoint) against ``jax.grad`` of the JAX
    ``fused_resize_ce(..., interpret=True)``, whose backward is
    ``_frc_bwd``; float32, gradient within 1e-4 of max|ref| (the two sides
    sum the softmax and the row adjoint in different orders)."""
    shape = KERNEL_EDGE_SHAPES[case]
    n, h, w, c, H, W = shape
    assert rc.supports_fused_resize_ce((h, w), (H, W), False)
    logits, lab = _rand(*shape, seed=3)
    j_loss, j_grad = jax.value_and_grad(
        lambda lg: jrc.fused_resize_ce(lg, jnp.asarray(lab), (H, W), 255,
                                       True))(jnp.asarray(logits))
    loss, grad = _port_loss_and_grad(rc.fused_resize_ce, logits, lab, (H, W))
    j_grad = np.asarray(j_grad)
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    assert grad.shape == j_grad.shape
    assert np.abs(grad.numpy() - j_grad).max() <= 1e-4 * np.abs(j_grad).max()


# K1's cases: the shapes above, one whose two edge intervals (the first and
# last f/2 label rows, where both taps fall on one mid row) are ignored, and
# 150 classes over 8 mid rows
SUMS_CASES = {**KERNEL_EDGE_SHAPES, "edges_ignored": (2, 4, 3, 19, 32, 6),
              "c150_h8": (1, 8, 5, 150, 32, 10)}


@pytest.mark.parametrize("case", sorted(SUMS_CASES))
def test_sums_match_jax(case):
    """K1's plain version after the width interpolation against the JAX
    ``_sums(..., interpret=True)`` (the Pallas ``_fwd_kernel``): the loss
    sum within 1e-5 relative (float32 sums in another order) and the valid
    count exactly, each on its own."""
    shape = SUMS_CASES[case]
    n, h, w, c, H, W = shape
    logits, lab = _rand(*shape, seed=5)
    if case == "edges_ignored":
        f2 = H // h // 2
        lab[:, :f2] = 255
        lab[:, H - f2:] = 255
    j_loss, j_count, _ = jrc._sums(jnp.asarray(logits), jnp.asarray(lab),
                                   (H, W), 255, True)
    mid = rc.width_interp(
        torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()), W)
    loss, count = rc.resize_ce_sums_reference(mid, torch.from_numpy(lab), H)
    assert float(count) == float(j_count) == float((lab != 255).sum())
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))


def test_grad_mid_reference_is_the_adjoint_of_the_sums():
    """K2's plain version == autograd of K1's plain version (what the
    CUDA kernels are held to on the card)."""
    n, h, w, c, H, W = SHAPES[1]
    logits, lab = _rand(*SHAPES[1])
    mid = rc.width_interp(
        torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()), W)
    mid.requires_grad_()
    label = torch.from_numpy(lab)
    ls, ws = rc.resize_ce_sums_reference(mid, label, H)
    g_auto, = torch.autograd.grad(ls / ws, mid)
    g_mid = rc.resize_ce_grad_mid(mid.detach(), label, (1.0 / ws).reshape(1),
                                  H)
    torch.testing.assert_close(g_mid, g_auto, rtol=0, atol=1e-8)


@pytest.mark.parametrize("path", ["function", "reference"])
def test_all_ignored_is_zero(path):
    fn = rc.fused_resize_ce if path == "function" \
        else rc.fused_resize_ce_reference
    logits, _ = _rand(1, 4, 4, 6, 16, 16)
    lab = np.full((1, 16, 16), 255, np.int32)
    loss, grad = _port_loss_and_grad(fn, logits, lab, (16, 16))
    assert float(loss) == 0.0
    assert float(grad.abs().max()) == 0.0


def test_bf16_logits_match_jax():
    """bf16 logits: both sides interpolate in float32 from the same bf16
    values; the gradient comes back in bf16 (one bf16 ulp is 2^-8)."""
    logits, lab = _rand(1, 8, 8, 19, 32, 32)
    lb = jnp.asarray(logits).astype(jnp.bfloat16)
    j_loss, j_grad = jax.value_and_grad(
        lambda x: jrc.fused_resize_ce(x, jnp.asarray(lab), (32, 32), 255,
                                      True))(lb)
    logits_bf16 = np.asarray(lb.astype(jnp.float32))
    loss, grad = _port_loss_and_grad(rc.fused_resize_ce, logits_bf16, lab,
                                     (32, 32), torch.bfloat16)
    assert grad.dtype == torch.bfloat16
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    j_grad = np.asarray(j_grad.astype(jnp.float32))
    np.testing.assert_allclose(grad.float().numpy(), j_grad, rtol=0,
                               atol=1e-2 * np.abs(j_grad).max())


@pytest.mark.parametrize("case", [
    ((8, 8), (32, 32), False),
    ((8, 8), (32, 32), True),     # align_corners
    ((8, 8), (36, 32), False),    # non-integer row factor
    ((8, 8), (24, 32), False),    # odd row factor (3)
    ((2, 8), (8, 32), False),     # <3 source rows
    ((8, 8), (8, 32), False),     # factor 1 (nothing to fuse)
])
def test_supports_gate_matches_jax(case):
    assert rc.supports_fused_resize_ce(*case) == \
        jrc.supports_fused_resize_ce(*case)


@pytest.mark.parametrize("bad", ["label_int64", "mid_strided", "odd_rows",
                                 "too_many_classes"])
def test_kernel_input_checks_raise(bad):
    """The wrappers' checks before a launch (run for CUDA tensors)."""
    mid = torch.zeros(2, 4, 5, 16)
    label = torch.zeros(2, 16, 16, dtype=torch.int32)
    out_h = 16
    if bad == "label_int64":
        label = label.long()
    elif bad == "mid_strided":
        mid = torch.zeros(2, 4, 16, 5).transpose(2, 3)
    elif bad == "odd_rows":
        label, out_h = torch.zeros(2, 12, 16, dtype=torch.int32), 12
    else:
        mid = torch.zeros(2, 4, 300, 16)
    with pytest.raises(ValueError):
        rc._check(mid, label, out_h)


@pytest.mark.parametrize("avg_non_ignore", [True, False])
def test_softmax_cross_entropy_matches_jax(avg_non_ignore):
    from gaiaseg_tpu.models.losses.cross_entropy import \
        softmax_cross_entropy as j_ce
    from gaiaseg_tpu_torch.models.losses.cross_entropy import \
        softmax_cross_entropy
    logits, lab = _rand(2, 12, 10, 7, 12, 10, seed=4)
    want = j_ce(jnp.asarray(logits), jnp.asarray(lab),
                avg_non_ignore=avg_non_ignore)
    got = softmax_cross_entropy(
        torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(lab), avg_non_ignore=avg_non_ignore)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_unfused_chain_matches_fused(shape):
    """The segmentor's path when the gate fails (interpolate, then CE)
    computes the same loss as the fused one where both apply."""
    from gaiaseg_tpu_torch.models.losses.cross_entropy import \
        softmax_cross_entropy
    from gaiaseg_tpu_torch.ops.resize import resize_bilinear
    n, h, w, c, H, W = shape
    logits, lab = _rand(*shape)
    x = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy())
    label = torch.from_numpy(lab)
    unfused = softmax_cross_entropy(resize_bilinear(x, (H, W)), label)
    fused = rc.fused_resize_ce(x, label, (H, W))
    assert abs(float(unfused) - float(fused)) <= 1e-5
