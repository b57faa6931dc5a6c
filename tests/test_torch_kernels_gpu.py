"""The port's CUDA kernels against their plain torch versions, on a card.

Marked ``gpu``; each test skips without CUDA (decided inside a fixture, never
at import). This file imports torch and the port only, so it runs where JAX
is not installed:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch.ops.cuda import resize_ce as rc

SHAPES = [
    (2, 8, 8, 19, 32, 32),
    (1, 4, 6, 7, 16, 20),
    (2, 3, 3, 5, 12, 9),
    (8, 16, 32, 19, 512, 1024),     # flagship decode loss
    (8, 32, 64, 19, 512, 1024),     # flagship aux loss
    (2, 6, 10, 150, 24, 40),        # 150 classes: K2's any-C instance
    (8, 128, 128, 150, 512, 512),   # ViT decode loss (any-C, f = 4)
    (8, 32, 32, 150, 512, 512),     # ViT aux loss (any-C, f = 16)
    (2, 8, 8, 21, 32, 32),          # 21 classes (VOC)
    (2, 3, 5, 256, 12, 40),         # 256 classes, the most K1/K2 take
    (2, 5, 7, 59, 20, 37),          # a width off the tile's 32 columns and 4
    (2, 6, 9, 150, 24, 72),         # both edge intervals ignored
]
EDGES_IGNORED = SHAPES[-1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    n, h, w, c, H, W = shape
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(n, c, h, w).astype(np.float32))
    lab = rng.randint(0, c, (n, H, W)).astype(np.int32)
    lab[rng.rand(n, H, W) < 0.1] = 255
    if shape == EDGES_IGNORED:         # the rows of intervals -1 and h - 1
        f2 = H // h // 2
        lab[:, :f2] = 255
        lab[:, -f2:] = 255
    return logits.to(device), torch.from_numpy(lab).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(cuda, shape):
    """K1: loss within 1e-5 relative, equal valid count; K2: max|d| within
    1e-4 of max|ref|; each wrapper counts one launch."""
    logits, label = _inputs(shape, cuda)
    H = shape[4]
    mid = rc.width_interp(logits, shape[5])
    before = dict(rc.LAUNCHES)
    ls, ws = rc.resize_ce_sums(mid, label, H)
    rls, rws = rc.resize_ce_sums_reference(mid, label, H)
    assert float(ws) == float(rws)
    assert abs(float(ls / ws) - float(rls / rws)) <= 1e-5 * float(rls / rws)
    scale = (1.0 / rws).reshape(1)
    g = rc.resize_ce_grad_mid(mid, label, scale, H)
    rg = rc.resize_ce_grad_mid_reference(mid, label, scale, H)
    assert float((g - rg).abs().max()) <= 1e-4 * float(rg.abs().max())
    assert rc.LAUNCHES["resize_ce_fwd"] == before["resize_ce_fwd"] + 1
    assert rc.LAUNCHES["resize_ce_bwd"] == before["resize_ce_bwd"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[4]] + SHAPES[5:])
def test_grad_mid_is_deterministic(cuda, shape):
    """K2 launched twice on the same inputs gives the same bits: the row
    lanes' sums are added in a fixed order, no atomics."""
    logits, label = _inputs(shape, cuda, seed=3)
    mid = rc.width_interp(logits, shape[5])
    scale = torch.full((1,), 1e-3, device=cuda)
    first = rc.resize_ce_grad_mid(mid, label, scale, shape[4])
    assert torch.equal(first, rc.resize_ce_grad_mid(mid, label, scale,
                                                    shape[4]))


@pytest.mark.gpu
def test_any_c_launches_are_counted(cuda):
    """``launch.resize_ce_bwd.any`` counts K2's launches at 150 classes,
    not at 19; ``launch.resize_ce_bwd`` counts both."""
    for shape, any_c in ((SHAPES[5], 1), (SHAPES[0], 0)):
        logits, label = _inputs(shape, cuda)
        mid = rc.width_interp(logits, shape[5])
        scale = torch.full((1,), 1e-3, device=cuda)
        bwd, before = rc.LAUNCHES["resize_ce_bwd"], rc.ANY_C_LAUNCHES["any"]
        rc.resize_ce_grad_mid(mid, label, scale, shape[4])
        assert rc.LAUNCHES["resize_ce_bwd"] == bwd + 1
        assert rc.ANY_C_LAUNCHES["any"] == before + any_c


# K1 at the ViT path's losses (h = 128, f = 4; h = 32, f = 16), at 150
# classes over 8 mid rows, and with both edge intervals ignored
SUMS_SHAPES = {"vit_decode": (8, 128, 128, 19, 512, 512),
               "vit_aux": (8, 32, 32, 19, 512, 512),
               "c150_h8": (2, 8, 5, 150, 32, 10),
               "edges_ignored": (2, 4, 3, 19, 32, 6)}


def _sums_inputs(case, device, seed):
    shape = SUMS_SHAPES[case]
    logits, label = _inputs(shape, device, seed)
    if case == "edges_ignored":
        f2 = shape[4] // shape[1] // 2
        label[:, :f2] = 255
        label[:, -f2:] = 255
    return rc.width_interp(logits, shape[5]), label, shape[4]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SUMS_SHAPES))
def test_sums_match_plain(cuda, case):
    """K1: loss sum within 1e-5 relative and the valid count equal, each
    on its own; one launch counted."""
    mid, label, H = _sums_inputs(case, cuda, seed=2)
    before = rc.LAUNCHES["resize_ce_fwd"]
    ls, ws = rc.resize_ce_sums(mid, label, H)
    rls, rws = rc.resize_ce_sums_reference(mid, label, H)
    assert float(ws) == float(rws) == float((label != 255).sum())
    assert abs(float(ls) - float(rls)) <= 1e-5 * float(rls)
    assert rc.LAUNCHES["resize_ce_fwd"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["vit_decode", "c150_h8", "flagship"])
def test_sums_are_deterministic(cuda, case):
    """K1 launched twice on the same inputs gives the same bits: each block
    adds its threads in a fixed order and the last block adds the blocks in
    index order."""
    if case == "flagship":
        logits, label = _inputs(SHAPES[3], cuda, seed=4)
        mid, H = rc.width_interp(logits, 1024), 512
    else:
        mid, label, H = _sums_inputs(case, cuda, seed=4)
    first = torch.stack(rc.resize_ce_sums(mid, label, H))
    assert torch.equal(first, torch.stack(rc.resize_ce_sums(mid, label, H)))


@pytest.mark.gpu
def test_sums_on_two_streams(cuda):
    """K1 on two streams at once (each has its own workspace and ticket)
    gives the bits it gives on the default stream."""
    shapes = (SHAPES[3], SHAPES[4])
    ins = []
    for i, shape in enumerate(shapes):
        logits, label = _inputs(shape, cuda, seed=5 + i)
        ins.append((rc.width_interp(logits, shape[5]), label, shape[4]))
    want = [torch.stack(rc.resize_ce_sums(*x)) for x in ins]
    streams = [torch.cuda.Stream() for _ in shapes]
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for s, x in zip(streams, ins):
            with torch.cuda.stream(s):
                got.append(torch.stack(rc.resize_ce_sums(*x)))
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        assert torch.equal(g, want[i % 2])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_matches_plain(cuda, dtype):
    """fused_resize_ce on CUDA tensors (K1 forward, K2 backward) against the
    plain version differentiated by autograd; bf16 grads within one bf16
    ulp (2^-8) of the max."""
    logits, label = _inputs(SHAPES[3], cuda, seed=1)
    x = logits.to(dtype).requires_grad_()
    loss = rc.fused_resize_ce(x, label, (512, 1024))
    g, = torch.autograd.grad(loss, x)
    xr = logits.to(dtype).requires_grad_()
    ref = rc.fused_resize_ce_reference(xr, label, (512, 1024))
    gr, = torch.autograd.grad(ref, xr)
    assert g.dtype == dtype
    assert abs(float(loss.detach()) - float(ref.detach())) <= \
        1e-5 * float(ref.detach())
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert float((g.float() - gr.float()).abs().max()) <= \
        tol * float(gr.float().abs().max())


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_bad_input(cuda):
    mid = torch.zeros(2, 4, 5, 16, device=cuda)
    with pytest.raises(ValueError):
        rc.resize_ce_sums(mid, torch.zeros(2, 16, 16, dtype=torch.int64,
                                           device=cuda), 16)
    with pytest.raises(ValueError):
        rc.resize_ce_grad_mid(mid, torch.zeros(2, 16, 16, dtype=torch.int32,
                                               device=cuda),
                              torch.ones(2, device=cuda), 16)


# --------------------------------------------------------------------- #
# flash attention: K3 (flash_fwd), K4 (flash_bwd_dkv), K5 (flash_bwd_dq)
from gaiaseg_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

# [B, N, H]: the ViT step, the cls token, ragged tails, N = 1088, where the
# last 128-row block is half full (its second warpgroup owns no row), N = 64
# (one key tile) and N = 129 (a block with one real row)
ATTN_SHAPES = [(8, 1024, 12), (2, 1025, 12), (1, 200, 2), (1, 3, 1),
               (1, 1088, 2), (2, 64, 3), (2, 129, 3)]


def _attn(b, n, h, dtype, device, seed=0):
    """q pre-scaled; k and v as strided views into one kv tensor."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, n, h, 64).astype(np.float32) * 0.125)
    kv = torch.from_numpy(rng.randn(b, n, 2, h, 64).astype(np.float32))
    do = torch.from_numpy(rng.randn(b, n, h, 64).astype(np.float32))
    q, kv, do = (x.to(device=device, dtype=dtype) for x in (q, kv, do))
    return q, kv[:, :, 0], kv[:, :, 1], do


def _rel(got, ref):
    scale = float(ref.float().abs().max())
    return float((got.float() - ref.float()).abs().max()) / max(scale, 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_kernels_match_plain(cuda, shape, dtype):
    """Each kernel against its plain version on the same inputs: float32
    outputs within 1e-4 of max|ref| (summation order), bf16 within 2e-2
    (bf16 outputs, and P / dS rounded to bf16 as tensor-core operands); m
    and l within 1e-4. Each wrapper counts one launch."""
    q, k, v, do = _attn(*shape, dtype, cuda)
    before = dict(fa.LAUNCHES)
    o, m, l = fa.flash_fwd(q, k, v)
    ro, rm, rl = fa.flash_fwd_reference(q, k, v)
    di = fa.attention_di(ro, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, rm, rl, di)
    dq = fa.flash_bwd_dq(q, k, v, do, rm, rl, di)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, rm, rl, di)
    rdq = fa.flash_bwd_dq_reference(q, k, v, do, rm, rl, di)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel(m, rm) <= 1e-4 and _rel(l, rl) <= 1e-4
    for got, ref in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype and _rel(got, ref) <= tol
    for key in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert fa.LAUNCHES[key] == before[key] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1025, 12), (1, 1088, 2)])
def test_flash_backward_is_deterministic(cuda, shape, dtype):
    """K4 and K5 launched twice on the same inputs give the same bits: each
    block writes only its own rows, no atomics."""
    q, k, v, do = _attn(*shape, dtype, cuda, seed=2)
    o, m, l = fa.flash_fwd(q, k, v)
    di = fa.attention_di(o, do)
    first = (*fa.flash_bwd_dkv(q, k, v, do, m, l, di),
             fa.flash_bwd_dq(q, k, v, do, m, l, di))
    second = (*fa.flash_bwd_dkv(q, k, v, do, m, l, di),
              fa.flash_bwd_dq(q, k, v, do, m, l, di))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1025, 12), (2, 129, 3)])
def test_flash_forward_is_deterministic(cuda, shape, dtype):
    """K3 launched twice on the same inputs gives the same o, m and l."""
    q, k, v, _ = _attn(*shape, dtype, cuda, seed=4)
    for a, b in zip(fa.flash_fwd(q, k, v), fa.flash_fwd(q, k, v)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_forward_of_zeros_is_zero(cuda):
    """All-zero q, k, v (a masked head) give exactly zero output."""
    q, k, v, _ = _attn(2, 200, 3, torch.bfloat16, cuda)
    o, m, l = fa.flash_fwd(q * 0, k * 0, v * 0)
    assert float(o.abs().max()) == 0.0 and float(m.abs().max()) == 0.0
    assert torch.equal(l, torch.full_like(l, 200.0))


@pytest.mark.gpu
def test_flash_autograd_matches_plain(cuda):
    """flash_attention's gradients (K4 + K5 behind the autograd Function)
    against autograd through the plain forward, bf16, 2e-2 of max|ref|."""
    q, k, v, do = _attn(2, 256, 4, torch.bfloat16, cuda, seed=1)
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*xs), xs, do)
    rs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    rgrads = torch.autograd.grad(fa.flash_fwd_reference(*rs)[0], rs, do)
    for g, r in zip(grads, rgrads):
        assert _rel(g, r) <= 2e-2


@pytest.mark.gpu
def test_flash_wrappers_raise_on_bad_input(cuda):
    q, k, v, _ = _attn(1, 64, 2, torch.bfloat16, cuda)
    with pytest.raises(ValueError):        # head dim other than 64
        fa.flash_fwd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError):        # float16
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):        # mixed dtypes
        fa.flash_fwd(q, k.float(), v)


# --------------------------------------------------------------------- #
# the data pipeline on the card (plain PyTorch ops, no repo kernel)
# --------------------------------------------------------------------- #
from gaiaseg_tpu_torch.data import transforms as tf  # noqa: E402

NORM_MEAN = (123.675, 116.28, 103.53)
NORM_STD = (58.395, 57.12, 57.375)


def _records(n, h, w, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    lab = np.kron(rng.randint(0, 19, (n, 4, 4)),
                  np.ones((1, h // 4, w // 4), np.int64)).astype(np.uint8)
    lab[:, :3] = 255
    return torch.from_numpy(img), torch.from_numpy(lab)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [False, True])
def test_augment_batch_on_the_card_matches_the_cpu(cuda, cache):
    """The flagship pipeline's parameters at a quarter of its size: labels
    equal, the float32 image within the CPU parity tolerance (2e-5,
    normalized), the bf16 image the float32 one rounded."""
    img, lab = _records(4, 256, 512, seed=1)
    params = tf.draw_augment_params(torch.Generator().manual_seed(2), 4,
                                    (0.5, 2.0), 0.5)
    kw = dict(crop_size=(128, 256), cat_max_ratio=0.75, num_classes=19)
    want = tf.augment_batch(img, lab, params, NORM_MEAN, NORM_STD,
                            dtype=torch.float32, **kw)
    dev = tf.params_to(params, cuda)
    if cache:
        idx = torch.arange(4, device=cuda)
        got = tf.gather_augment_batch(img.to(cuda), lab.to(cuda), idx, dev,
                                      NORM_MEAN, NORM_STD,
                                      dtype=torch.float32, **kw)
    else:
        got = tf.augment_batch(img.to(cuda), lab.to(cuda), dev, NORM_MEAN,
                               NORM_STD, dtype=torch.float32, **kw)
    assert torch.equal(got["gt"].cpu(), want["gt"])
    assert float((got["img"].cpu() - want["img"]).abs().max()) <= 2e-5
    bf = tf.augment_batch(img.to(cuda), lab.to(cuda), dev, NORM_MEAN,
                          NORM_STD, **kw)
    assert bf["img"].dtype == torch.bfloat16
    assert torch.equal(bf["img"], got["img"].to(torch.bfloat16))


@pytest.mark.gpu
def test_prefetch_on_a_side_stream_matches_the_cpu_feed(cuda):
    """``make_train_feed`` on the card (uploads and augment on a side
    stream, pinned ring of 2 buffers, depth 3) yields the CPU feed's
    batches, each still intact after the consumer's stream has run other
    work that allocates and frees (the caching allocator must not reuse a
    batch the consumer owns)."""
    from gaiaseg_tpu_torch.data import SyntheticDataset, \
        parse_train_pipeline
    from gaiaseg_tpu_torch.data.staging import take
    from gaiaseg_tpu_torch.engine.train import make_train_feed
    pipe = parse_train_pipeline([
        dict(type="Resize", img_scale=(256, 128), ratio_range=(0.5, 2.0)),
        dict(type="RandomCrop", crop_size=(64, 128), cat_max_ratio=0.75),
        dict(type="RandomFlip", prob=0.5), dict(type="PhotoMetricDistortion")])
    ds = SyntheticDataset(length=10, size=(128, 256), num_classes=19)
    cpu = make_train_feed(ds, pipe, 4, 19, torch.device("cpu"), seed=1)
    card = make_train_feed(ds, pipe, 4, 19, cuda, seed=1, depth=3)
    try:
        for _ in range(6):
            img, gt, ready = next(card)
            take((img, gt), ready)
            want_img, want_gt, _ = next(cpu)
            for _ in range(3):        # churn the consumer stream's pool
                torch.randn(4, 3, 64, 128, device=cuda).mul_(2).sum()
            assert torch.equal(gt.cpu(), want_gt)
            # bf16 of the card's float32 (within 2e-5 of the CPU's)
            err = (img.float().cpu() - want_img).abs()
            assert bool((err <= 2e-5 + want_img.abs() * 2 ** -8).all())
    finally:
        card.close()
        cpu.close()
