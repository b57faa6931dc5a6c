"""The port's Dice, focal, mixed, EQL and packed-label losses against the
JAX package.

Seeded numpy inputs with ignored pixels (logits NCHW here, NHWC there) go
through each JAX function and its port. JAX runs in float64 (x64 on, the
float32 casts of its loss modules made float64 for the call, the package
unchanged) and the port in float64: values and the logits' gradients
within 1e-6 of max|ref| (measured: within 1e-15).

- Dice (multiclass and binary), sigmoid and softmax focal, ``MixedLoss``
  built from a config, ``mask_cross_entropy``, ``self_cross_entropy``
  (its gradient through the detached "self" target is zero),
  ``decode_packed_labels`` (exact).
- EQL at ``sample_ratio`` 0 and 1 (no draw matters), with an injected keep
  mask (JAX's ``bernoulli`` patched to return it), and its draw from a
  seeded generator: the kept share of the tail negatives within 4
  binomial standard deviations of ``1 - sample_ratio``, the same seed the
  same loss, another seed another (JAX draws from ``PRNGKey(0)`` on every
  call: ROADMAP C19).
- A segmentor whose decode loss is Dice, focal, Mixed or EQL takes the
  unfused path (``fused_resize_ce`` is not called for it) and equals the
  loss on the resized logits; EQL there draws from the step's generator.
- On 2 gloo ranks each loss's shares add up to the one-process value and
  the ranks' gradients are the one-process gradient's rows (Dice's sums
  span the ranks).

The JAX package is imported inside the tests, so that the spawned ranks,
which import this module, load torch alone.
"""
import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch import parallel
from gaiaseg_tpu_torch.models import (build_loss, build_segmentor,
                                      encode_arch, model_max_arch)
from gaiaseg_tpu_torch.models.losses import (
    binary_dice, decode_packed_labels, equalize_loss, mask_cross_entropy,
    multiclass_dice, self_cross_entropy, sigmoid_focal, softmax_focal)
from gaiaseg_tpu_torch.models.segmentors import encoder_decoder
from gaiaseg_tpu_torch.ops.dropout import global_bernoulli
from gaiaseg_tpu_torch.ops.resize import resize_bilinear

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
RTOL = 1e-6
C = 6
TAIL = (2, 3, 5)


def _inputs(n=4, h=6, w=5, seed=4):
    rng = np.random.RandomState(seed)
    logits = 2 * rng.randn(n, h, w, C)
    label = rng.randint(0, C, (n, h, w)).astype(np.int32)
    label[rng.rand(n, h, w) < 0.2] = 255
    return logits, label


def _packed(n=4, h=6, w=5, seed=5):
    """Packed multi-labels: each category's 3-bit code in {0, 1, 2, 3}, a
    fifth of the pixels 255."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 4, (n, h, w, C))
    codes[rng.rand(n, h, w, C) < 0.5] = 0
    label = sum(codes[..., k] << (3 * k) for k in range(C)).astype(np.int64)
    label[rng.rand(n, h, w) < 0.2] = 255
    return label


def _t(logits):
    return torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2)))


def _jax_value_and_grad(fn, logits, *args, **kw):
    """JAX's ``fn(logits, *args, **kw)`` and its gradient in the logits,
    in float64 (the loss modules' float32 casts made float64)."""
    import gaiaseg_tpu.models.losses.cross_entropy as j_ce
    import gaiaseg_tpu.models.losses.dice_focal as j_df
    import gaiaseg_tpu.models.losses.eql as j_eql
    import jax
    import jax.numpy as jnp
    from test_torch_deeplab import _Float64Numpy
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in (j_ce, j_df, j_eql):
            mp.setattr(mod, "jnp", _Float64Numpy())
        v, g = jax.value_and_grad(lambda x: fn(x, *args, **kw))(
            jnp.asarray(logits, jnp.float64))
        return float(v), np.asarray(g)


def _port_value_and_grad(fn, logits, *args, **kw):
    x = _t(logits).double().requires_grad_(True)
    v = fn(x, *args, **kw)
    v.backward()
    return float(v.detach()), x.grad.numpy().transpose(0, 2, 3, 1)


def _close(port, ref):
    (v, g), (rv, rg) = port, ref
    assert abs(v - rv) <= RTOL * abs(rv), (v, rv)
    np.testing.assert_allclose(g, rg, rtol=0,
                               atol=RTOL * float(np.abs(rg).max()))


def _jlabel(label):
    import jax.numpy as jnp
    return jnp.asarray(label)


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("smooth", [1.0, 0.1])
def test_multiclass_dice_matches_jax(smooth):
    from gaiaseg_tpu.models.losses.dice_focal import multiclass_dice as j_fn
    logits, label = _inputs()
    _close(_port_value_and_grad(multiclass_dice, logits,
                                torch.from_numpy(label), 255, smooth),
           _jax_value_and_grad(j_fn, logits, _jlabel(label), 255, smooth))


def test_binary_dice_loss_matches_jax():
    """``DiceLoss(binary_class=True)``: the sigmoid of class channel 0
    against ``label == 1``, every pixel counted (JAX's)."""
    from gaiaseg_tpu.models.losses.dice_focal import DiceLoss as JDice
    logits, label = _inputs()
    cfg = dict(binary_class=True, smooth=0.5, loss_weight=0.7)
    _close(_port_value_and_grad(build_loss(dict(type="DiceLoss", **cfg)),
                                logits, torch.from_numpy(label)),
           _jax_value_and_grad(JDice(**cfg), logits, _jlabel(label)))
    prob = torch.tensor([[0.2, 0.9], [0.5, 0.0]], dtype=torch.float64)
    target = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=torch.float64)
    assert float(binary_dice(prob, target, 1.0)) == pytest.approx(
        1.0 - (2 * 1.4 + 1.0) / (1.6 + 2.0 + 1.0))


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (0.5, 1.5)])
def test_sigmoid_focal_matches_jax(alpha, gamma):
    from gaiaseg_tpu.models.losses.dice_focal import sigmoid_focal as j_fn
    logits, label = _inputs()
    _close(_port_value_and_grad(sigmoid_focal, logits,
                                torch.from_numpy(label), alpha, gamma),
           _jax_value_and_grad(j_fn, logits, _jlabel(label), alpha, gamma))


@pytest.mark.parametrize("gamma", [2.0, 0.0])
def test_softmax_focal_matches_jax(gamma):
    """At gamma 0 it is the softmax CE."""
    from gaiaseg_tpu.models.losses.dice_focal import softmax_focal as j_fn
    from gaiaseg_tpu_torch.models.losses import softmax_cross_entropy
    logits, label = _inputs()
    got = _port_value_and_grad(softmax_focal, logits,
                               torch.from_numpy(label), gamma)
    _close(got, _jax_value_and_grad(j_fn, logits, _jlabel(label), gamma))
    if gamma == 0.0:
        _close(got, _port_value_and_grad(softmax_cross_entropy, logits,
                                         torch.from_numpy(label)))


MIXED = dict(type="MixedLoss", losses=[
    dict(type="CrossEntropyLoss"), dict(type="DiceLoss", smooth=0.5),
    dict(type="FocalLoss", use_sigmoid=False, gamma=2.0)],
    weights=[1.0, 0.5, 2.0], loss_weight=0.8)


@pytest.mark.parametrize("cfg", [
    MIXED, dict(type="FocalLoss", use_sigmoid=True, loss_weight=0.3),
    dict(type="DiceLoss", loss_weight=2.0)], ids=["mixed", "focal", "dice"])
def test_loss_from_config_matches_jax(cfg):
    from gaiaseg_tpu.models.losses.dice_focal import LOSSES as J_LOSSES
    logits, label = _inputs()
    _close(_port_value_and_grad(build_loss(cfg), logits,
                                torch.from_numpy(label)),
           _jax_value_and_grad(J_LOSSES.build(dict(cfg)), logits,
                               _jlabel(label)))


def test_decode_packed_labels_matches_jax():
    from gaiaseg_tpu.models.losses.eql import decode_packed_labels as j_fn
    label = _packed()
    want = np.asarray(j_fn(_jlabel(label.astype(np.int32)), C))
    got = decode_packed_labels(torch.from_numpy(label), C)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    assert want.any() and not want.all()


def test_self_cross_entropy_matches_jax_and_its_target_is_detached():
    from gaiaseg_tpu.models.losses.eql import self_cross_entropy as j_fn
    logits, _ = _inputs()
    label = _packed()
    got = _port_value_and_grad(self_cross_entropy, logits,
                               torch.from_numpy(label))
    _close(got, _jax_value_and_grad(j_fn, logits,
                                    _jlabel(label.astype(np.int32))))
    codes = np.stack([(label >> (3 * k)) & 7 for k in range(C)], -1)
    own = codes == 2                     # trains against its own sigmoid
    assert own.any()
    # the gradient of a "self" term is sigmoid(x) - stop_gradient(sigmoid
    # (x)) = 0 (rounding aside; through the target it would be -x
    # sigmoid'(x), of order 0.1 here): those logits get nothing
    assert np.abs(got[1][own]).max() <= 1e-15
    assert np.abs(got[1][codes == 1]).min() > 0


def test_mask_cross_entropy_matches_jax():
    from gaiaseg_tpu.models.losses.eql import mask_cross_entropy as j_fn
    logits, label = _inputs()
    mask = np.random.RandomState(6).rand(*label.shape) < 0.6
    import jax.numpy as jnp
    _close(_port_value_and_grad(mask_cross_entropy, logits,
                                torch.from_numpy(label),
                                torch.from_numpy(mask)),
           _jax_value_and_grad(j_fn, logits, _jlabel(label),
                               jnp.asarray(mask)))


@pytest.mark.parametrize("ratio", [0.0, 1.0])
def test_eql_at_ratio_0_and_1_matches_jax(ratio):
    """At ``sample_ratio`` 0 every negative is kept, at 1 every tail
    negative dropped: no draw matters."""
    import jax
    from gaiaseg_tpu.models.losses.eql import equalize_loss as j_fn
    logits, label = _inputs()
    g = torch.Generator().manual_seed(3)
    _close(_port_value_and_grad(equalize_loss, logits,
                                torch.from_numpy(label), g, TAIL, ratio),
           _jax_value_and_grad(j_fn, logits, _jlabel(label),
                               jax.random.PRNGKey(1), TAIL, ratio))


def test_eql_with_an_injected_mask_matches_jax():
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.models.losses.eql import EQLCrossEntropyLoss as JEQL
    logits, label = _inputs()
    keep = np.random.RandomState(7).rand(*logits.shape) < 0.4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p, shape: jnp.asarray(keep))
        want = _jax_value_and_grad(JEQL(tail_classes=TAIL, loss_weight=0.5),
                                   logits, _jlabel(label))
    got = _port_value_and_grad(
        lambda x, lab: 0.5 * equalize_loss(
            x, lab, None, TAIL, keep_mask=_t(keep.astype(np.float64))),
        logits, torch.from_numpy(label))
    _close(got, want)
    everything = _port_value_and_grad(equalize_loss, logits,
                                      torch.from_numpy(label), None, TAIL,
                                      0.0)
    assert everything[0] > 2 * got[0]       # the mask dropped terms


def test_eql_draw_keeps_its_share_and_follows_the_seed():
    """Every pixel of class 0, the other classes tail, logits 0: each
    pixel's loss is log 2 (1 + kept tail negatives), so the mean gives the
    kept share of 4 x 5 x 64 x 64 draws."""
    n, h, w, ratio = 4, 64, 64, 0.618
    x = torch.zeros(n, C, h, w, dtype=torch.float64)
    label = torch.zeros(n, h, w, dtype=torch.int64)
    tail = list(range(1, C))

    def loss(seed):
        return float(equalize_loss(x, label,
                                   torch.Generator().manual_seed(seed),
                                   tail, ratio))
    share = (loss(0) / np.log(2.0) - 1.0) / (C - 1)
    draws = n * h * w * (C - 1)
    keep = 1.0 - ratio
    assert abs(share - keep) <= 4 * (keep * ratio / draws) ** 0.5, share
    assert loss(0) == loss(0) != loss(1)
    # without a generator: one seeded 0, the same on every call
    assert float(equalize_loss(x, label, None, tail, ratio)) == loss(0)
    # the draw is JAX's bernoulli, uniform [0, 1) < keep: exact at 1 and 0
    g = torch.Generator().manual_seed(0)
    assert torch.all(global_bernoulli(x, x.shape, 1.0, g) == 1)
    assert torch.all(global_bernoulli(x, x.shape, 0.0, g) == 0)


# --------------------------------------------------------------------- #
def _segmentor_cfg(loss):
    return dict(
        type="DynamicEncoderDecoder",
        backbone=dict(type="DynamicResNet", stem_width=8,
                      body_width=[4, 8, 8, 16], body_depth=[1, 1, 1, 1],
                      out_indices=(0, 1, 2, 3)),
        decode_head=dict(type="DynamicFCNHead", in_index=3, channels=8,
                         num_convs=1, concat_input=False, dropout_ratio=0.0,
                         num_classes=C, loss_decode=loss),
        test_cfg=dict(mode="whole"))


@pytest.mark.parametrize("loss", [
    dict(type="DiceLoss"), dict(type="FocalLoss", use_sigmoid=False),
    MIXED, dict(type="EQLCrossEntropyLoss", tail_classes=TAIL)],
    ids=["dice", "focal", "mixed", "eql"])
def test_segmentor_takes_the_unfused_loss(monkeypatch, loss):
    calls = []
    real = encoder_decoder.fused_resize_ce

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(encoder_decoder, "fused_resize_ce", spy)
    cfg = _segmentor_cfg(loss)
    torch.manual_seed(0)
    model = build_segmentor(cfg).train()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 32, 32).astype(np.float32))
    gt = torch.from_numpy(rng.randint(0, C, (2, 32, 32)).astype(np.int32))
    arch = encode_arch(model_max_arch(cfg))

    def run(seed):
        return model.forward_train(
            img, gt, arch, torch.Generator().manual_seed(seed))[1][
            "decode.loss_seg"].detach()
    got = run(0)
    assert not calls
    with torch.no_grad():
        up = resize_bilinear(model.decode_head(model.extract_feat(img, arch)),
                             (32, 32))
        fn = build_loss(loss)
        extra = {"generator": torch.Generator().manual_seed(0)} \
            if loss["type"] == "EQLCrossEntropyLoss" else {}
        want = fn(up, gt, **extra)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    if loss["type"] == "EQLCrossEntropyLoss":    # the step's generator
        assert torch.equal(run(0), got) and not torch.equal(run(1), got)


# --------------------------------------------------------------------- #
RANK_LOSSES = {
    "dice": dict(type="DiceLoss"),
    "binary_dice": dict(type="DiceLoss", binary_class=True),
    "sigmoid_focal": dict(type="FocalLoss"),
    "softmax_focal": dict(type="FocalLoss", use_sigmoid=False),
    "mixed": MIXED,
    "eql": dict(type="EQLCrossEntropyLoss", tail_classes=TAIL,
                sample_ratio=0.5),
}


def _rank_losses(rank, world):
    """Each loss's share on this rank's rows of the batch and its
    gradient in them; EQL draws the global batch's mask from the shared
    seed and keeps its rows."""
    logits, label = _inputs(n=4)
    n = logits.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    out = {}
    for name, cfg in RANK_LOSSES.items():
        x = _t(logits[rows]).double().requires_grad_(True)
        fn = build_loss(cfg)
        kw = {"generator": torch.Generator().manual_seed(2)} \
            if name == "eql" else {}
        v = fn(x, torch.from_numpy(label[rows]), **kw)
        v.backward()
        out[name] = (parallel.sum_over_ranks(v.detach()), x.grad)
    return out


def test_losses_span_the_ranks(tmp_path):
    ranks = run_ranks(_rank_losses, tmp_path)
    one = _rank_losses(0, 1)
    for name, (value, grad) in one.items():
        for r, got in enumerate(ranks):
            torch.testing.assert_close(got[name][0], value, rtol=1e-12,
                                       atol=0, msg=name)
        torch.testing.assert_close(torch.cat([r[name][1] for r in ranks]),
                                   grad, rtol=1e-12, atol=1e-15, msg=name)
