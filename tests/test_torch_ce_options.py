"""The port's cross-entropy options against the JAX package.

- ``softmax_cross_entropy`` with and without class weights and a pixel
  weight, under each reduction (``none``, ``sum``, ``mean`` with and
  without ``avg_non_ignore``), and ``binary_cross_entropy`` with and
  without class weights, against JAX's on the same numpy inputs (logits
  NCHW here, NHWC there): within 1e-5 relative (elementwise for ``none``).
- ``CrossEntropyLoss`` built from a config (``use_sigmoid``,
  ``class_weight``, ``loss_weight``, ``use_mask`` accepted and ignored)
  against JAX's ``CrossEntropyLoss``.
- The segmentor's gate: a plain CE takes ``fused_resize_ce`` twice (decode
  and aux); class weights, the sigmoid or another reduction on the decode
  loss take the unfused loss for it, which equals the loss function on the
  resized logits.
- Across 2 gloo ranks with unequal valid counts, each loss's shares add up
  to the one-process value on the whole batch (the denominators span the
  ranks).

The JAX package is imported inside the tests, so that the spawned ranks,
which import this module, load torch alone.
"""
import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch import parallel
from gaiaseg_tpu_torch.models import build_loss, build_segmentor, \
    encode_arch, model_max_arch
from gaiaseg_tpu_torch.models.losses.cross_entropy import (
    binary_cross_entropy, softmax_cross_entropy)
from gaiaseg_tpu_torch.models.segmentors import encoder_decoder
from gaiaseg_tpu_torch.ops.resize import resize_bilinear

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
RTOL = 1e-5
C = 6
CLASS_WEIGHT = [1.0, 2.0, 0.5, 1.5, 0.25, 3.0]


def _inputs(n=4, h=6, w=5, seed=4):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(n, h, w, C)).astype(np.float32)
    label = rng.randint(0, C, (n, h, w)).astype(np.int32)
    label[rng.rand(n, h, w) < 0.2] = 255
    label[n // 2:][rng.rand(n - n // 2, h, w) < 0.6] = 255
    pixel = rng.uniform(0.5, 2.0, (n, h, w)).astype(np.float32)
    return logits, label, pixel


def _t(logits):
    return torch.from_numpy(logits.transpose(0, 3, 1, 2).copy())


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("reduction,avg_non_ignore", [
    ("none", True), ("sum", True), ("mean", True), ("mean", False)])
@pytest.mark.parametrize("class_weight", [None, CLASS_WEIGHT])
@pytest.mark.parametrize("pixel_weight", [False, True])
def test_softmax_cross_entropy_matches_jax(reduction, avg_non_ignore,
                                           class_weight, pixel_weight):
    import jax.numpy as jnp
    from gaiaseg_tpu.models.losses.cross_entropy import \
        softmax_cross_entropy as j_ce
    logits, label, pixel = _inputs()
    want = j_ce(jnp.asarray(logits), jnp.asarray(label),
                class_weight=class_weight, reduction=reduction,
                avg_non_ignore=avg_non_ignore,
                pixel_weight=jnp.asarray(pixel) if pixel_weight else None)
    got = softmax_cross_entropy(
        _t(logits), torch.from_numpy(label), 255, avg_non_ignore,
        class_weight, reduction,
        torch.from_numpy(pixel) if pixel_weight else None)
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got.numpy(), want)


@pytest.mark.parametrize("class_weight", [None, CLASS_WEIGHT])
def test_binary_cross_entropy_matches_jax(class_weight):
    import jax.numpy as jnp
    from gaiaseg_tpu.models.losses.cross_entropy import \
        binary_cross_entropy as j_bce
    logits, label, _ = _inputs()
    want = j_bce(jnp.asarray(logits), jnp.asarray(label), 255, class_weight)
    got = binary_cross_entropy(_t(logits), torch.from_numpy(label), 255,
                               class_weight)
    _close(got.numpy(), want)


LOSS_CFGS = {
    "sigmoid": dict(use_sigmoid=True, loss_weight=0.4),
    "sigmoid_weighted": dict(use_sigmoid=True, class_weight=CLASS_WEIGHT),
    "class_weight": dict(class_weight=CLASS_WEIGHT, loss_weight=0.7),
    "use_mask": dict(use_mask=True),
    "sum": dict(reduction="sum"),
    "not_avg_non_ignore": dict(avg_non_ignore=False),
}


@pytest.mark.parametrize("name", sorted(LOSS_CFGS))
def test_cross_entropy_loss_from_config_matches_jax(name):
    import jax.numpy as jnp
    from gaiaseg_tpu.models.losses.cross_entropy import \
        CrossEntropyLoss as JCrossEntropyLoss
    cfg = LOSS_CFGS[name]
    logits, label, _ = _inputs()
    want = JCrossEntropyLoss(**cfg)(jnp.asarray(logits), jnp.asarray(label))
    got = build_loss(dict(type="CrossEntropyLoss", **cfg))(
        _t(logits), torch.from_numpy(label))
    _close(got.numpy(), want)


def _segmentor_cfg(loss):
    ce = dict(type="CrossEntropyLoss")
    return dict(
        type="DynamicEncoderDecoder",
        backbone=dict(type="DynamicResNet", stem_width=8,
                      body_width=[4, 8, 8, 16], body_depth=[1, 1, 1, 1],
                      strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                      contract_dilation=True, out_indices=(0, 1, 2, 3)),
        decode_head=dict(type="DepthwiseSeparableASPPHead", in_index=3,
                         channels=8, dilations=(1, 2), c1_in_index=0,
                         c1_channels=4, dropout_ratio=0.0, num_classes=C,
                         loss_decode=dict(ce, **loss)),
        auxiliary_head=dict(type="DynamicFCNHead", in_index=2, channels=8,
                            num_convs=1, concat_input=False,
                            dropout_ratio=0.0, num_classes=C,
                            loss_decode=dict(ce, loss_weight=0.4)),
        test_cfg=dict(mode="whole"))


@pytest.mark.parametrize("name", ["plain"] + sorted(LOSS_CFGS))
def test_gate_sends_the_options_to_the_unfused_loss(monkeypatch, name):
    calls = []
    real = encoder_decoder.fused_resize_ce

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(encoder_decoder, "fused_resize_ce", spy)
    loss = {} if name == "plain" else LOSS_CFGS[name]
    cfg = _segmentor_cfg(loss)
    torch.manual_seed(0)
    model = build_segmentor(cfg).train()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 32, 32).astype(np.float32))
    gt = torch.from_numpy(rng.randint(0, C, (2, 32, 32)).astype(np.int32))
    _, logs = model.forward_train(img, gt,
                                  encode_arch(model_max_arch(cfg)))
    fused = name in ("plain", "use_mask")
    assert len(calls) == 1 + fused
    with torch.no_grad():
        logit = model.decode_head(model.extract_feat(
            img, encode_arch(model_max_arch(cfg))))
        want = build_loss(dict(type="CrossEntropyLoss", **loss))(
            resize_bilinear(logit, (32, 32)), gt)
    torch.testing.assert_close(logs["decode.loss_seg"].detach(), want,
                               rtol=RTOL, atol=0)


def _rank_losses(rank, world):
    logits, label, pixel = _inputs(n=4)
    n = logits.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    x, lab = _t(logits[rows]), torch.from_numpy(label[rows])
    pw = torch.from_numpy(pixel[rows])
    out = {
        "weighted_mean": softmax_cross_entropy(
            x, lab, class_weight=CLASS_WEIGHT, pixel_weight=pw),
        "mean_all_pixels": softmax_cross_entropy(
            x, lab, avg_non_ignore=False, class_weight=CLASS_WEIGHT),
        "sum": softmax_cross_entropy(x, lab, reduction="sum"),
        "sigmoid": binary_cross_entropy(x, lab, class_weight=CLASS_WEIGHT),
    }
    return {k: parallel.sum_over_ranks(v) for k, v in out.items()}


def test_reductions_span_the_ranks(tmp_path):
    ranks = run_ranks(_rank_losses, tmp_path)
    one = _rank_losses(0, 1)
    for name, want in one.items():
        for r in ranks:
            torch.testing.assert_close(r[name], want, rtol=RTOL, atol=0,
                                       msg=name)
