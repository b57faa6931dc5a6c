"""The port's device-side augmentation against the JAX package's.

JAX PRNG is not torch RNG: the port splits every random op into a draw
step and a deterministic apply step. These tests take the parameters the
JAX functions draw from a key (the same ``jax.random`` calls on the same
key splits) and feed them to the port's apply step, on the same images.

- ``fused_resize_crop`` (identity, shrink with padding, upscale): labels and
  valid equal, image within 1e-4 on the 0..255 scale.
- ``random_scale_crop`` (``cat_max_ratio`` 0.75 and 1.0): the same
  candidate origins and chosen origin, histograms equal as integers, labels
  equal.
- ``photometric_distortion``: within 1e-3 on the 0..255 scale.
- ``augment_batch``: labels equal; the float32 image within 2e-5 of JAX's
  (its random_scale_crop, flip, photometric_distortion and normalize with
  the same keys, before the bf16 cast); the bf16 images at most one ulp
  apart; the labels equal JAX's jitted ``augment_batch``'s.
- ``prepare_eval_batch`` without a size: equal bf16; with a size (the
  antialiased ``jax.image.resize``): float32 within 1e-3;
  ``gather_prepare_eval_batch`` with ``pad``: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.data import transforms as J
from gaiaseg_tpu_torch.data import transforms as T

torch.set_num_threads(1)
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
CROP = (24, 32)


def _images(b, h, w, seed, classes=5, cells=4):
    """uint8 images and blocky labels (so some crops are dominated by one
    class), with a patch of ignore pixels."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    grid = rng.randint(0, classes, (b, cells, cells))
    lab = np.stack([np.kron(g, np.ones((h // cells + 1, w // cells + 1)))
                    [:h, :w] for g in grid]).astype(np.int32)
    lab[:, 2:5, 3:9] = 255
    return img, lab


def _u(key, lo=0.0, hi=1.0, shape=()):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def jax_params(key, b, ratio_range=(0.5, 2.0), flip_prob=0.5, trials=10):
    """What JAX ``augment_batch`` draws from ``key``, as the port's
    parameters (``transforms.py`` key splits: per image k1 -> scale and
    trials, k2 -> flip, k3 -> ten photometric keys)."""
    cols = {k: [] for k in ("scale", "trials", "flip", "bright_on", "bright",
                            "alpha", "sat_on", "sat", "hue_on", "hue",
                            "contrast_first", "contrast_pre_on",
                            "contrast_post_on")}
    for key_i in jax.random.split(key, b):
        k1, k2, k3 = jax.random.split(key_i, 3)
        k_scale, k_off = jax.random.split(k1)
        cols["scale"].append(_u(k_scale, *ratio_range))
        cols["trials"].append(_u(k_off, shape=(trials, 2)))
        cols["flip"].append(_u(k2) < flip_prob)
        ks = jax.random.split(k3, 10)
        cols["bright_on"].append(_u(ks[0]) < 0.5)
        cols["bright"].append(_u(ks[1], -32.0, 32.0))
        cols["alpha"].append(_u(ks[2], 0.5, 1.5))
        cols["sat_on"].append(_u(ks[3]) < 0.5)
        cols["sat"].append(_u(ks[4], 0.5, 1.5))
        cols["hue_on"].append(_u(ks[5]) < 0.5)
        cols["hue"].append(_u(ks[6], -18.0, 18.0))
        cols["contrast_first"].append(_u(ks[7]) < 0.5)
        cols["contrast_pre_on"].append(_u(ks[8]) < 0.5)
        cols["contrast_post_on"].append(_u(ks[9]) < 0.5)
    return {k: torch.from_numpy(np.stack(v)) for k, v in cols.items()}


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("scale,size", [(1.0, (24, 32)), (0.5, (40, 56)),
                                        (1.7, (20, 23))])
def test_fused_resize_crop_matches_jax(scale, size):
    """identity, a shrink whose scaled image is smaller than the crop (pad),
    an upscale; origins differ per image, one image flipped."""
    img, lab = _images(3, *size, seed=1)
    oy, ox = np.array([0, 3, 5]), np.array([2, 0, 7])
    flip = torch.tensor([False, True, False])
    got = T.fused_resize_crop(torch.from_numpy(img), torch.from_numpy(lab),
                              torch.full((3,), scale), torch.from_numpy(oy),
                              torch.from_numpy(ox), CROP, flip=flip)
    for b in range(3):
        ji, jl, jv = (np.asarray(a) for a in J.fused_resize_crop(
            jnp.asarray(img[b], jnp.float32), jnp.asarray(lab[b]),
            jnp.float32(scale), jnp.int32(oy[b]), jnp.int32(ox[b]), CROP))
        if flip[b]:
            ji, jl, jv = ji[:, ::-1], jl[:, ::-1], jv[:, ::-1]
        np.testing.assert_array_equal(got[1][b].numpy(), jl)
        np.testing.assert_array_equal(got[2][b].numpy(), jv)
        np.testing.assert_allclose(_nhwc(got[0])[b], ji, rtol=0, atol=1e-4)
    if scale == 0.5:
        assert not got[2].all() and (got[1][~got[2]] == 255).all()


def _jax_origin(key_i, label, crop, ratio_range, cat_max_ratio, classes):
    """JAX random_scale_crop's candidates, histograms and chosen origin,
    by the lines of ``gaiaseg_tpu/data/transforms.py:random_scale_crop``."""
    h, w = label.shape
    k_scale, k_off = jax.random.split(jax.random.split(key_i, 3)[0])
    scale = jax.random.uniform(k_scale, (), minval=ratio_range[0],
                               maxval=ratio_range[1])
    sh, sw = jnp.floor(h * scale + 0.5), jnp.floor(w * scale + 0.5)
    us = jax.random.uniform(k_off, (10, 2))
    cy = jnp.floor(us[:, 0] * (jnp.maximum(sh - crop[0], 0.0) + 1.0)
                   ).astype(jnp.int32)
    cx = jnp.floor(us[:, 1] * (jnp.maximum(sw - crop[1], 0.0) + 1.0)
                   ).astype(jnp.int32)
    counts = J._trial_histograms(jnp.asarray(label), scale, cy, cx, crop,
                                 classes, 255)
    ok = (counts.max(-1) / jnp.maximum(counts.sum(-1), 1.0)) < cat_max_ratio
    chosen = int(jnp.argmax(ok)) if bool(jnp.any(ok)) else 9
    if cat_max_ratio >= 1.0:
        chosen = 0
    return (np.asarray(cy), np.asarray(cx), np.asarray(counts),
            (int(cy[chosen]), int(cx[chosen])))


@pytest.mark.parametrize("cat_max_ratio", [0.75, 1.0])
def test_random_scale_crop_matches_jax(cat_max_ratio):
    b, classes, rr = 4, 5, (0.5, 2.0)
    img, lab = _images(b, 40, 56, seed=2, classes=classes, cells=3)
    lab[:, :, :36] = 1          # most crops are mostly class 1: rejected
    key = jax.random.PRNGKey(7)
    params = jax_params(key, b, rr)
    ti, tl = torch.from_numpy(img), torch.from_numpy(lab)
    rows = torch.arange(b)
    cand_y, cand_x = T.crop_candidates((40, 56), params["scale"],
                                       params["trials"], CROP)
    counts = T.trial_histograms(tl, rows, params["scale"], cand_y, cand_x,
                                CROP, classes)
    oy, ox = T.choose_crop_origin(tl, rows, params["scale"],
                                  params["trials"], CROP, cat_max_ratio,
                                  classes)
    crop, label, valid = T.random_scale_crop(ti, tl, params, CROP,
                                             cat_max_ratio, classes)
    rejected = 0
    for i, key_i in enumerate(jax.random.split(key, b)):
        jy, jx, jc, origin = _jax_origin(key_i, lab[i], CROP, rr,
                                         cat_max_ratio, classes)
        np.testing.assert_array_equal(cand_y[i].numpy(), jy)
        np.testing.assert_array_equal(cand_x[i].numpy(), jx)
        np.testing.assert_array_equal(counts[i].numpy(),
                                      jc.astype(np.int64))
        assert (int(oy[i]), int(ox[i])) == origin
        rejected += origin != (int(jy[0]), int(jx[0]))
        ji, jl, jv = (np.asarray(a) for a in J.random_scale_crop(
            jax.random.split(key_i, 3)[0], jnp.asarray(img[i], jnp.float32),
            jnp.asarray(lab[i]), CROP, rr, cat_max_ratio=cat_max_ratio,
            num_classes=classes))
        np.testing.assert_array_equal(label[i].numpy(), jl)
        np.testing.assert_array_equal(valid[i].numpy(), jv)
        np.testing.assert_allclose(_nhwc(crop)[i], ji, rtol=0, atol=1e-4)
    if cat_max_ratio < 1.0:
        assert rejected > 0      # the trials did choose somewhere


def test_photometric_distortion_matches_jax():
    b = 6
    rng = np.random.RandomState(3)
    img = rng.uniform(0, 255, (b, 8, 12, 3)).astype(np.float32)
    img[0, :2, :2] = 128.0                  # grey pixels: hue 0
    key = jax.random.PRNGKey(11)
    params = jax_params(key, b)
    got = T.photometric_distortion(
        torch.from_numpy(img).permute(0, 3, 1, 2), params)
    for i, key_i in enumerate(jax.random.split(key, b)):
        k3 = jax.random.split(key_i, 3)[2]
        want = np.asarray(J.photometric_distortion(k3, jnp.asarray(img[i])))
        np.testing.assert_allclose(_nhwc(got)[i], want, rtol=0, atol=1e-3)


def _jax_augment_f32(key, img, lab, crop, rr, cat_max_ratio, classes,
                     flip_prob):
    """JAX ``augment_batch``'s per-image body, before its bf16 cast."""
    mean, std = jnp.asarray(MEAN), jnp.asarray(STD)
    imgs, labs = [], []
    for i, k in enumerate(jax.random.split(key, img.shape[0])):
        k1, k2, k3 = jax.random.split(k, 3)
        x, y, v = J.random_scale_crop(k1, jnp.asarray(img[i], jnp.float32),
                                      jnp.asarray(lab[i]), crop, rr,
                                      cat_max_ratio=cat_max_ratio,
                                      num_classes=classes)
        coin = jax.random.uniform(k2, ()) < flip_prob
        x = jnp.where(coin, x[:, ::-1], x)
        y = jnp.where(coin, y[:, ::-1], y)
        v = jnp.where(coin, v[:, ::-1], v)
        x = J.normalize(J.photometric_distortion(k3, x), mean, std)
        imgs.append(np.asarray(jnp.where(v[..., None], x, 0.0)))
        labs.append(np.asarray(y))
    return np.stack(imgs), np.stack(labs)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    ia = torch.where(ia < 0, -32768 - ia, ia)      # sign-magnitude -> order
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("b,cat_max_ratio", [(2, 0.75), (4, 1.0)])
def test_augment_batch_matches_jax(b, cat_max_ratio):
    classes, rr, size = 5, (0.5, 2.0), (40, 56)
    img, lab = _images(b, *size, seed=4, classes=classes, cells=3)
    key = jax.random.PRNGKey(b)
    params = jax_params(key, b, rr, flip_prob=0.5)
    kw = dict(crop_size=CROP, cat_max_ratio=cat_max_ratio,
              num_classes=classes, photometric=True)
    got = T.augment_batch(torch.from_numpy(img),
                          torch.from_numpy(lab.astype(np.uint8)), params,
                          MEAN, STD, dtype=torch.float32, **kw)
    want_img, want_lab = _jax_augment_f32(key, img, lab, CROP, rr,
                                          cat_max_ratio, classes, 0.5)
    assert got["gt"].dtype == torch.int32 and got["img"].is_contiguous()
    np.testing.assert_array_equal(got["gt"].numpy(), want_lab)
    np.testing.assert_allclose(_nhwc(got["img"]), want_img, rtol=0,
                               atol=2e-5)
    bf = T.augment_batch(torch.from_numpy(img), torch.from_numpy(lab),
                         params, MEAN, STD, **kw)
    assert bf["img"].dtype == torch.bfloat16
    want_bf = torch.from_numpy(want_img).to(torch.bfloat16)
    assert _ulps(bf["img"], want_bf.permute(0, 3, 1, 2).contiguous()) <= 1
    # JAX's jitted augment_batch draws the same crops and flips (its image
    # differs from its own unfused composition on the CPU backend: the
    # fused program takes some pixels' hue from the wrong branch; see
    # ROADMAP.md queue C)
    jb = J.augment_batch(key, jnp.asarray(img), jnp.asarray(lab),
                         jnp.asarray(MEAN), jnp.asarray(STD),
                         ratio_range=rr, flip_prob=0.5, **kw)
    np.testing.assert_array_equal(bf["gt"].numpy(), np.asarray(jb["gt"]))


def test_gather_augment_batch_reads_the_cache_in_place():
    img, lab = _images(5, 40, 56, seed=5)
    idx = torch.tensor([3, 0, 3])
    params = T.draw_augment_params(torch.Generator().manual_seed(0), 3)
    kw = dict(crop_size=CROP, num_classes=5, dtype=torch.float32)
    got = T.gather_augment_batch(torch.from_numpy(img),
                                 torch.from_numpy(lab), idx, params, MEAN,
                                 STD, **kw)
    want = T.augment_batch(torch.from_numpy(img[idx.numpy()]),
                           torch.from_numpy(lab[idx.numpy()]), params, MEAN,
                           STD, **kw)
    for k in ("img", "gt"):
        assert torch.equal(got[k], want[k])


def test_draw_augment_params_is_a_seeded_stream():
    a = T.draw_augment_params(torch.Generator().manual_seed(3), 4,
                              (0.25, 1.0), flip_prob=0.0)
    b = T.draw_augment_params(torch.Generator().manual_seed(3), 4,
                              (0.25, 1.0), flip_prob=0.0)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert a["trials"].shape == (4, T.MAX_TRIALS, 2)
    assert ((a["scale"] >= 0.25) & (a["scale"] < 1.0)).all()
    assert not a["flip"].any()
    assert (a["hue"].abs() <= T.HUE_DELTA).all()
    c = T.draw_augment_params(torch.Generator().manual_seed(4), 4)
    assert not torch.equal(a["trials"], c["trials"])


@pytest.mark.parametrize("size", [None, (13, 40), (40, 90)])
def test_prepare_eval_batch_matches_jax(size):
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (2, 26, 60, 3)).astype(np.uint8)
    mean, std = jnp.asarray(MEAN), jnp.asarray(STD)
    want_bf = np.asarray(J.prepare_eval_batch(jnp.asarray(img), mean, std,
                                              size=size)).astype(np.float32)
    got_bf = T.prepare_eval_batch(torch.from_numpy(img), MEAN, STD, size=size)
    got = T.prepare_eval_batch(torch.from_numpy(img), MEAN, STD, size=size,
                               dtype=torch.float32)
    want_bf = torch.from_numpy(want_bf).to(torch.bfloat16).permute(0, 3, 1, 2)
    if size is None:
        assert torch.equal(got_bf, want_bf.contiguous())
        return
    x = J.normalize(jnp.asarray(img, jnp.float32), mean, std)
    want = np.asarray(jax.image.resize(x, (2, *size, 3), method="bilinear"))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-3)


def test_gather_prepare_eval_batch_masks_the_padded_tail():
    img, lab = _images(5, 12, 16, seed=7)
    idx = np.array([3, 4, 0, 1], np.int32)
    got_img, got_gt = T.gather_prepare_eval_batch(
        torch.from_numpy(img), torch.from_numpy(lab), torch.from_numpy(idx),
        MEAN, STD, pad=2)
    want_img, want_gt = J.gather_prepare_eval_batch(
        jnp.asarray(img), jnp.asarray(lab), jnp.asarray(idx),
        jnp.asarray(MEAN), jnp.asarray(STD), jnp.asarray(2, jnp.int32))
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
    assert (got_gt[2:] == 255).all()
    want = torch.from_numpy(np.asarray(want_img).astype(np.float32)
                            ).to(torch.bfloat16).permute(0, 3, 1, 2)
    assert torch.equal(got_img, want.contiguous())


def test_random_flip_matches_jax():
    img, lab = _images(3, 6, 9, seed=8)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    coins = torch.tensor([bool(_u(k) < 0.5) for k in keys])
    x = torch.from_numpy(img.astype(np.float32)).permute(0, 3, 1, 2)
    got_img, got_lab = T.random_flip(x, torch.from_numpy(lab), coins)
    for i, k in enumerate(keys):
        ji, jl = J.random_flip(k, jnp.asarray(img[i], jnp.float32),
                               jnp.asarray(lab[i]))
        np.testing.assert_array_equal(_nhwc(got_img)[i], np.asarray(ji))
        np.testing.assert_array_equal(got_lab[i].numpy(), np.asarray(jl))
    assert coins.any() and not coins.all()
