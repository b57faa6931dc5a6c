"""On-device data augmentation with mmseg-pipeline semantics, batched.

Port of ``gaiaseg_tpu/data/transforms.py``. The reference train pipeline
(``configs/_dynamic_/models/pspnet_ar50to101v2_gsync.py:60-72``):
Resize(img_scale, ratio_range) -> RandomCrop(crop_size, cat_max_ratio) ->
RandomFlip -> PhotoMetricDistortion -> Normalize -> Pad(crop_size, 255).
Resize + RandomCrop + Pad fuse into one resample of the crop window straight
from the original image (bilinear image, nearest label), so no variable-size
intermediate image exists and the whole chain runs as a few dozen batched
ops on the card, over all images of a batch at once.

JAX PRNG is not torch RNG, so every random op is split in two:

- ``draw_augment_params`` draws the per-image parameters on the host from
  an explicit CPU ``torch.Generator``: the scale ratio, the crop trials'
  uniforms, the flip coin and the photometric coins and values;
- the apply functions (``augment_batch`` and the pieces under it) are
  deterministic in those parameters, which are uploaded with the batch.

Images come in as NHWC (the records' layout, uint8 or float32 on the 0..255
scale) and go out NCHW; labels come in with any integer dtype and go out
int32. The flip is folded into the column indices of the resample: a
flipped crop gathers its columns in reverse, which is the same arithmetic
on each pixel as flipping the crop afterwards.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda.crop_counts import crop_counts

Params = Dict[str, torch.Tensor]

MAX_TRIALS = 10                 # RandomCrop's cat_max_ratio re-tries
BRIGHTNESS_DELTA = 32.0         # mmseg PhotoMetricDistortion defaults
CONTRAST_RANGE = (0.5, 1.5)
SATURATION_RANGE = (0.5, 1.5)
HUE_DELTA = 18.0


# --------------------------------------------------------------------- #
# the draw step (host, explicit generator)
# --------------------------------------------------------------------- #
def draw_augment_params(generator: torch.Generator, batch_size: int,
                        ratio_range: Tuple[float, float] = (0.5, 2.0),
                        flip_prob: float = 0.5,
                        max_trials: int = MAX_TRIALS) -> Params:
    """Every random number one batch's augmentation needs, as CPU tensors
    (one ``torch.rand`` call, so a seeded generator gives one stream):

    - ``scale`` [B]: the resize ratio, uniform in ``ratio_range`` (the base
      scale of ``Resize(img_scale)`` folded in by the caller);
    - ``trials`` [B, T, 2]: uniforms of the T candidate crop origins (y, x);
    - ``flip`` [B] bool: ``u < flip_prob``;
    - photometric: ``bright_on``, ``contrast_pre_on``, ``contrast_post_on``,
      ``contrast_first``, ``sat_on``, ``hue_on`` [B] bool coins
      (``u < 0.5``); ``bright`` [B] the brightness delta, ``alpha`` [B] the
      contrast factor (one serves both contrast positions), ``sat`` [B] the
      saturation factor, ``hue`` [B] the hue shift in degrees.
    """
    b, t = batch_size, max_trials
    u = torch.rand(b, 2 * t + 12, generator=generator, dtype=torch.float32)

    def span(col, lo, hi):
        return lo + (hi - lo) * u[:, col]

    coin = u[:, 2 * t + 2:2 * t + 8] < 0.5
    return {
        "scale": span(0, *ratio_range),
        "trials": u[:, 1:1 + 2 * t].reshape(b, t, 2).contiguous(),
        "flip": u[:, 2 * t + 1] < flip_prob,
        "bright_on": coin[:, 0], "contrast_pre_on": coin[:, 1],
        "contrast_post_on": coin[:, 2], "contrast_first": coin[:, 3],
        "sat_on": coin[:, 4], "hue_on": coin[:, 5],
        "bright": span(2 * t + 8, -BRIGHTNESS_DELTA, BRIGHTNESS_DELTA),
        "alpha": span(2 * t + 9, *CONTRAST_RANGE),
        "sat": span(2 * t + 10, *SATURATION_RANGE),
        "hue": span(2 * t + 11, -HUE_DELTA, HUE_DELTA),
    }


def params_to(params: Params, device, non_blocking: bool = False) -> Params:
    return {k: v.to(device, non_blocking=non_blocking)
            for k, v in params.items()}


# --------------------------------------------------------------------- #
# fused Resize + RandomCrop + Pad
# --------------------------------------------------------------------- #
def _windows(img_hw: Tuple[int, int], crop_size: Tuple[int, int],
             off_y: torch.Tensor, off_x: torch.Tensor, scale: torch.Tensor,
             flip: Optional[torch.Tensor] = None):
    """Sampling positions in original-image space of the crop windows at
    the origins ``off_y``, ``off_x`` [B, K] of images scaled by ``scale``
    [B]: the crop's rows, then its columns, along the last axis
    ([B, K, ch + cw]); an image whose ``flip`` is set takes its columns in
    reverse. Scaled-space pixel (i + offset) maps back to
    (i + offset + .5) / scale - .5 (float32, the JAX package's operations in
    its order). Returns (floor idx, ceil idx, frac, valid, nearest idx)."""
    (h, w), (ch, cw) = img_hw, crop_size
    j = torch.arange(ch + cw, dtype=torch.float32, device=scale.device)
    is_row = j < ch
    pos = torch.where(is_row, j, j - ch)
    if flip is not None:
        pos = torch.where(is_row | ~flip.to(torch.bool)[:, None], pos,
                          (cw - 1) - pos)[:, None]
    size = torch.where(is_row, float(h), float(w))
    off = torch.where(is_row, off_y.to(torch.float32)[..., None],
                      off_x.to(torch.float32)[..., None])
    s = scale.to(torch.float32)[:, None, None]
    scaled_pos = pos + off
    src = (scaled_pos + 0.5) / s - 0.5
    valid = scaled_pos < torch.clamp(size * s, min=1.0)
    lo = torch.minimum(torch.clamp(torch.floor(src), min=0.0), size - 1)
    hi = torch.minimum(lo + 1, size - 1)
    frac = torch.clamp(src - lo, 0.0, 1.0)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    return lo, hi, frac, valid, torch.where(frac < 0.5, lo, hi)


def _resample(img, label, rows, win, ch: int):
    """The unmasked crop of ``img[rows]`` / ``label[rows]`` at the windows
    ``win`` ([B, ch + cw] each): float32 NCHW image (the four taps gathered
    as stored, then converted), the nearest label and the valid mask."""
    lo, hi, frac, valid, near = win
    b = rows[:, None, None]
    r0, r1 = lo[:, None, :ch, None], hi[:, None, :ch, None]
    c0, c1 = lo[:, None, None, ch:], hi[:, None, None, ch:]

    def tap(r, c):      # [B, ch, cw, 3] as stored -> float32 [B, 3, ch, cw]
        return img[b, r[:, 0], c[:, 0]].permute(0, 3, 1, 2).to(
            torch.float32, memory_format=torch.contiguous_format)

    gy, gx = frac[:, None, :ch, None], frac[:, None, None, ch:]
    top = tap(r0, c0) * (1 - gx) + tap(r0, c1) * gx
    bot = tap(r1, c0) * (1 - gx) + tap(r1, c1) * gx
    crop = top * (1 - gy) + bot * gy
    lab = label[b, near[:, :ch, None], near[:, None, ch:]]
    return crop, lab, valid[:, :ch, None] & valid[:, None, ch:]


def _pick(win, k: torch.Tensor):
    """Candidate ``k`` [B] of each image's windows [B, K, ...]."""
    rows = torch.arange(k.shape[0], device=k.device)
    return tuple(t[rows, k] for t in win)


def fused_resize_crop(img: torch.Tensor, label: torch.Tensor,
                      scale: torch.Tensor, off_y: torch.Tensor,
                      off_x: torch.Tensor, crop_size: Tuple[int, int],
                      seg_pad_val: int = 255,
                      flip: Optional[torch.Tensor] = None):
    """Resample each image's crop window directly from the original.

    Equivalent to: bilinear-resize ``img[i]`` by ``scale[i]`` (no
    antialias, cv2 semantics), crop ``crop_size`` at (off_y, off_x) in
    scaled space, pad with 0 / ``seg_pad_val`` where the scaled image is
    smaller than the crop (and flip the crop where ``flip`` is set).
    ``img`` [B, H, W, 3], ``label`` [B, H, W]; returns (float32 crop
    [B, 3, ch, cw], int32 label [B, ch, cw], valid [B, ch, cw] bool)."""
    rows = torch.arange(img.shape[0], device=img.device)
    win = _windows(tuple(img.shape[1:3]), crop_size, off_y[:, None],
                   off_x[:, None], scale, flip)
    crop, lab, valid = _resample(img, label, rows,
                                 tuple(t[:, 0] for t in win), crop_size[0])
    crop = torch.where(valid[:, None], crop, 0.0)
    lab = torch.where(valid, lab.to(torch.int32), seg_pad_val)
    return crop, lab, valid


def crop_candidates(img_hw: Tuple[int, int], scale: torch.Tensor,
                    trials: torch.Tensor, crop_size: Tuple[int, int]):
    """The T candidate crop origins ([B, T] int64 each) of the scaled
    images: floor(u * (margin + 1)), margin = max(round(h * scale) - ch, 0)
    with round as floor(x + 0.5) in float32."""
    h, w = img_hw
    ch, cw = crop_size
    scale = scale.to(torch.float32)
    sh = torch.floor(h * scale + 0.5)
    sw = torch.floor(w * scale + 0.5)
    margin_y = torch.clamp(sh - ch, min=0.0)
    margin_x = torch.clamp(sw - cw, min=0.0)
    cand_y = torch.floor(trials[..., 0] * (margin_y[:, None] + 1.0))
    cand_x = torch.floor(trials[..., 1] * (margin_x[:, None] + 1.0))
    return cand_y.to(torch.int64), cand_x.to(torch.int64)


def _histograms(label, rows, win, ch: int, num_classes: int,
                seg_pad_val: int) -> torch.Tensor:
    """[B, K, C] int64 class histograms of the nearest-resampled label
    windows ``win`` [B, K, ch + cw] (``ops/cuda/crop_counts.py``)."""
    _, _, _, valid, near = win
    return crop_counts(label, rows, near, valid, ch, num_classes,
                       seg_pad_val)


def trial_histograms(label: torch.Tensor, rows: torch.Tensor,
                     scale: torch.Tensor, cand_y: torch.Tensor,
                     cand_x: torch.Tensor, crop_size: Tuple[int, int],
                     num_classes: int,
                     seg_pad_val: int = 255) -> torch.Tensor:
    """[B, T, C] int64 class histograms of the nearest-resampled crop window
    of every candidate origin. Pixels outside the scaled image,
    ``seg_pad_val`` and any label >= C are not counted (mmseg RandomCrop
    counts classes on the resampled crop)."""
    win = _windows(tuple(label.shape[1:3]), crop_size, cand_y, cand_x,
                   scale)
    return _histograms(label, rows, win, crop_size[0], num_classes,
                       seg_pad_val)


def _first_passing(counts: torch.Tensor, cat_max_ratio: float):
    """[B] index of the first candidate whose largest class holds less than
    ``cat_max_ratio`` of its counted pixels, else the last candidate."""
    total = torch.clamp(counts.sum(-1), min=1).to(torch.float32)
    ok = (counts.max(-1).values.to(torch.float32) / total) \
        < torch.tensor(cat_max_ratio, dtype=torch.float32)
    last = torch.full_like(total[:, 0], counts.shape[1] - 1,
                          dtype=torch.int64)
    return torch.where(ok.any(-1), ok.to(torch.uint8).argmax(-1), last)


def _crop(imgs, labels, rows, params, crop_size, cat_max_ratio,
          num_classes, seg_pad_val, flip=None):
    """Resize + RandomCrop (+ the flip), unmasked: the candidates' windows
    once, the histograms on them, then the chosen window's resample."""
    scale = params["scale"]
    cand_y, cand_x = crop_candidates(tuple(labels.shape[1:3]), scale,
                                     params["trials"], crop_size)
    if cat_max_ratio < 1.0:
        win = _windows(tuple(labels.shape[1:3]), crop_size, cand_y, cand_x,
                       scale, flip)
        counts = _histograms(labels, rows, win, crop_size[0], num_classes,
                             seg_pad_val)
        win = _pick(win, _first_passing(counts, cat_max_ratio))
    else:
        win = _windows(tuple(labels.shape[1:3]), crop_size, cand_y[:, :1],
                       cand_x[:, :1], scale, flip)
        win = tuple(t[:, 0] for t in win)
    return _resample(imgs, labels, rows, win, crop_size[0])


def choose_crop_origin(label: torch.Tensor, rows: torch.Tensor,
                       scale: torch.Tensor, trials: torch.Tensor,
                       crop_size: Tuple[int, int], cat_max_ratio: float,
                       num_classes: int, seg_pad_val: int = 255):
    """RandomCrop's origin (oy, ox) [B] of each image: with
    ``cat_max_ratio < 1`` the first candidate whose largest class holds
    less than that share of the counted crop pixels, else the last; with
    ``cat_max_ratio >= 1`` the first candidate."""
    cand_y, cand_x = crop_candidates(tuple(label.shape[1:3]), scale, trials,
                                     crop_size)
    if cat_max_ratio < 1.0:
        counts = trial_histograms(label, rows, scale, cand_y, cand_x,
                                  crop_size, num_classes, seg_pad_val)
        chosen = _first_passing(counts, cat_max_ratio)
    else:
        chosen = torch.zeros_like(cand_y[:, 0])
    pick = chosen[:, None]
    return cand_y.gather(1, pick)[:, 0], cand_x.gather(1, pick)[:, 0]


def random_scale_crop(img: torch.Tensor, label: torch.Tensor,
                      params: Params, crop_size: Tuple[int, int],
                      cat_max_ratio: float = 1.0, num_classes: int = 19,
                      seg_pad_val: int = 255):
    """mmseg Resize(ratio_range) + RandomCrop(cat_max_ratio) + Pad, fused,
    with the drawn ``params['scale']`` and ``params['trials']``. Returns
    what ``fused_resize_crop`` returns, at the chosen origin."""
    rows = torch.arange(img.shape[0], device=img.device)
    crop, lab, valid = _crop(img, label, rows, params, crop_size,
                             cat_max_ratio, num_classes, seg_pad_val)
    crop = torch.where(valid[:, None], crop, 0.0)
    lab = torch.where(valid, lab.to(torch.int32), seg_pad_val)
    return crop, lab, valid


# --------------------------------------------------------------------- #
# flip / photometric / normalize
# --------------------------------------------------------------------- #
def random_flip(img: torch.Tensor, label: torch.Tensor,
                flip: torch.Tensor):
    """Flip NCHW ``img`` and [B, H, W] ``label`` along the width where
    ``flip`` [B] is set."""
    f = flip.to(torch.bool)
    img = torch.where(f[:, None, None, None], img.flip(-1), img)
    label = torch.where(f[:, None, None], label.flip(-1), label)
    return img, label


def _rgb_to_hsv(x: torch.Tensor):
    """[B, 3, H, W] RGB in 0..1 -> h, s, v planes [B, H, W] (the JAX
    package's operations; max and min over the channels are exact)."""
    maxc = x.amax(1)
    minc = x.amin(1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-8), 0.0)
    safe = torch.clamp(delta, min=1e-8)
    rc, gc, bc = ((maxc[:, None] - x) / safe[:, None]).unbind(1)
    h = torch.where(maxc == x[:, 0], bc - gc,
                    torch.where(maxc == x[:, 1], 2.0 + rc - bc,
                                4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)       # floor-mod, as jnp's %
    h = torch.where(delta == 0, 0.0, h)
    return h, s, v


# which of (v, q, p, t) each of r, g, b takes in hue sextant 0..5
_SEXTANT = ((0, 3, 2), (1, 0, 2), (2, 0, 3), (2, 1, 0), (3, 2, 0), (0, 2, 1))


@functools.lru_cache(maxsize=None)
def _sextant_table(device: torch.device) -> torch.Tensor:
    return torch.tensor(_SEXTANT, dtype=torch.int64, device=device)


def _hsv_to_rgb(h, s, v) -> torch.Tensor:
    """h, s, v planes [B, H, W] -> [B, 3, H, W]: each channel picks its
    sextant's value of (v, q, p, t) by one gather (the JAX package's
    select chain, the same values)."""
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int64), 6)
    pick = _sextant_table(h.device)[i].permute(0, 3, 1, 2)
    return torch.stack((v, q, p, t), 1).gather(1, pick)


def photometric_distortion(img: torch.Tensor, params: Params) -> torch.Tensor:
    """mmseg PhotoMetricDistortion with the drawn coins and values:
    brightness, contrast (before or after saturation/hue, by
    ``contrast_first``), saturation, hue, each where its coin is set.
    NCHW in and out, 0..255 float32."""
    def col(key, dims=3):
        return params[key].to(img.device).reshape((-1,) + (1,) * dims)

    x = torch.where(col("bright_on"),
                    torch.clamp(img + col("bright"), 0, 255), img)
    alpha, first = col("alpha"), col("contrast_first")
    x = torch.where(first & col("contrast_pre_on"),
                    torch.clamp(x * alpha, 0, 255), x)
    h, s, v = _rgb_to_hsv(x / 255.0)
    s_mult = torch.where(col("sat_on", 2), col("sat", 2), 1.0)
    h_shift = torch.where(col("hue_on", 2), col("hue", 2) / 360.0, 0.0)
    s = torch.clamp(s * s_mult, 0, 1)
    h = torch.remainder(h + h_shift, 1.0)
    x = torch.clamp(_hsv_to_rgb(h, s, v) * 255.0, 0, 255)
    return torch.where(~first & col("contrast_post_on"),
                       torch.clamp(x * alpha, 0, 255), x)


def normalize(img: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """mmcv Normalize of an NCHW float image (per-channel mean and std; the
    records are RGB already, so ``to_rgb`` is the identity)."""
    mean = torch.as_tensor(mean, dtype=torch.float32,
                           device=img.device).reshape(1, -1, 1, 1)
    std = torch.as_tensor(std, dtype=torch.float32,
                          device=img.device).reshape(1, -1, 1, 1)
    return (img - mean) / std


# --------------------------------------------------------------------- #
# the full train-time augmentation, batched
# --------------------------------------------------------------------- #
def _augment(imgs, labels, rows, params, mean, std, crop_size,
             cat_max_ratio, num_classes, photometric, seg_pad_val, dtype):
    img, lab, valid = _crop(imgs, labels, rows, params, crop_size,
                            cat_max_ratio, num_classes, seg_pad_val,
                            params["flip"])
    if photometric:
        img = photometric_distortion(img, params)
    img = normalize(img, mean, std)
    # the padded region is 0 after Normalize (mmseg pads post-normalize)
    img = torch.where(valid[:, None], img, 0.0)
    return {"img": img.to(dtype).contiguous(),
            "gt": torch.where(valid, lab.to(torch.int32), seg_pad_val)}


def augment_batch(imgs: torch.Tensor, labels: torch.Tensor, params: Params,
                  mean: Sequence[float], std: Sequence[float],
                  crop_size: Tuple[int, int] = (512, 1024),
                  cat_max_ratio: float = 0.75, num_classes: int = 19,
                  photometric: bool = True, seg_pad_val: int = 255,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """The whole fused train pipeline over a batch: [B, H, W, 3] uint8 (or
    float32 0..255) images and [B, H, W] labels, with the drawn ``params``
    on the same device -> ``dtype`` [B, 3, ch, cw] images (bf16 as the
    model's input on the card; float32 where the model computes in
    float32) and int32 [B, ch, cw] labels."""
    rows = torch.arange(imgs.shape[0], device=imgs.device)
    return _augment(imgs, labels, rows, params, mean, std, tuple(crop_size),
                    cat_max_ratio, num_classes, photometric, seg_pad_val,
                    dtype)


def gather_augment_batch(cache_imgs: torch.Tensor, cache_gts: torch.Tensor,
                         idx: torch.Tensor, params: Params,
                         mean: Sequence[float], std: Sequence[float],
                         crop_size: Tuple[int, int] = (512, 1024),
                         cat_max_ratio: float = 0.75, num_classes: int = 19,
                         photometric: bool = True, seg_pad_val: int = 255,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Dict[str, torch.Tensor]:
    """``augment_batch`` of the records ``idx`` of a device-resident cache
    (``data/device_cache.py``), read in place: the resample's gathers index
    the cache's rows directly, so the batch is never copied out at full
    size."""
    idx = torch.as_tensor(idx, device=cache_imgs.device).to(torch.int64)
    return _augment(cache_imgs, cache_gts, idx, params, mean, std,
                    tuple(crop_size), cat_max_ratio, num_classes,
                    photometric, seg_pad_val, dtype)


# --------------------------------------------------------------------- #
# eval-time preparation
# --------------------------------------------------------------------- #
def triangle_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` float32 weights of ``jax.image.resize(...,
    'bilinear')`` along one axis: half-pixel centres, the triangle kernel
    widened by the inverse scale when shrinking (antialias), each column
    normalised to sum 1 (``jax/_src/image/scale.py`` ``compute_weight_mat``,
    in float32 as there)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear_antialias(x: torch.Tensor,
                              size: Tuple[int, int]) -> torch.Tensor:
    """NCHW float32 ``x`` resized as ``jax.image.resize(..., 'bilinear')``
    resizes (antialiased when shrinking), by separable weight matrices."""
    out = x
    if size[0] != x.shape[2]:
        wy = torch.from_numpy(triangle_matrix(x.shape[2], size[0])).to(x)
        out = torch.einsum("bchw,hy->bcyw", out, wy)
    if size[1] != x.shape[3]:
        wx = torch.from_numpy(triangle_matrix(x.shape[3], size[1])).to(x)
        out = torch.einsum("bchw,wx->bchx", out, wx)
    return out


def prepare_eval_batch(imgs: torch.Tensor, mean: Sequence[float],
                       std: Sequence[float],
                       size: Optional[Tuple[int, int]] = None,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Eval-time: [B, H, W, 3] images -> normalized (and optionally
    resized) ``dtype`` [B, 3, h, w]."""
    x = imgs.permute(0, 3, 1, 2).to(torch.float32)
    x = normalize(x, mean, std)
    if size is not None and tuple(x.shape[2:]) != tuple(size):
        x = resize_bilinear_antialias(x, tuple(size))
    return x.to(dtype).contiguous()


def gather_prepare_eval_batch(cache_imgs: torch.Tensor,
                              cache_gts: torch.Tensor, idx: torch.Tensor,
                              mean: Sequence[float], std: Sequence[float],
                              pad: int = 0,
                              size: Optional[Tuple[int, int]] = None,
                              dtype: torch.dtype = torch.bfloat16):
    """Row-gather + eval prep for a device-resident cache. The labels of the
    last ``pad`` records (a tail padded by wrapping) become 255."""
    idx = torch.as_tensor(idx, device=cache_imgs.device).to(torch.int64)
    img = prepare_eval_batch(cache_imgs[idx], mean, std, size=size,
                             dtype=dtype)
    gt = cache_gts[idx].to(torch.int32)
    if pad:
        gt[gt.shape[0] - int(pad):] = 255
    return img, gt
