"""mmseg's train pipeline, one image at a time, in float32.

Resize by the drawn ratio (bilinear, no antialias, half-pixel centres:
scaled pixel ``i`` reads source ``(i + .5) / s - .5``, clamped at the
edges), RandomCrop at the first of ``T`` drawn origins whose largest class
holds under ``cat_max_ratio`` of the crop's counted labels (else the
last), RandomFlip, PhotoMetricDistortion (brightness, contrast before or
after, saturation and hue through HSV), Normalize, and Pad to the crop
with 0 and the ignore label. Labels take the nearest source pixel.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

f32 = torch.float32


def _axis(n_out: int, offset, size: int, scale: torch.Tensor,
          flip: bool = False):
    """Source taps of one crop axis: (lo, hi, frac, valid, nearest)."""
    pos = torch.arange(n_out, dtype=f32)
    if flip:
        pos = (n_out - 1) - pos
    pos = pos + float(offset)
    src = (pos + 0.5) / scale - 0.5
    valid = pos < torch.clamp(size * scale, min=1.0)
    lo = torch.clamp(torch.floor(src), min=0.0).clamp(max=size - 1)
    hi = torch.clamp(lo + 1, max=size - 1)
    frac = torch.clamp(src - lo, 0.0, 1.0)
    near = torch.where(frac < 0.5, lo, hi).long()
    return lo.long(), hi.long(), frac, valid, near


def _origins(h: int, w: int, scale: torch.Tensor, trials: torch.Tensor,
             crop: Tuple[int, int]):
    sh = torch.floor(h * scale + 0.5)
    sw = torch.floor(w * scale + 0.5)
    my = torch.clamp(sh - crop[0], min=0.0)
    mx = torch.clamp(sw - crop[1], min=0.0)
    return [(int(torch.floor(u[0] * (my + 1.0))),
             int(torch.floor(u[1] * (mx + 1.0)))) for u in trials]


def _rgb_to_hsv(x: torch.Tensor):
    r, g, b = x
    maxc, minc = x.max(0).values, x.min(0).values
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-8), 0.0)
    d = torch.clamp(delta, min=1e-8)
    rc, gc, bc = (maxc - r) / d, (maxc - g) / d, (maxc - b) / d
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    return torch.where(delta == 0, 0.0, h), s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q)]
    out = torch.zeros((3,) + h.shape, dtype=f32)
    for k, (r, g, b) in enumerate(table):
        sel = i == k
        out[0] = torch.where(sel, r, out[0])
        out[1] = torch.where(sel, g, out[1])
        out[2] = torch.where(sel, b, out[2])
    return out


def photometric(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[3, H, W] on the 0..255 scale."""
    if p["bright_on"]:
        x = torch.clamp(x + p["bright"], 0, 255)
    if p["contrast_first"] and p["contrast_pre_on"]:
        x = torch.clamp(x * p["alpha"], 0, 255)
    h, s, v = _rgb_to_hsv(x / 255.0)
    if p["sat_on"]:
        s = s * p["sat"]
    s = torch.clamp(s, 0, 1)
    if p["hue_on"]:
        h = torch.remainder(h + p["hue"] / 360.0, 1.0)
    else:
        h = torch.remainder(h, 1.0)
    x = torch.clamp(_hsv_to_rgb(h, s, v) * 255.0, 0, 255)
    if not p["contrast_first"] and p["contrast_post_on"]:
        x = torch.clamp(x * p["alpha"], 0, 255)
    return x


def augment(img: torch.Tensor, gt: torch.Tensor, p: Dict[str, torch.Tensor],
            crop: Tuple[int, int], cat_max_ratio: float, num_classes: int,
            mean: Sequence[float], std: Sequence[float],
            photometric_on: bool = True):
    """``img`` [H, W, 3] uint8, ``gt`` [H, W] (255 ignored), one image's
    draws ``p`` -> (float32 [3, ch, cw], int64 [ch, cw])."""
    h, w = gt.shape
    ch, cw = crop
    scale = p["scale"].to(f32)
    origins = _origins(h, w, scale, p["trials"], crop)
    pick = origins[-1]
    if cat_max_ratio < 1.0:
        for oy, ox in origins:
            _, _, _, vr, nr = _axis(ch, oy, h, scale)
            _, _, _, vc, nc = _axis(cw, ox, w, scale)
            lab = gt[nr][:, nc].long()
            keep = vr[:, None] & vc[None, :] & (lab < num_classes)
            counts = torch.bincount(lab[keep], minlength=num_classes)
            total = max(int(counts.sum()), 1)
            if float(counts.max()) / total < cat_max_ratio:
                pick = (oy, ox)
                break
    else:
        pick = origins[0]
    flip = bool(p["flip"])
    r0, r1, fy, vr, nr = _axis(ch, pick[0], h, scale)
    c0, c1, fx, vc, nc = _axis(cw, pick[1], w, scale, flip)
    x = img.to(f32).permute(2, 0, 1)                       # [3, H, W]
    gx, gy = fx[None, None, :], fy[None, :, None]
    top = x[:, r0][:, :, c0] * (1 - gx) + x[:, r0][:, :, c1] * gx
    bot = x[:, r1][:, :, c0] * (1 - gx) + x[:, r1][:, :, c1] * gx
    out = top * (1 - gy) + bot * gy
    valid = vr[:, None] & vc[None, :]
    out = torch.where(valid[None], out, 0.0)
    if photometric_on:
        out = photometric(out, p)
    m = torch.tensor(mean, dtype=f32)[:, None, None]
    s = torch.tensor(std, dtype=f32)[:, None, None]
    out = torch.where(valid[None], (out - m) / s, 0.0)
    lab = torch.where(valid, gt[nr][:, nc].long(), 255)
    return out, lab


def base_scale(h: int, w: int, img_scale) -> float:
    """The factor mapping the records' size onto ``Resize(img_scale)``
    (mmcv (w, h)), keeping the ratio."""
    if not img_scale:
        return 1.0
    tw, th = img_scale
    return min(max(th, tw) / max(h, w), min(th, tw) / min(h, w))


def ratio_of(base: float, ratio_range) -> Tuple[float, float]:
    return (ratio_range[0] * base, ratio_range[1] * base)

