"""The NVIDIA H100's published peaks and the least time of the loss kernels.

Peaks of the SXM part (NVIDIA's data sheet, dense, at the 700 W limit):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them,
3.35 TB/s of HBM. A share of them is read with the card's power limit
beside it (the result line's ``device.power_limit``).

``resize_ce_bound_s`` is a frozen copy of ``chip_smoke.py`` ``_bound``:
each input read once and each output written once over the HBM rate, the
operations the valid pixels need over the float32 rate, the larger bound.
The loss kernels K1 (forward sums) and K2 (gradient at the mid rows) read
``mid = [N, h, C, W]`` float32 (the logits interpolated along the width)
and the ``[N, H, W]`` int32 labels; K1 writes 8 bytes, K2 writes ``mid``'s
gradient.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# operations per (valid pixel, class): K1 blends two taps (3), max (1),
# subtract + exp + add (3); K2 also p*scale, -onehot and the 2-row adjoint
# (2 FMA = 4 ops) -> 7 + 7. Per valid pixel: log, pick, two adds (4).
OPS_FWD_PER_CLASS, OPS_BWD_PER_CLASS, OPS_PER_PIXEL = 7, 14, 4


def resize_ce_bound_s(logit_shape, label_shape, n_valid: int,
                      fwd: bool) -> float:
    """Least seconds of one K1 (``fwd``) or K2 launch on logits of
    ``[N, C, h, w]`` and labels of ``[N, H, W]`` with ``n_valid`` pixels
    not ignored."""
    n, c, h, _ = (int(v) for v in logit_shape)
    big_w = int(label_shape[2])
    mid = n * h * c * big_w
    label = n * int(label_shape[1]) * big_w
    per_class = OPS_FWD_PER_CLASS if fwd else OPS_BWD_PER_CLASS
    ops = int(n_valid) * (per_class * c + OPS_PER_PIXEL)
    nbytes = mid * 4 + label * 4 + (8 if fwd else mid * 4)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)
