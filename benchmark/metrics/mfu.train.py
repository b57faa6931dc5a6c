"""The whole train step's share of the card's bf16 peak, in %: six times
the frozen MAC count (``lib/macs.py``) of every arch the timed window ran,
at its batch and crop, over the window's seconds (outside the profiled
span), over 989 TFLOP/s."""
from benchmark.lib.peaks import PEAK_BF16_FLOPS


def read(r):
    if r.get("kind") != "train" or not r.get("window_flops"):
        return None
    return 100.0 * r["window_flops"] / r["window_s"] / PEAK_BF16_FLOPS
