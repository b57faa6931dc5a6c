"""Loss kernels K1/K2 (``ops/cuda/resize_ce.py``, ``csrc/resize_ce.cu``):
the least time of every loss launch in the profiled cycles (its bound from
the logits' and labels' shapes and valid pixels, ``lib/peaks.py``) over the
device time of the kernels named below, in %. Nothing is read where the
loss ran no such kernel."""
import re

from benchmark.lib.peaks import resize_ce_bound_s

FWD = re.compile(r"fwd_tile")
BWD = re.compile(r"bwd_tile")


def read(r):
    span = r.get("span") if r.get("kind") == "train" else None
    launches = r.get("ce_launches") or []
    if not span or not launches:
        return None
    kernel_s = sum(s for name, s in span["kernel_s"].items()
                   if FWD.search(name) or BWD.search(name))
    if kernel_s <= 0:
        return None
    bound = sum(resize_ce_bound_s(x["logit"], x["label"], x["n_valid"], fwd)
                for x in launches for fwd in (True, False))
    return 100.0 * bound / kernel_s
