"""Depthwise convs (``DynConv2d``'s depthwise route, under the range
``conv.depthwise``; ConvNeXt's blocks): the share of the profiled cycles'
busy device time spent in the depthwise convs' forward, input-gradient and
weight-gradient kernels, in %. The kernels are found by the names the
card's trace gives them: cuDNN's depthwise kernels (one channel a group),
``conv2d_c1_k1_*`` (forward), ``dgrad2d_c1_k1_*`` (input gradient) and
``wgrad2d_c1_k1_*`` (weight gradient, with its reduction). The bias add,
the bias gradient's sum and the weights' cast to bf16, which the range
launches too, run on generic kernels that other operations share, and are
not counted. Nothing is read where no such kernel ran."""
import re

NAMES = re.compile(r"\b(conv2d|dgrad2d|wgrad2d)_c1_k1_")


def read(r):
    span = r.get("span") if r.get("kind") == "train" else None
    if not span or span["busy_s"] <= 0:
        return None
    kernel_s = sum(s for name, s in span["kernel_s"].items()
                   if NAMES.search(name))
    if kernel_s <= 0:
        return None
    return 100.0 * kernel_s / span["busy_s"]
