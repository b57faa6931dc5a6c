#!/usr/bin/env python
"""Per-channel pixel mean and std of a config's dataset split.

    python -m gaiaseg_tpu_torch.tools.mean_std CONFIG [--split train] \
        [--max-images 500] [--device cuda]

A port of ``tools/mean_std.py`` (the reference's, without its fixed
paths): the first ``--max-images`` records of ``data[--split]``, read raw
(no pipeline), their pixels' sum and sum of squares per channel in float64
on ``--device``; prints ``mean=[...] std=[...] (N images)`` with the
population std ``sqrt(E[x^2] - E[x]^2)``. Runs on ``cuda`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys

if __package__ in (None, ""):
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..",
                                ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Dataset pixel mean/std "
                                            "(PyTorch/CUDA port)")
    p.add_argument("config")
    p.add_argument("--split", default="train")
    p.add_argument("--max-images", type=int, default=500)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns ``(mean, std, images)``, the first two lists of 3 floats."""
    args = parse_args(argv)
    import torch

    from gaiaseg_tpu_torch.data import build_dataset
    from gaiaseg_tpu_torch.utils import Config
    from gaiaseg_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    ds = build_dataset(cfg["data"][args.split], device=device)
    n = min(len(ds), args.max_images)
    s = torch.zeros(3, dtype=torch.float64, device=device)
    s2 = torch.zeros(3, dtype=torch.float64, device=device)
    count = 0
    for i in range(n):
        img = torch.tensor(ds[i]["img"], dtype=torch.float64, device=device)
        s += img.sum((0, 1))
        s2 += img.square().sum((0, 1))
        count += img.shape[0] * img.shape[1]
    mean = s / count
    std = torch.sqrt(s2 / count - mean ** 2)
    mean, std = mean.tolist(), std.tolist()
    print(f"mean={mean} std={std} ({n} images)")
    return mean, std, n


if __name__ == "__main__":
    main()
