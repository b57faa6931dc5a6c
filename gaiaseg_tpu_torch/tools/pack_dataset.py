#!/usr/bin/env python
"""Convert a config-declared dataset into the packed native format.

    python -m gaiaseg_tpu_torch.tools.pack_dataset CONFIG OUT.gsegpack \
        [--split train] [--size H W]

Writes the records of ``data.<split>`` (Cityscapes, ADE20K or any custom
directory dataset) into one fixed-shape ``.gsegpack`` file, read by
``PackedDataset`` (``data.train=dict(type='PackedDataset', path=...)``).
The format is the JAX package's, byte for byte.
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys

if __package__ in (None, ""):
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..",
                                ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description="Pack a dataset (.gsegpack)")
    p.add_argument("config")
    p.add_argument("out", help="output .gsegpack path")
    p.add_argument("--split", default="train", choices=["train", "val",
                                                        "test"])
    p.add_argument("--size", type=int, nargs=2, default=None,
                   help="H W (default: the first record's shape)")
    args = p.parse_args(argv)

    from gaiaseg_tpu_torch.data import build_dataset, pack_dataset
    from gaiaseg_tpu_torch.utils import Config

    cfg = Config.fromfile(args.config)
    split = dict(cfg["data"][args.split])
    split.pop("device_cache", None)
    ds = build_dataset(split)
    if len(ds) == 0:
        raise SystemExit(f"no records under {split.get('data_root')}")
    out = pack_dataset(ds, args.out,
                       size=tuple(args.size) if args.size else None)
    print(f"packed {len(ds)} records -> {out}")
    return out


if __name__ == "__main__":
    main()
