#!/usr/bin/env python
"""Segment one image and write its palette overlay (headless).

    python -m gaiaseg_tpu_torch.tools.image_demo CONFIG CHECKPOINT IMAGE \
        [--out demo_out.png] [--opacity 0.5] [--arch JSON] [--device cuda]

A port of ``tools/image_demo.py`` on the port's inference API: the
config's segmentor with the checkpoint's weights (``init_segmentor``), one
RGB image through its test pipeline's normalization and ``test_cfg`` mode
at the arch of ``--arch`` (a flat dot-keyed meta, MAX when absent;
``inference_segmentor``), and ``show_result``'s overlay in the
checkpoint's palette (Cityscapes' when it has none). Runs on ``cuda``
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

if __package__ in (None, ""):
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..",
                                ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Single-image segmentation demo "
                                            "(PyTorch/CUDA port)")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("image")
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--opacity", type=float, default=0.5)
    p.add_argument("--arch", default=None,
                   help="JSON flat arch meta, e.g. "
                        '\'{"arch.backbone.body.depth": [3,4,6,3]}\'')
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the overlay ``[H, W, 3]`` uint8 it wrote to ``--out``."""
    args = parse_args(argv)
    import numpy as np
    from PIL import Image

    from gaiaseg_tpu_torch.engine import (inference_segmentor, init_segmentor,
                                          show_result)

    seg = init_segmentor(args.config, args.checkpoint, device=args.device)
    meta = json.loads(args.arch) if args.arch else None
    with Image.open(args.image) as im:
        img = np.asarray(im.convert("RGB"), np.uint8)
    pred = inference_segmentor(seg, img, meta)
    blend = show_result(img, pred, seg.PALETTE, args.opacity, args.out)
    print(f"saved overlay -> {args.out}")
    return blend


if __name__ == "__main__":
    main()
