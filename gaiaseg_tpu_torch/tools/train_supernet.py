#!/usr/bin/env python
"""Supernet training CLI of the port (one GPU).

    python -m gaiaseg_tpu_torch.tools.train_supernet CONFIG --max-iters 8
    # go on from the last checkpoint of a run (weights, BN statistics,
    # optimizer, iteration)
    python -m gaiaseg_tpu_torch.tools.train_supernet CONFIG \
        --work-dir WD --resume-from WD/latest.pth
    # a packed file (gaiaseg_tpu_torch.tools.pack_dataset), kept on the card
    python -m gaiaseg_tpu_torch.tools.train_supernet CONFIG --cfg-options \
        data.train.type=PackedDataset data.train.path=train.gsegpack \
        data.train.device_cache=true

Loads the config (``_base_`` merging, ``--cfg-options`` dot-key overrides),
builds the segmentor and runs ``train_segmentor``, which writes its
checkpoints (``iter_{N}.pth``, ``latest.pth``) and ``history.json`` into
``--work-dir`` (default ``work_dirs/<config name>``). ``--resume-from``
restores a checkpoint's weights, BN statistics, optimizer state and
iteration; ``--load-from`` only its weights. The train data is the config's
``data.train``: a file dataset (Cityscapes, ADE20K, custom directories), a
``PackedDataset``, or ``SyntheticDataset``; ``device_cache`` stages it on
the card when it fits the budget. The config's train pipeline runs on the
card. Runs on ``cuda`` unless ``--device cpu`` is given; the device is
resolved before anything else, so a missing card fails first.
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
    p = argparse.ArgumentParser(description="Train a segmentation supernet "
                                            "(PyTorch/CUDA port)")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value deep-merge overrides (dot keys; values "
                        "parsed as JSON where they parse)")
    return p.parse_args(argv)


def cfg_options_to_dict(pairs):
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def main(argv=None):
    args = parse_args(argv)
    import torch

    from gaiaseg_tpu_torch.engine import configure_numerics, train_segmentor
    from gaiaseg_tpu_torch.models import build_segmentor
    from gaiaseg_tpu_torch.utils import Config, resolve_device

    device = resolve_device(args.device)
    configure_numerics()
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(cfg_options_to_dict(args.cfg_options))
    torch.backends.cudnn.benchmark = bool(cfg.get("cudnn_benchmark", False))
    torch.manual_seed(args.seed)
    work_dir = args.work_dir or osp.join(
        "work_dirs", osp.splitext(osp.basename(args.config))[0])
    model = build_segmentor(cfg["model"]).to(device)
    _, history = train_segmentor(
        model, cfg, work_dir=work_dir, device=device,
        max_iters=args.max_iters, seed=args.seed,
        resume_from=args.resume_from or cfg.get("resume_from"),
        load_from=args.load_from or cfg.get("load_from"), log=print)
    return history


if __name__ == "__main__":
    main()
