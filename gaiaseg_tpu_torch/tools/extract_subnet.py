#!/usr/bin/env python
"""Cut standalone subnets out of a trained supernet (one GPU).

    python -m gaiaseg_tpu_torch.tools.extract_subnet CONFIG SUPERNET.pth \
        --work-dir WD [--sampler-key train_sampler] [--smoke-size 64 64]

A port of ``tools/extract_subnet.py``: loads the supernet ``.pth`` through
``init_segmentor``, traverses the config's ``--sampler-key`` sampler (every
``--num-shards``-th subnet from ``--shard-id`` on), and for each subnet
slices the supernet's state dict (``engine/extract.py``), builds the
subnet's model from its own config, loads the slices strictly, runs one
forward of a ``--smoke-size`` image (it must give finite logits) and writes
``WD/<md5(meta)[:8]>.pth`` with meta ``{"meta": nested meta, "model_cfg":
subnet config}``; ``init_segmentor`` on that config loads the file. Runs on
``cuda`` unless ``--device cpu`` is given; the device is resolved before
anything else.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..",
                                ".."))

logger = logging.getLogger("gaiaseg_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract subnets of a supernet "
                                            "(PyTorch/CUDA port)")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--sampler-key", default="train_sampler")
    p.add_argument("--shard-id", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--smoke-size", type=int, nargs=2, default=(64, 64))
    p.add_argument("--device", default="cuda")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value deep-merge overrides (dot keys; values "
                        "parsed as JSON where they parse)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns one ``{"name", "meta", "path", "mb", "seconds"}`` per subnet
    written."""
    args = parse_args(argv)
    import torch

    from gaiaseg_tpu_torch.archspace import build_model_sampler, unfold_dict
    from gaiaseg_tpu_torch.engine import (configure_numerics, extract_subnet,
                                          init_segmentor, save_checkpoint,
                                          subnet_ckpt_name)
    from gaiaseg_tpu_torch.engine.numerics import autocast
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          fill_img_size, model_max_arch)
    from gaiaseg_tpu_torch.tools.train_supernet import cfg_options_to_dict
    from gaiaseg_tpu_torch.utils import Config, resolve_device

    device = resolve_device(args.device)
    configure_numerics()
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(cfg_options_to_dict(args.cfg_options))
    fill_img_size(cfg)
    seg = init_segmentor(cfg, args.checkpoint, device=device)
    state = seg.model.state_dict()
    sampler = build_model_sampler(cfg[args.sampler_key])
    sampler.set_mode("traverse")
    os.makedirs(args.work_dir, exist_ok=True)
    metas = list(sampler.traverse())[args.shard_id::args.num_shards]
    logger.info("extracting %d subnets", len(metas))
    h, w = args.smoke_size
    img = torch.randn(1, 3, h, w, generator=torch.Generator().manual_seed(0)
                      ).to(device)
    written = []
    for meta in metas:
        nested = unfold_dict(meta)
        t0 = time.perf_counter()
        sub_cfg, sub_state, _ = extract_subnet(cfg["model"], state, meta)
        sub_cfg = json.loads(json.dumps(sub_cfg, default=repr))
        with torch.device("meta"):
            sub = build_segmentor(sub_cfg)
        sub.load_state_dict(sub_state, strict=True, assign=True)
        sub.eval()
        # smoke forward at the subnet's own shapes (reference
        # extract_subnet.py:125-130)
        with torch.no_grad(), autocast(device):
            logit = sub(img, encode_arch(model_max_arch(sub_cfg)))
        if not bool(torch.isfinite(logit).all()):
            raise RuntimeError(f"subnet {nested.get('name')}: non-finite "
                               "logits in the smoke forward")
        path = osp.join(args.work_dir, subnet_ckpt_name(nested))
        save_checkpoint(path, sub, meta={"meta": nested,
                                         "model_cfg": sub_cfg})
        seconds = time.perf_counter() - t0
        row = {"name": nested.get("name", "unnamed"), "meta": nested,
               "path": path, "mb": osp.getsize(path) / 1e6,
               "seconds": seconds}
        written.append(row)
        logger.info("saved subnet %s (%s, %.1f MB) in %.2fs", path,
                    row["name"], row["mb"], seconds)
        del sub, sub_state
    return written


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
