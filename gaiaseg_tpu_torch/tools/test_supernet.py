#!/usr/bin/env python
"""Score the subnets of a model space on a trained supernet (one GPU).

    python -m gaiaseg_tpu_torch.tools.test_supernet CONFIG CKPT.pth \
        --model-space flops.json --work-dir WD [--bn-calibrate 8] [--vmap 8]

A port of ``tools/test_supernet.py``: loads the config and the ``.pth``
checkpoint, reads the model space (``--model-space``, else the config's
``model_space_path``), applies the config's ``model_sampling_rules``, and
scores each subnet's mIoU on ``data.val`` in the config's test mode (whole
or slide; ``--flip`` adds flip TTA, the test pipeline's ``img_ratios``
multi-scale TTA). ``--bn-calibrate N`` first re-estimates each subnet's BN
statistics from N batches of ``data.train`` (the checkpoint's statistics
come back for the next subnet). ``--vmap N`` scores N subnets per pass over
the val set (``evaluate_population``: each batch is read once and runs
through each of the N subnets, each on its own statistics).

Each scored subnet is appended to ``WD/test_supernet/metrics.jsonl`` as it
finishes, so a rerun skips the subnets already scored; the model space
annotated with ``metric.<--metric-tag>`` goes to
``WD/test_supernet/metrics.json``. Runs on ``cuda`` unless ``--device
cpu`` is given; the device is resolved before anything else.

Under a process group (``python -m torch.distributed.run`` or the JAX
flags, as ``train_supernet``) each rank sweeps its shard of the val set
and the confusion matrices are summed; rank 0 chooses the subnets, keeps
the sweep log and writes the files.
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

from gaiaseg_tpu_torch.tools.train_supernet import (  # noqa: E402
    add_distributed_args, setup_distributed)

logger = logging.getLogger("gaiaseg_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate the subnets of a model "
                                            "space (PyTorch/CUDA port)")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--model-space", default=None,
                   help="model space json (default cfg.model_space_path)")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--metric-tag", default="metric")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--flip", action="store_true")
    p.add_argument("--max-subnets", type=int, default=None)
    p.add_argument("--bn-calibrate", type=int, default=0, metavar="N",
                   help="re-estimate each subnet's BN statistics over N "
                        "train batches before its eval")
    p.add_argument("--vmap", type=int, default=0, metavar="N",
                   help="score N subnets per pass over the val set")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value deep-merge overrides (dot keys; values "
                        "parsed as JSON where they parse)")
    add_distributed_args(p)
    return p.parse_args(argv)


def main(argv=None):
    """Returns the annotated model-space rows written to metrics.json (on
    every rank)."""
    args = parse_args(argv)
    from gaiaseg_tpu_torch.parallel import shutdown_distributed
    from gaiaseg_tpu_torch.utils import resolve_device

    device = setup_distributed(args, resolve_device(args.device))
    try:
        return _sweep(args, device)
    finally:
        shutdown_distributed()


def _sweep(args, device):
    from gaiaseg_tpu_torch.archspace import ModelSpace, build_sample_rule
    from gaiaseg_tpu_torch.data import build_dataset, parse_test_pipeline
    from gaiaseg_tpu_torch.engine import (bn_stats, calibrate_bn,
                                          configure_numerics, evaluate,
                                          evaluate_population, init_segmentor,
                                          load_bn_stats)
    from gaiaseg_tpu_torch.parallel import broadcast_object, is_main_process
    from gaiaseg_tpu_torch.tools.train_supernet import cfg_options_to_dict
    from gaiaseg_tpu_torch.utils import Config, SweepLog

    main = is_main_process()
    configure_numerics()
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(cfg_options_to_dict(args.cfg_options))
    seg = init_segmentor(cfg, args.checkpoint, device=device)
    space_path = args.model_space or cfg.get("model_space_path")
    space = ModelSpace.load(space_path)
    if cfg.get("model_sampling_rules"):
        space = space.apply_rule(build_sample_rule(
            cfg["model_sampling_rules"]))
    metas = space.pack()
    if args.max_subnets:
        metas = metas[:args.max_subnets]
    logger.info("evaluating %d subnets from %s", len(metas), space_path)

    dataset = build_dataset(cfg["data"]["val"], device=device)
    test_pipe = parse_test_pipeline(cfg["data"]["val"].get("pipeline"))
    out_dir = osp.join(args.work_dir, "test_supernet")
    all_metas = list(metas)
    sweep = None
    if main:
        os.makedirs(out_dir, exist_ok=True)
        sweep = SweepLog(osp.join(out_dir, "metrics.jsonl"))
        metas = [m for m in metas if not sweep.done(m)]
        if len(all_metas) != len(metas):
            logger.info("restart: %d/%d subnets already scored, skipping",
                        len(all_metas) - len(metas), len(all_metas))
    all_metas, metas = broadcast_object((all_metas, metas))
    calib_ds = build_dataset(cfg["data"]["train"], device=device) \
        if args.bn_calibrate else None
    own = bn_stats(seg.model)
    eval_kw = dict(test_params=test_pipe, batch_size=args.batch_size,
                   flip=args.flip, device=device)

    def calibrated(arch):
        """The subnet's BN statistics: calibrated, or the checkpoint's."""
        if calib_ds is None:
            return own
        calibrate_bn(seg.model, calib_ds, arch, num_batches=args.bn_calibrate,
                     test_params=test_pipe, device=device)
        stats = bn_stats(seg.model)
        load_bn_stats(seg.model, own)
        return stats

    step = max(int(args.vmap), 1)
    try:
        for lo in range(0, len(metas), step):
            chunk = metas[lo:lo + step]
            archs = [seg.arch(m) for m in chunk]
            t0 = time.perf_counter()
            stats = [calibrated(a) for a in archs]
            if args.vmap > 1:
                results = evaluate_population(seg.model, dataset, archs,
                                              stats=stats, **eval_kw)
            else:
                load_bn_stats(seg.model, stats[0])
                results = [evaluate(seg.model, dataset, archs[0], **eval_kw)]
            dt = time.perf_counter() - t0
            if sweep is None:
                continue
            for m, r in zip(chunk, results):
                r.pop("confusion")
                sweep.record(m, r)
            logger.info("[%d/%d] %d subnet(s): mIoU %s (%.1fs, %.0f "
                        "subnets/hr)", len(sweep), len(all_metas), len(chunk),
                        " ".join(f"{r['mIoU']:.4f}" for r in results), dt,
                        3600.0 * len(chunk) / dt)
    finally:
        load_bn_stats(seg.model, own)
    rows = None
    if main:
        rows = sweep.annotated(all_metas, args.metric_tag)
        out = osp.join(out_dir, "metrics.json")
        with open(out, "w") as f:
            json.dump(rows, f, indent=1, default=float)
        logger.info("dumped annotated model space -> %s", out)
    return broadcast_object(rows)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
