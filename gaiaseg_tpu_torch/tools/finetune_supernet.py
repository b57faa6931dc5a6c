#!/usr/bin/env python
"""Fast-finetune the selected subnets of a supernet (one GPU).

    python -m gaiaseg_tpu_torch.tools.finetune_supernet CONFIG SUPERNET.pth \
        --model-space flops.json --work-dir WD [--max-iters N]

A port of ``tools/finetune_supernet.py``: reads the model space
(``--model-space``, else the config's ``model_space_path``), applies the
config's ``model_sampling_rules``, and for each subnet runs
``train_segmentor`` with the subnet as the one anchor of its sampler, the
config's schedule (``--max-iters`` overrides its length), the supernet's
weights as ``load_from`` and no cross-arch eval; checkpoints and
``history.json`` go to ``WD/subnet_<i>``. Then ``evaluate`` scores the
subnet on ``data.val`` in the config's test mode.

Each subnet starts from a model built afresh on the device and loaded from
the checkpoint: ``load_from`` loads with ``strict=False``, so a module kept
from the subnet before would keep that subnet's values wherever the file
had no entry (the JAX loop's state is rebuilt per call). Each result is
appended to ``WD/fastft_metrics.jsonl`` as it finishes, so a rerun skips
the subnets already done; the model space annotated with
``metric.<--metric-tag>`` goes to ``WD/fastft_metrics.json``. Runs on
``cuda`` unless ``--device cpu`` is given; the device is resolved before
anything else.
"""
from __future__ import annotations

import argparse
import json
import logging
import os.path as osp
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..",
                                ".."))

logger = logging.getLogger("gaiaseg_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Fast-finetune the subnets of a "
                                            "model space (PyTorch/CUDA port)")
    p.add_argument("config")
    p.add_argument("checkpoint", help="supernet checkpoint to finetune from")
    p.add_argument("--model-space", default=None,
                   help="model space json (default cfg.model_space_path)")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--metric-tag", default="fastft_metric")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value deep-merge overrides (dot keys; values "
                        "parsed as JSON where they parse)")
    return p.parse_args(argv)


def main(argv=None, log=None):
    """Returns the annotated model-space rows written to
    ``fastft_metrics.json``. ``log`` (default: the logger) takes the
    progress lines, the train loop's included."""
    args = parse_args(argv)
    say = log or logger.info
    import torch

    from gaiaseg_tpu_torch.archspace import (ModelSpace, build_model_sampler,
                                             build_sample_rule, fold_dict)
    from gaiaseg_tpu_torch.data import build_dataset, parse_test_pipeline
    from gaiaseg_tpu_torch.engine import (configure_numerics, evaluate,
                                          train_segmentor)
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          fill_img_size, model_max_arch)
    from gaiaseg_tpu_torch.tools.train_supernet import cfg_options_to_dict
    from gaiaseg_tpu_torch.utils import Config, SweepLog, resolve_device

    device = resolve_device(args.device)
    configure_numerics()
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(cfg_options_to_dict(args.cfg_options))
    fill_img_size(cfg)
    space_path = args.model_space or cfg.get("model_space_path")
    space = ModelSpace.load(space_path)
    if cfg.get("model_sampling_rules"):
        space = space.apply_rule(build_sample_rule(
            cfg["model_sampling_rules"]))
    metas = space.pack()
    say(f"fast-finetuning {len(metas)} subnets from {space_path}")

    max_arch = model_max_arch(cfg["model"])
    val_dataset = build_dataset(cfg["data"]["val"], device=device)
    test_pipe = parse_test_pipeline(cfg["data"]["val"].get("pipeline"))
    # restartable: a crash at subnet 40 of 50 keeps the first 39
    # (reference finetune_supernet.py:358 barriers per subnet)
    sweep = SweepLog(osp.join(args.work_dir, "fastft_metrics.jsonl"))
    for i, meta in enumerate(metas):
        if sweep.done(meta):
            say(f"[{i + 1}/{len(metas)}] already finetuned in a prior run, "
                "skip")
            continue
        flat = fold_dict(meta)
        flat.setdefault("name", f"subnet_{i}")
        anchor = build_model_sampler(dict(type="anchor", anchors=[flat]))
        torch.manual_seed(0)
        model = build_segmentor(cfg["model"]).to(device)
        t0 = time.perf_counter()
        state, _ = train_segmentor(
            model, cfg, work_dir=osp.join(args.work_dir, f"subnet_{i}"),
            device=device, val_dataset=val_dataset, train_sampler=anchor,
            val_sampler=None, max_iters=args.max_iters, seed=0,
            load_from=args.checkpoint, log=say)
        t1 = time.perf_counter()
        metrics = evaluate(state.model, val_dataset,
                           encode_arch(max_arch, meta), test_params=test_pipe,
                           batch_size=args.batch_size, device=device)
        metrics.pop("confusion")
        t2 = time.perf_counter()
        sweep.record(meta, metrics)
        say(f"[{i + 1}/{len(metas)}] {flat['name']} mIoU="
            f"{metrics['mIoU']:.4f} (train {t1 - t0:.4f}s, eval "
            f"{t2 - t1:.4f}s)")
        del model, state

    rows = sweep.annotated(metas, args.metric_tag)
    out = osp.join(args.work_dir, "fastft_metrics.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1, default=float)
    say(f"dumped annotated model space -> {out}")
    return rows


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
