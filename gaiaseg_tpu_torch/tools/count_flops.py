#!/usr/bin/env python
"""FLOPs sweep over a sampler's model space (no device needed).

    python -m gaiaseg_tpu_torch.tools.count_flops CONFIG --work-dir WD \
        [--shard-id 0 --num-shards 16] [--only-backbone]

A port of ``tools/count_flops.py``: traverses the config's sampler
(``--sampler-key``, default ``train_sampler``), takes every
``--num-shards``-th subnet from ``--shard-id`` on, and writes each one's
nested meta with ``data.input_shape`` and ``overhead.flops`` /
``overhead.params`` as one JSON line of ``WD/flops.json.<shard-id>``. Shard
0 then merges the shard files it finds into ``WD/flops.json``. The counts
are analytic (``archspace/complexity.py``): no model is built and no tensor
runs, so the tool takes no ``--device``. The input shape is the meta's
``data.input_shape`` (an int ``s`` is ``(3, s, 2s)``), else
``--input-shape``, else the config's ``data_cfg.input_shape``, else
``(3, 512, 2048)``. Logs the number of subnets and the subnets a second.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..",
                                ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Analytic FLOPs sweep of a "
                                            "model space (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--input-shape", type=int, nargs=3, default=None,
                   help="C H W (default 3 512 2048 or data_cfg.input_shape)")
    p.add_argument("--only-backbone", action="store_true")
    p.add_argument("--shard-id", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--sampler-key", default="train_sampler")
    return p.parse_args(argv)


def main(argv=None, log=print):
    """Returns ``(subnets in this shard, seconds)``."""
    args = parse_args(argv)
    from gaiaseg_tpu_torch.archspace import (build_model_sampler,
                                             get_model_complexity_info,
                                             unfold_dict)
    from gaiaseg_tpu_torch.models.arch_util import (canonical_arch,
                                                    model_max_arch)
    from gaiaseg_tpu_torch.utils import Config

    cfg = Config.fromfile(args.config)
    default_shape = tuple(args.input_shape) if args.input_shape else tuple(
        (cfg.get("data_cfg") or {}).get("input_shape", (3, 512, 2048)))
    sampler = build_model_sampler(cfg[args.sampler_key])
    sampler.set_mode("traverse")
    max_arch = model_max_arch(cfg["model"])

    os.makedirs(args.work_dir, exist_ok=True)
    shard_path = osp.join(args.work_dir, f"flops.json.{args.shard_id}")
    t0 = time.perf_counter()
    n = 0
    with open(shard_path, "w") as f:
        for i, meta in enumerate(sampler.traverse()):
            if i % args.num_shards != args.shard_id:
                continue
            nested = unfold_dict(meta)
            arch = canonical_arch(max_arch, meta)
            shape = nested.get("data", {}).get("input_shape", default_shape)
            if isinstance(shape, int):
                shape = (3, shape, shape * 2)
            info = get_model_complexity_info(
                cfg["model"], arch, tuple(shape),
                only_backbone_flops=args.only_backbone)
            row = dict(nested)
            row.setdefault("data", {})["input_shape"] = list(shape)
            row["overhead"] = {"flops": info["flops"],
                               "params": info["params"]}
            f.write(json.dumps(row, default=float) + "\n")
            n += 1
    seconds = time.perf_counter() - t0
    log(f"shard {args.shard_id}: {n} subnets in {seconds:.2f}s "
        f"({n / max(seconds, 1e-9):.0f} subnets/s) -> {shard_path}")

    if args.shard_id == 0:
        rows = []
        for s in range(args.num_shards):
            p = osp.join(args.work_dir, f"flops.json.{s}")
            if osp.exists(p):
                with open(p) as f:
                    rows += [json.loads(line) for line in f if line.strip()]
        merged = osp.join(args.work_dir, "flops.json")
        with open(merged, "w") as f:
            json.dump(rows, f, indent=1, default=float)
        log(f"merged {len(rows)} subnets -> {merged}")
    return n, seconds


if __name__ == "__main__":
    main()
