#!/usr/bin/env python3
"""The readings the limits of a cell's correctness check are set from,
on the card and at the cell's own size, several seeds in one process.

    python3 benchmark/tests/readings.py --workload psp-sandwich-cached \
        --what program control half_batch --seeds 101 102 103

- ``program``: the cell's runs (a short window), each number compared
  with the float32 reference: the lower readings;
- ``control``: the reference computed with float8 operands (e4m3, a scale
  a tensor) in the program's place: the upper readings;
- ``half_batch``: the reference with each step's batch cut to its first
  half in the program's place, a planted fault;
- ``branch_wgrad``: the reference whose bottlenecks' 3x3 convs take their
  weight gradient from the first half of the batch, a planted fault
  confined to the backward pass (the statistics, a forward, not read);
- ``self``: the float32 reference run twice, its own spread from one run
  to the next;
- ``bf16``: the reference under bf16 autocast (the program's precision)
  against the float32 one, a witness of what bf16 alone moves;
- ``program_bf16``: the program against the bf16 reference.

Outside ``program``, ``bn_stats`` compares the full step's statistics
worked out from the seed's weights (the program's own, a log window on,
are not at hand).

One JSON line a (what, seed) goes to standard output.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def train_readings(config, traffic, workload, seed, what, device,
                   seconds=1.0):
    import torch
    from benchmark.loops import train
    from benchmark.loops.common import program_config
    from benchmark.lib.records import make_records
    from benchmark.lib.weights import seeded_weights
    from benchmark.reference import nets
    from benchmark.reference import train as ref_train
    if what in ("program", "program_bf16"):
        runs, stats = train.reference_run, train.reference_stats
        judge = ref_train.compare
        ref_train.compare = lambda p, r: judge(p, r, detail=True)
        if what == "program_bf16":      # the judge in the program's bf16
            train.reference_run = lambda *a, **k: runs(
                *a, **dict(k, precision="bf16"))
            train.reference_stats = lambda *a, **k: stats(
                *a, **dict(k, precision="bf16"))
        try:
            run = train.run(config, traffic, workload, seed, seconds, False,
                            time.perf_counter(), device)
        finally:
            train.reference_run, train.reference_stats = runs, stats
            ref_train.compare = judge
        return run.readings["gaps"]
    if what not in ("control", "half_batch", "branch_wgrad", "self",
                    "bf16"):
        raise ValueError(what)
    cfg = program_config(config)
    model_cfg = cfg.to_dict()["model"]
    classes = int(model_cfg["decode_head"]["num_classes"])
    records = make_records(int(traffic["records"]),
                           tuple(traffic["record_hw"]), classes, seed,
                           device, zero_label=traffic.get("zero_label",
                                                          False))
    scales = config.get("norm_scales")
    full = int((cfg.get("log_config") or {}).get("interval", 50)) - 1
    kw = dict(precision={"control": "fp8", "bf16": "bf16"}.get(
        what, "float32"), half_batch=what == "half_batch")
    ref = train.reference_run(cfg, model_cfg, traffic, records, seed, device,
                              scales=scales)
    other = train.reference_run(
        cfg, model_cfg, traffic, records, seed, device, scales=scales,
        fault="branch_wgrad" if what == "branch_wgrad" else None, **kw)
    weights = seeded_weights(nets.param_specs(model_cfg), seed, device,
                             scales)
    ref["stats_delta"] = train.reference_stats(
        cfg, model_cfg, traffic, records, seed, weights, full, device)
    other["stats_delta"] = ref["stats_delta"] if what == "branch_wgrad" \
        else train.reference_stats(cfg, model_cfg, traffic, records, seed,
                                   weights, full, device, **kw)
    torch.cuda.empty_cache()
    return ref_train.compare(other, ref, detail=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--what", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--norm-scale-std", nargs="*", type=float, default=None,
                   help="read at each of these stds of the configuration's "
                   "drawn norm scales in turn (0: those scales are 0)")
    p.add_argument("--out", default=None,
                   help="also write each reading's leaves here (JSON lines)")
    args = p.parse_args(argv)
    import torch
    from benchmark.lib import spec as bench_spec
    spec = bench_spec.load_spec()
    cell = bench_spec.cell(spec, args.workload)
    config = bench_spec.load_config(cell["config"])
    traffic = copy.deepcopy(bench_spec.load_traffic(cell["traffic"]))
    workload = bench_spec.load_workload(cell["name"])
    device = torch.device("cuda", 0)
    stds = args.norm_scale_std
    for std in stds if stds is not None else [None]:
        if std is not None:
            config = dict(config, norm_scales={
                k: std for k in config["norm_scales"]})
        for what in args.what:
            for seed in args.seeds:
                t0 = time.perf_counter()
                out = train_readings(config, traffic, workload, seed, what,
                                     device, args.seconds)
                leaves = out.pop("leaves", None)
                line = {"workload": args.workload, "what": what,
                        "seed": seed, "norm_scale_std": std,
                        "readings": out,
                        "seconds": time.perf_counter() - t0}
                print(json.dumps(line), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(dict(line, leaves=leaves)) + "\n")


if __name__ == "__main__":
    main()
