#!/usr/bin/env python3
"""A cell's full measurement on the card, one run after another: two sets
of runs on the same seeds (the bounds' spreads), then traced runs and
further runs on seeds of their own (the correctness check's dozen seeds).

    python3 benchmark/tests/measure.py --workload psp-sandwich-cached \
        --seeds 11 12 13 14 15 16 --traced 21 22 23 --extra 24 25 26 \
        --out OUT_DIR

Each run's result line goes to ``<out>/<set>.jsonl`` and its standard
error to ``<out>/<set>_<seed>.err``; the spreads of the two sets are
printed at the end (``spread.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def one(workload, seed, seconds, trace, out, name):
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", workload, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(int(trace))], cwd=ROOT,
        capture_output=True, text=True, timeout=1500, check=False)
    with open(os.path.join(out, f"{name}_{seed}.err"), "w") as f:
        f.write(res.stderr)
    line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    with open(os.path.join(out, f"{name}.jsonl"), "a") as f:
        f.write(line + "\n")
    d = json.loads(line) if line.startswith("{") else {}
    print(json.dumps({"set": name, "seed": seed, "rc": res.returncode,
                      "wall_s": time.perf_counter() - t0,
                      "correct": d.get("correct"),
                      "metrics": {k: v["value"] for k, v in
                                  d.get("metrics", {}).items()},
                      "checks": {k: v["value"] for k, v in
                                 d.get("checks", {}).items()}}),
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", nargs="*", type=int, default=[])
    p.add_argument("--traced", nargs="*", type=int, default=[])
    p.add_argument("--extra", nargs="*", type=int, default=[])
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    os.makedirs(args.out, exist_ok=True)
    for name in ("setA", "setB"):
        for seed in args.seeds:
            one(args.workload, seed, seconds, False, args.out, name)
    for seed in args.traced:
        one(args.workload, seed, seconds, True, args.out, "traced")
    for seed in args.extra:
        one(args.workload, seed, seconds, False, args.out, "extra")
    if args.seeds:
        subprocess.run([sys.executable, os.path.join(HERE, "spread.py"),
                        os.path.join(args.out, "setA.jsonl"),
                        os.path.join(args.out, "setB.jsonl")], check=False)


if __name__ == "__main__":
    main()
