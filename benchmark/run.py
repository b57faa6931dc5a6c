#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``gaiaseg_tpu_torch`` on the card.

    python3 benchmark/run.py --workload psp-sandwich-cached --seed 7 \
        --seconds 30 --trace 0

The cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``benchmark/configs/<config>.json``) under a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``kind`` names the loop in
``benchmark/loops/<kind>.py`` that runs it, with the cell's own limits and
rate metric (``benchmark/workloads/<cell>.json``). ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py`` from what the traced run recorded. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and ``checks`` last: every number compared with the plain reference beside
its limit); the checks are also the last lines of standard error.

The run fails, printing no result, without a CUDA card (or with fewer than
the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout: only the
# first run of a checkout builds
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import spec as bench_spec  # noqa: E402
from benchmark.lib.device import require_cards  # noqa: E402
from benchmark.lib.result import emit, forbidden_modules  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = bench_spec.load_spec()
    cell = bench_spec.cell(spec, args.workload)
    require_cards(int(cell["chips"]))
    config = bench_spec.load_config(cell["config"])
    traffic = bench_spec.load_traffic(cell["traffic"])
    loop = bench_spec.loop(traffic["kind"])
    run = loop.run(config=config, traffic=traffic,
                   workload=bench_spec.load_workload(cell["name"]),
                   seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   t_start=T_START)
    found = forbidden_modules(sys.modules)
    if found:
        print("the run loaded " + ", ".join(found) + ": the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        return 4
    if args.trace:
        metrics = bench_spec.per_layer_metrics(spec, cell["name"],
                                               run.readings)
    else:
        metrics = bench_spec.end_to_end_metrics(spec, cell["name"], run.e2e)
    emit(run, metrics, trace=bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
