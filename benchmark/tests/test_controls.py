"""The controls of each cell's correctness check, on the card at the
cell's own size: the plain reference in float8 (e4m3 operands, e5m2
gradients) in the program's place, and the faults planted in the program
or in the reference put in its place, each fails one of the cell's
numbers on three seeds; so does, where the backbone has residual
branches, a fault confined to their 3x3 convs' weight gradient. Skips
without a CUDA card."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import spec as bench_spec  # noqa: E402

SPEC = bench_spec.load_spec()
SEEDS = (2 ** 31 + 101, 202, 303)
CASES = [(w["name"], what) for w in SPEC["workloads"]
         for what in ("control", "half_batch")] + \
    [(w["name"], "branch_wgrad") for w in SPEC["workloads"]
     if bench_spec.load_config(w["config"]).get("norm_scales")]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,what", CASES)
def test_control_fails_a_number(cell, what):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.tests import readings
    w = bench_spec.cell(SPEC, cell)
    config = bench_spec.load_config(w["config"])
    traffic = bench_spec.load_traffic(w["traffic"])
    workload = bench_spec.load_workload(cell)
    for seed in SEEDS:
        got = readings.train_readings(config, traffic, workload, seed, what,
                                      torch.device("cuda", 0))
        assert any(got[k] > v for k, v in workload["limits"].items()), got
