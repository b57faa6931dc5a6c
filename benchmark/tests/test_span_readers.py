"""The readers of the program's spans (``lib/spans.py``) on the CPU: each
loads by name and reads a number from a tiny train run's steady log rows,
and reads nothing where the last train loop left no steady row."""
from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import spec as bench_spec  # noqa: E402
from benchmark.tests.test_faults import LIMITS, PSP, TRAIN  # noqa: E402

SPEC = bench_spec.load_spec()
READERS = [m["name"] for m in SPEC["per_layer"]
           if m["source"] == "program_span" and m["name"] !=
           "data_wait_ms.train"]


def test_span_readers_read_the_steady_rows():
    from benchmark.loops import train
    assert len(READERS) == 12
    run = train.run(PSP, dict(TRAIN), LIMITS, seed=2 ** 31 + 21,
                    seconds=0.5, trace=False, t_start=time.perf_counter(),
                    device=torch.device("cpu"))
    for name in READERS:
        value = bench_spec.metric_reader(name).read(run.readings)
        assert isinstance(value, float) and value >= 0.0, name
    fwd = bench_spec.metric_reader("fwd_host_ms.train").read(run.readings)
    assert fwd > 0.0


def test_span_readers_read_nothing_without_a_steady_row():
    from gaiaseg_tpu_torch.engine import train_segmentor
    from gaiaseg_tpu_torch.models import build_segmentor
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "tests",
                                       "tiny_synthetic.py"))
    torch.manual_seed(0)
    # one log window: its row is the first, which no reader counts
    train_segmentor(build_segmentor(cfg["model"]), cfg, device="cpu",
                    max_iters=4)
    for name in READERS:
        assert bench_spec.metric_reader(name).read({"kind": "train"}) \
            is None, name
