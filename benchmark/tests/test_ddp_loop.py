"""``loops/ddp.py`` on the CPU: 2 gloo ranks at the tiny PSP config, each
at half the configuration's batch, come out correct against the plain
reference at the global batch; faults planted in every rank (each step on
half of the rank's batch; the gradients left unreduced across the ranks)
come out not correct; a rank that fails, or that loaded a forbidden
module, ends the run, and no rank outlives it."""
from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.tests import cases  # noqa: E402

CPU = torch.device("cpu")
CASE = cases.load("psp")
PSP = {"repo_configs": [CASE["tiny"]], "overrides": {}}
TRAFFIC = dict(CASE["train_step"]["traffic"], kind="ddp", ranks=2,
               samples_per_gpu=2)
LIMITS = {"rate_metric": "train_img_per_s", "limits": cases.limits(CASE)}

HALF_BATCH = '''
import sys
from gaiaseg_tpu_torch.models.segmentors.encoder_decoder import \\
    DynamicEncoderDecoder
real = DynamicEncoderDecoder.forward_train


def half(self, img, gt, arch, generator=None, compute_acc=False):
    n = img.shape[0] // 2
    return real(self, img[:n], gt[:n], arch, generator, compute_acc)


DynamicEncoderDecoder.forward_train = half
from benchmark.loops import ddp
ddp.rank_main(sys.argv[1])
'''

NO_ALLREDUCE = '''
import importlib
import sys
engine_train = importlib.import_module("gaiaseg_tpu_torch.engine.train")
engine_train.all_reduce_grads = lambda params: 0
from benchmark.loops import ddp
ddp.rank_main(sys.argv[1])
'''

RANK_1_LOADS_JAX = '''
import os
import sys
import types
from benchmark.loops import ddp
train_rank = ddp._train_rank


def train_then_load(job, device):
    out = train_rank(job, device)
    if os.environ["RANK"] == "1":   # a stand-in: the name is what counts
        sys.modules["jax"] = types.ModuleType("jax")
    return out


ddp._train_rank = train_then_load
ddp.rank_main(sys.argv[1])
'''

RANK_1_FAILS = '''
import os
import sys
if os.environ["RANK"] == "1":
    sys.exit(5)
from benchmark.loops import ddp
ddp.rank_main(sys.argv[1])
'''


def _run(entry=None):
    from benchmark.loops import ddp
    return ddp.run(PSP, dict(TRAFFIC), LIMITS, seed=2 ** 31 + 11,
                   seconds=0.5, trace=False, t_start=time.perf_counter(),
                   device=CPU, entry=entry)


def _entry(tmp_path, src):
    path = tmp_path / "entry.py"
    path.write_text(src)
    return str(path)


def test_two_ranks_match_the_reference_at_the_global_batch():
    run = _run()
    assert run.correct, [(c.name, c.value) for c in run.checks]
    assert run.e2e["train_img_per_s"] > 0 and run.attempted > 0


def test_half_the_batch_on_every_rank_is_not_correct(tmp_path):
    run = _run(_entry(tmp_path, HALF_BATCH))
    assert not run.correct
    assert "loss" in {c.name for c in run.checks if not c.ok}


def test_gradients_left_unreduced_are_not_correct(tmp_path):
    run = _run(_entry(tmp_path, NO_ALLREDUCE))
    assert not run.correct
    assert "grad" in {c.name for c in run.checks if not c.ok}


def _children():
    """The processes this one started that are still there."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z":
            out.append(int(pid))
    return out


def test_a_failed_rank_ends_the_run(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited with code 5"):
        _run(_entry(tmp_path, RANK_1_FAILS))
    assert time.monotonic() - t0 < 120
    assert _children() == []


def test_ranks_must_add_up_to_the_global_batch():
    from benchmark.loops import ddp
    with pytest.raises(ValueError, match="global batch"):
        ddp.run(PSP, dict(TRAFFIC, samples_per_gpu=3), LIMITS, seed=1,
                seconds=0.5, trace=False, t_start=time.perf_counter(),
                device=CPU)


def test_a_rank_that_loaded_jax_ends_the_run(tmp_path):
    from benchmark.loops import ddp
    with pytest.raises(RuntimeError, match=f"rank 1 exited with code "
                       f"{ddp.FORBIDDEN_EXIT}"):
        _run(_entry(tmp_path, RANK_1_LOADS_JAX))
    assert _children() == []
