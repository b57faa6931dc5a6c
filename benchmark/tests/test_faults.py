"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (the loop, the program, the reference, the comparison) on the CPU at
a tiny size, with one fault planted in the program: a step that returns
its state unchanged, half of the batch left out (the mean taken over the
rest), an answer altered where it is produced, a full step that leaves
the running statistics alone or takes them from half of the batch. A
sound run of the same size passes the same limits."""
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
TRAIN = CASE["train_step"]["traffic"]
LIMITS = {"rate_metric": "train_img_per_s",
          "limits": {"loss": 1e-5, "grad": 1e-2, "update": 1e-2,
                     "bn_stats": 1e-3}}


def _train_run():
    from benchmark.loops import train
    return train.run(PSP, dict(TRAIN), LIMITS, seed=2 ** 31 + 11,
                     seconds=0.5, trace=False, t_start=time.perf_counter(),
                     device=CPU)


def _failed(run):
    assert not run.correct
    return {c.name for c in run.checks if not c.ok}


def test_train_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, *a, **k: None)
    assert "update" in _failed(_train_run())


def test_train_step_on_half_the_batch(monkeypatch):
    from gaiaseg_tpu_torch.models.segmentors.encoder_decoder import \
        DynamicEncoderDecoder
    real = DynamicEncoderDecoder.forward_train

    def half(self, img, gt, arch, generator=None, compute_acc=False):
        n = img.shape[0] // 2
        return real(self, img[:n], gt[:n], arch, generator, compute_acc)
    monkeypatch.setattr(DynamicEncoderDecoder, "forward_train", half)
    assert _failed(_train_run())


def test_train_loss_altered_where_it_is_produced(monkeypatch):
    from gaiaseg_tpu_torch.models.decode_heads.base import BaseDecodeHead
    real = BaseDecodeHead.cls_seg

    def shifted(self, feat, generator=None):
        out = real(self, feat, generator)
        return out + torch.linspace(0, 0.5, out.shape[1]).view(1, -1, 1, 1)
    monkeypatch.setattr(BaseDecodeHead, "cls_seg", shifted)
    assert _failed(_train_run())


def test_full_step_that_leaves_the_statistics_unchanged(monkeypatch):
    import gaiaseg_tpu_torch.engine.train as engine_train
    real = engine_train.train_step

    def silent(*a, **k):
        return real(*a, **dict(k, update_stats=False))
    monkeypatch.setattr(engine_train, "train_step", silent)
    assert "bn_stats" in _failed(_train_run())


def test_full_step_statistics_of_half_the_batch(monkeypatch):
    from gaiaseg_tpu_torch.ops.dynamic_layers import DynBatchNorm
    real = DynBatchNorm.forward

    def half(self, x):
        if not (self.training and self.update_stats):
            return real(self, x)
        with torch.no_grad():     # the running statistics from rows :n
            real(self, x[:len(x) // 2])
        self.update_stats = False
        try:
            return real(self, x)
        finally:
            self.update_stats = True
    monkeypatch.setattr(DynBatchNorm, "forward", half)
    assert "bn_stats" in _failed(_train_run())


def test_sound_run_passes_the_same_limits():
    run = _train_run()
    assert run.correct, [(c.name, c.value) for c in run.checks]
