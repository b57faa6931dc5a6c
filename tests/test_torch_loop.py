"""The port's train loop around the step, following JAX's
``tests/test_train_e2e.py`` on ``configs/tests/tiny_synthetic.py`` (batch 1,
32x32, CPU):
- the tiny end-to-end run: 12 iterations, losses logged per window, the
  cross-arch eval at MIN and MAX, ``iter_12.pth`` with its meta, and
  ``history.json`` equal to the returned history;
- the cadence: checkpoint files every interval and at the end, ``latest.pth``,
  ``val_loss`` rows of the two-phase workflow (``test_two_phase_workflow``),
  eval rows;
- silent steps: the running statistics change only at log boundaries;
- calibration before checkpoints and evals, none again when the checkpoint
  has just calibrated at least as many batches, none without silent steps;
  an eval-only calibration leaves the train statistics as they were;
- resume: a model resumed from the run's ``iter_4.pth`` holds the file's
  weights, statistics, momentum and iteration, and runs on at the unbroken
  run's LRs; ``auto_resume``; ``load_from`` takes the weights only;
- the CLI's ``--resume-from`` and ``--load-from``.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch.engine import train as ptrain
from gaiaseg_tpu_torch.models import build_segmentor
from gaiaseg_tpu_torch.tools import train_supernet
from gaiaseg_tpu_torch.utils import Config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")
TRAIN_STEP = ptrain.train_step
CALIBRATE = ptrain.calibrate_bn


def _cfg(**opts):
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict(opts)
    return cfg


def _model(cfg, seed=0):
    torch.manual_seed(seed)
    return build_segmentor(cfg["model"])


def _run(cfg, work_dir=None, seed=0, **kw):
    return ptrain.train_segmentor(_model(cfg), cfg, work_dir=work_dir,
                                  device="cpu", seed=seed, **kw)


def test_train_supernet_e2e(tmp_path):
    cfg = _cfg()
    state, history = _run(cfg, str(tmp_path))
    assert state.step == 12
    losses = [h["loss"] for h in history["loss"]]
    assert [h["iter"] for h in history["loss"]] == [4, 8, 12]
    assert all(np.isfinite(v) for v in losses)
    for row in history["loss"]:        # one full step a window
        assert row["loss"] == row["decode.loss_seg"]
        assert row["img_per_sec"] > 0 and row["step_ms"] > 0
    assert [e["iter"] for e in history["eval"]] == [12]
    metrics = history["eval"][-1]["metrics"]
    assert set(metrics) == {"MIN", "MAX"}
    assert all(0.0 <= m["mIoU"] <= 1.0 for m in metrics.values())
    raw = torch.load(str(tmp_path / "iter_12.pth"), map_location="cpu",
                     weights_only=False)
    assert raw["meta"]["iter"] == 12 and \
        raw["meta"]["CLASSES"] == [f"class_{i}" for i in range(5)]
    assert raw["meta"]["max_arch"] == \
        {"backbone": {"stem": {"width": 16},
                      "body": {"width": [8, 16, 24, 32],
                               "depth": [2, 2, 3, 2]}}}
    with open(tmp_path / "history.json") as f:
        on_disk = json.load(f)
    assert on_disk["loss"] == history["loss"]
    assert on_disk["val_loss"] == history["val_loss"] == []
    assert on_disk["eval"][0]["metrics"]["MAX"]["mIoU"] == \
        metrics["MAX"]["mIoU"]


def test_cadence_of_checkpoints_val_and_eval(tmp_path):
    cfg = _cfg(**{"workflow": [["train", 4], ["val", 1]],
                  "checkpoint_config.interval": 4,
                  "evaluation.interval": 8, "runner.max_iters": 10})
    state, history = _run(cfg, str(tmp_path))
    assert state.step == 10
    assert sorted(os.listdir(tmp_path)) == [
        "history.json", "iter_10.pth", "iter_4.pth", "iter_8.pth",
        "latest.pth"]
    assert os.path.realpath(tmp_path / "latest.pth") == \
        os.path.realpath(tmp_path / "iter_10.pth")
    assert [r["iter"] for r in history["val_loss"]] == [4, 8]
    assert all(np.isfinite(r["loss"]) for r in history["val_loss"])
    assert [r["iter"] for r in history["loss"]] == [4, 8]
    assert [r["iter"] for r in history["eval"]] == [8]


def test_two_phase_workflow(tmp_path):
    """workflow=[('train', N), ('val', M)] runs M val-loss batches every N
    train iterations (JAX tests/test_train_e2e.py)."""
    cfg = _cfg(workflow=[["train", 4], ["val", 2]],
               evaluation=dict(interval=1000),
               checkpoint_config=dict(interval=1000))
    _, history = _run(cfg, str(tmp_path), max_iters=8)
    assert len(history["val_loss"]) == 2, history["val_loss"]
    assert all(np.isfinite(h["loss"]) for h in history["val_loss"])


def _spy_steps(monkeypatch):
    """(update_stats, did the running statistics change) of every step."""
    seen = []

    def spy(model, optimizer, img, gt, *args, **kw):
        before = [b.clone() for _, b in model.named_buffers()]
        out = TRAIN_STEP(model, optimizer, img, gt, *args, **kw)
        changed = any(not torch.equal(a, b) for a, (_, b) in
                      zip(before, model.named_buffers()))
        seen.append((kw["update_stats"], changed))
        return out

    monkeypatch.setattr(ptrain, "train_step", spy)
    return seen


def test_silent_steps_leave_the_statistics_between_boundaries(monkeypatch):
    seen = _spy_steps(monkeypatch)
    _, history = _run(_cfg(), max_iters=8)
    full = [(i + 1) % 4 == 0 for i in range(8)]
    assert seen == list(zip(full, full))
    assert len(history["loss"]) == 2


def _spy_calibrations(monkeypatch):
    calls = []

    def spy(model, dataset, arch, **kw):
        calls.append(kw["num_batches"])
        return CALIBRATE(model, dataset, arch, **kw)

    monkeypatch.setattr(ptrain, "calibrate_bn", spy)
    return calls


@pytest.mark.parametrize("opts,want", [
    ({}, [8]),                                   # defaults: 8 and 8
    ({"log_config.interval": 1}, []),            # no silent steps
    ({"checkpoint_config.calibrate_bn": 2,
      "evaluation.calibrate_bn": 3}, [2, 3]),    # the eval wants more
    ({"checkpoint_config.calibrate_bn": 3,
      "evaluation.calibrate_bn": 2}, [3]),
], ids=["defaults", "log-1", "eval-more", "ckpt-more"])
def test_calibration_before_checkpoint_and_eval(tmp_path, monkeypatch, opts,
                                                want):
    calls = _spy_calibrations(monkeypatch)
    cfg = _cfg(**{"checkpoint_config.interval": 4,
                  "evaluation.interval": 4, **opts})
    state, _ = _run(cfg, str(tmp_path), max_iters=4)
    assert calls == want
    # the eval's own calibration does not stay in the model
    saved = torch.load(str(tmp_path / "iter_4.pth"), map_location="cpu",
                       weights_only=False)["state_dict"]
    for key, buf in state.model.named_buffers():
        assert torch.equal(buf, saved[key]), key


def _momentum(optimizer):
    return [s["momentum_buffer"] for s in
            optimizer.state_dict()["state"].values()]


def test_resume_continues_the_run(tmp_path):
    """The unbroken run's iter_4.pth is where a run of 4 would have
    stopped: resumed from it, a fresh model holds the file, then runs
    iterations 5-8 at the unbroken run's LRs."""
    cfg = _cfg(**{"log_config.interval": 1, "checkpoint_config.interval": 4,
                  "runner.max_iters": 8})
    unbroken = str(tmp_path / "a")
    _, whole = _run(cfg, unbroken)
    ckpt = os.path.join(unbroken, "iter_4.pth")
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    back, hist = _run(cfg, str(tmp_path / "b"), seed=0, resume_from=ckpt,
                      max_iters=4)
    assert back.step == 4 and hist["loss"] == []
    sd = back.model.state_dict()
    assert set(sd) == set(saved["state_dict"])
    assert all(torch.equal(sd[k], v) for k, v in saved["state_dict"].items())
    mom = _momentum(back.optimizer)
    want = [s["momentum_buffer"] for s in saved["optimizer"]["state"]
            .values()]
    assert len(mom) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(mom, want))
    state, rest = _run(cfg, str(tmp_path / "b"), resume_from=ckpt)
    assert state.step == 8
    assert [r["iter"] for r in rest["loss"]] == [5, 6, 7, 8]
    assert [r["lr"] for r in rest["loss"]] == \
        [r["lr"] for r in whole["loss"][4:]]
    assert all(np.isfinite(r["loss"]) for r in rest["loss"])


def test_auto_resume_and_load_from(tmp_path):
    cfg = _cfg(**{"checkpoint_config.interval": 4})
    first = str(tmp_path / "a")
    _run(cfg, first, max_iters=4)
    wd = str(tmp_path / "b")
    os.makedirs(wd)
    shutil.copy(os.path.join(first, "iter_4.pth"), wd)
    os.symlink("iter_4.pth", os.path.join(wd, "latest.pth"))
    cfg["auto_resume"] = True
    state, hist = _run(cfg, wd, max_iters=8)
    assert state.step == 8 and [r["iter"] for r in hist["loss"]] == [8]
    # load_from: the weights, a fresh optimizer, from iteration 0
    cfg["auto_resume"] = False
    saved = torch.load(os.path.join(first, "iter_4.pth"), map_location="cpu",
                       weights_only=False)["state_dict"]
    seen = []
    state, hist = _run(cfg, None, max_iters=1,
                       load_from=os.path.join(first, "iter_4.pth"),
                       log=seen.append)
    assert state.step == 1 and any("loaded weights" in s for s in seen)
    assert state.model.decode_head.conv_seg.weight.shape == \
        saved["decode_head.conv_seg.weight"].shape


def test_cli_resume_and_load_from(tmp_path):
    wd = str(tmp_path / "wd")
    base = [TINY, "--device", "cpu", "--work-dir", wd]
    first = train_supernet.main(base + ["--max-iters", "4"])
    assert [r["iter"] for r in first["loss"]] == [4]
    assert os.path.realpath(os.path.join(wd, "latest.pth")) == \
        os.path.realpath(os.path.join(wd, "iter_4.pth"))
    more = train_supernet.main(base + ["--max-iters", "8", "--resume-from",
                                       os.path.join(wd, "latest.pth")])
    assert [r["iter"] for r in more["loss"]] == [8]
    assert os.path.isfile(os.path.join(wd, "iter_8.pth"))
    fresh = train_supernet.main(
        [TINY, "--device", "cpu", "--work-dir", str(tmp_path / "w2"),
         "--max-iters", "4", "--load-from", os.path.join(wd, "iter_8.pth")])
    assert [r["iter"] for r in fresh["loss"]] == [4]
