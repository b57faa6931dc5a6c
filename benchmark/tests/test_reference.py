"""The plain reference against the port at a tiny size on the CPU (this
test may import both; the reference itself imports nothing of the port):
the same parameter names and shapes, the same features at several archs,
the same augmented batches, the same first train steps and the same
running statistics after the first full step."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.loops.common import program_config  # noqa: E402
from benchmark.lib.records import make_records  # noqa: E402
from benchmark.lib.weights import (load_seeded_weights,  # noqa: E402
                                   seeded_weights)
from benchmark.reference import nets, schedule  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402

CPU = torch.device("cpu")
TINY = {"psp": "benchmark/tests/tiny_psp.py",
        "vit": "benchmark/tests/tiny_vit.py"}


def _setup(name, seed=5):
    from gaiaseg_tpu_torch.models import build_segmentor
    cfg = program_config({"repo_configs": [TINY[name]], "overrides": {}})
    model = build_segmentor(cfg["model"])
    load_seeded_weights(model, seed)
    return cfg, cfg.to_dict()["model"], model


@pytest.mark.parametrize("name", sorted(TINY))
def test_parameter_layout_matches(name):
    _, model_cfg, model = _setup(name)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        dict(nets.param_specs(model_cfg))


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_train_mode_features_match(name, step):
    """The backbone's (and neck's) train-mode features at the sandwich's
    first archs (the heads' dropout is compared by the train steps)."""
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.dynamic_layers import frozen_bn_stats
    cfg, model_cfg, model = _setup(name)
    meta = schedule.sampler_metas(cfg["train_sampler"], 4)[step]
    hw = (128, 128) if name == "psp" else (64, 64)
    x = torch.randn((4, 3) + hw, generator=torch.Generator().manual_seed(1))
    model.train()
    with frozen_bn_stats(model), torch.no_grad():
        got = model.extract_feat(x, encode_arch(model_max_arch(model_cfg),
                                                meta))
    weights = seeded_weights(nets.param_specs(model_cfg), 5, CPU)
    arch = schedule.arch_of(schedule.max_arch(model_cfg), meta)
    with torch.no_grad():
        want = nets.features(nets.Numerics(), weights, x, arch, model_cfg,
                             True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        # float32 round-off, grown by batch norm over the tiny deepest maps
        assert (a - b).abs().max() <= 1e-3 * max(b.abs().max(), 1.0)


@pytest.mark.parametrize("name", sorted(TINY))
def test_first_train_steps_match(name):
    """The train loop's program readings against the reference's, at a
    tiny size (float32 on both sides: the gaps are round-off). The tiny
    PSP's batch norms over a few values a channel (its deepest maps are
    4x4, its coarsest pool 1x1 over 4 images) amplify round-off to about
    1e-3 in a leaf's gradient, and more over the next steps, so it is held
    over one step and looser."""
    import time
    from benchmark.loops import train
    traffic = {"kind": "train", "records": 12, "crop": None,
               "device_cache": False, "cycle": 4, "check_steps": 2,
               "warm_steps": 6, "profile_cycles": 1}
    limits = {"loss": 1e-5, "grad": 1e-5, "update": 1e-4, "bn_stats": 1e-4}
    if name == "psp":
        traffic.update(record_hw=[160, 192], crop=[128, 128], check_steps=1)
        limits.update(grad=1e-2, update=1e-2)
    else:
        traffic.update(record_hw=[64, 86], crop=[64, 64], zero_label=True)
    run = train.run({"repo_configs": [TINY[name]], "overrides": {}},
                    traffic, {"rate_metric": "train_img_per_s",
                              "limits": limits},
                    seed=2 ** 31 + 11, seconds=0.5, trace=False,
                    t_start=time.perf_counter(), device=CPU)
    assert run.correct, [(c.name, c.value) for c in run.checks]


def test_augmented_batches_match_the_feed():
    """The reference's batches bit for bit against the port's feed."""
    from gaiaseg_tpu_torch.data.pipeline_cfg import parse_train_pipeline
    from gaiaseg_tpu_torch.engine.train import make_train_feed
    from benchmark.lib.records import Records
    from benchmark.loops.train import reference_config
    cfg, model_cfg, _ = _setup("psp")
    imgs, gts = make_records(8, (160, 192), 5, 3, CPU)
    feed = make_train_feed(Records(imgs, gts, 5), parse_train_pipeline(
        cfg["data"]["train"]["pipeline"]), 4, 5, CPU, seed=21)
    got = [next(feed)[:2] for _ in range(3)]
    feed.close()
    plain = reference_config(cfg, model_cfg, {"crop": [128, 128]})
    want = ref_train.batches((imgs, gts), plain, 4, 21, 3, 5)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert torch.equal(gl.long(), wl)
        assert (gi - wi).abs().max() <= 1e-4
