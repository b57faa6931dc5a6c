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
from benchmark.tests import cases  # noqa: E402

CPU = torch.device("cpu")
FAMILIES = cases.names()


def _setup(name, seed=5):
    from gaiaseg_tpu_torch.models import build_segmentor
    cfg = program_config({"repo_configs": [cases.load(name)["tiny"]],
                          "overrides": {}})
    model = build_segmentor(cfg["model"])
    load_seeded_weights(model, seed)
    return cfg, cfg.to_dict()["model"], model


@pytest.mark.parametrize("name", FAMILIES)
def test_parameter_layout_matches(name):
    _, model_cfg, model = _setup(name)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        dict(nets.param_specs(model_cfg))


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_train_mode_features_match(name, step):
    """The backbone's (and neck's) train-mode features at the sandwich's
    first archs (the heads' dropout is compared by the train steps)."""
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.dynamic_layers import frozen_bn_stats
    cfg, model_cfg, model = _setup(name)
    meta = schedule.sampler_metas(cfg["train_sampler"], 4)[step]
    hw = tuple(cases.load(name)["feature_hw"])
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


@pytest.mark.parametrize("name", FAMILIES)
def test_first_train_steps_match(name):
    """The train loop's program readings against the reference's, at a
    tiny size, float32 on both sides, within the family's limits (each
    with its reason in its case file)."""
    import time
    from benchmark.loops import train
    case = cases.load(name)
    run = train.run({"repo_configs": [case["tiny"]], "overrides": {}},
                    dict(case["train_step"]["traffic"]),
                    {"rate_metric": "train_img_per_s",
                     "limits": cases.limits(case)},
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
