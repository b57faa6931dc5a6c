"""The ConvNeXt part of the reference (``reference/parts/
dynamic_convnext.py``) against the port's ``DynamicConvNeXt`` at the tiny
size on the CPU, beyond the cases every family runs
(``test_reference.py``): with the layer scales drawn as the cell draws them
(at the rule's 0 every branch is silent), with stochastic depth drawn from
a generator in the port's order and dtype, and with the planted fault
confined to the depthwise convs' weight gradient."""
from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib.records import make_records  # noqa: E402
from benchmark.lib.weights import (load_seeded_weights,  # noqa: E402
                                   seeded_weights)
from benchmark.loops.common import program_config  # noqa: E402
from benchmark.reference import nets, parts, schedule  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.tests import cases  # noqa: E402

CPU = torch.device("cpu")
CASE = cases.load("convnext")
SCALES = {"backbone.stages.*.gamma": 0.05}
PART = parts.get("DynamicConvNeXt", "backbone")


def _setup(overrides=None, scales=SCALES, seed=5):
    from gaiaseg_tpu_torch.models import build_segmentor
    cfg = program_config({"repo_configs": [CASE["tiny"]],
                          "overrides": overrides or {}})
    model = build_segmentor(cfg["model"])
    load_seeded_weights(model, seed, scales)
    model_cfg = cfg.to_dict()["model"]
    weights = seeded_weights(nets.param_specs(model_cfg), seed, CPU, scales)
    return cfg, model_cfg, model, weights


def _archs(cfg, model_cfg, n=4):
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    for meta in schedule.sampler_metas(cfg["train_sampler"], n):
        yield (encode_arch(model_max_arch(model_cfg), meta),
               schedule.arch_of(schedule.max_arch(model_cfg), meta))


def _close(got, want, rtol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= rtol * max(float(b.abs().max()), 1.0)


def test_layer_scales_are_drawn_and_the_features_match():
    cfg, model_cfg, model, weights = _setup()
    gamma = weights["backbone.stages.2.1.gamma"]
    assert 0 < float(gamma.abs().mean()) < 0.1
    x = torch.randn((4, 3, 64, 64), generator=torch.Generator()
                    .manual_seed(1))
    for port_arch, arch in _archs(cfg, model_cfg):
        with torch.no_grad():
            got = model.train().extract_feat(x, port_arch)
            want = nets.features(nets.Numerics(), weights, x, arch,
                                 model_cfg, True)
        _close(got, want)


def test_drop_path_follows_the_ports_draws():
    """At rate 0.4 the backbone in training and the part, each given a
    generator seeded alike, drop the same samples' branches and leave the
    generators in the same state."""
    cfg, model_cfg, model, weights = _setup(
        {"model.backbone.drop_path_rate": 0.4})
    x = torch.randn((4, 3, 64, 64), generator=torch.Generator()
                    .manual_seed(2))
    model.train()
    for port_arch, arch in _archs(cfg, model_cfg):
        gp, gr = (torch.Generator().manual_seed(9) for _ in range(2))
        with torch.no_grad():
            got = model.backbone(x, port_arch["backbone"], gp)
            want = PART.forward(nets.Numerics(), weights, x,
                                arch["backbone"], model_cfg["backbone"],
                                True, gen=gr)
            plain = PART.forward(nets.Numerics(), weights, x,
                                 arch["backbone"], model_cfg["backbone"],
                                 False)
        _close(got, want)
        assert torch.equal(gp.get_state(), gr.get_state())
        assert (got[-1] - plain[-1]).abs().max() > 1e-3


def test_a_rate_above_0_in_training_needs_the_generator():
    cfg, model_cfg, _, weights = _setup(
        {"model.backbone.drop_path_rate": 0.4})
    _, arch = next(_archs(cfg, model_cfg, 1))
    x = torch.randn(2, 3, 64, 64)
    with pytest.raises(ValueError, match="generator"):
        nets.features(nets.Numerics(), weights, x, arch, model_cfg, True)
    assert len(nets.features(nets.Numerics(), weights, x, arch, model_cfg,
                             False)) == 4


def test_first_train_steps_match_with_drawn_layer_scales():
    from benchmark.loops import train
    run = train.run({"repo_configs": [CASE["tiny"]], "overrides": {},
                     "norm_scales": SCALES},
                    dict(CASE["train_step"]["traffic"]),
                    {"rate_metric": "train_img_per_s",
                     "limits": cases.limits(CASE)},
                    seed=2 ** 31 + 13, seconds=0.5, trace=False,
                    t_start=time.perf_counter(), device=CPU)
    assert run.correct, [(c.name, c.value) for c in run.checks]


def test_first_train_steps_and_full_step_match_with_drop_path():
    """At the published rate 0.4 the reference's train steps draw the
    stochastic depth from their own generator, and its full step from one
    replayed over the steps before it: the first steps and the running
    statistics of the full step match the program's within the float32
    limits."""
    from benchmark.loops import train
    run = train.run({"repo_configs": [CASE["tiny"]], "norm_scales": SCALES,
                     "overrides": {"model.backbone.drop_path_rate": 0.4}},
                    dict(CASE["train_step"]["traffic"]),
                    {"rate_metric": "train_img_per_s",
                     "limits": cases.limits(CASE)},
                    seed=2 ** 31 + 17, seconds=0.5, trace=False,
                    t_start=time.perf_counter(), device=CPU)
    assert run.correct, [(c.name, c.value) for c in run.checks]


def test_the_full_step_replays_the_draws_before_it(monkeypatch):
    """The full step's stochastic depth draws from the generator state the
    reference's train steps had reached at that step."""
    from benchmark.loops.train import reference_config
    cfg, model_cfg, _, weights = _setup({"model.backbone.drop_path_rate":
                                         0.4})
    plain = reference_config(cfg, model_cfg, CASE["train_step"]["traffic"])
    records = make_records(12, (64, 86), 7, 5, CPU, zero_label=True)
    seen = []
    draw = PART._drop_path

    def recording(nm, y, rate, gen):
        seen.append(gen.get_state())
        return draw(nm, y, rate, gen)
    monkeypatch.setattr(PART, "_drop_path", recording)
    ref_train.follow(plain, weights, records, 5, 3, CPU, nets.Numerics())
    in_steps = list(seen)
    seen.clear()
    ref_train.full_step_stats(plain, weights, records, 5, 2, CPU,
                              nets.Numerics())
    assert 0 < len(seen) < len(in_steps)
    assert all(torch.equal(a, b)
               for a, b in zip(seen, in_steps[-len(seen):]))
    assert not torch.equal(seen[0], in_steps[0])


def test_branch_fault_moves_only_the_depthwise_weight_gradients():
    cfg, model_cfg, _, weights = _setup()
    from benchmark.loops.train import reference_config
    traffic = CASE["train_step"]["traffic"]
    plain = reference_config(cfg, model_cfg, traffic)
    records = make_records(12, tuple(traffic["record_hw"]), 7, 5, CPU,
                           zero_label=True)
    sound, fault = (ref_train.follow(plain, weights, records, 5, 1, CPU,
                                     nets.Numerics(fault=f))
                    for f in (None, "branch_wgrad"))
    moved = {n for n, v in sound["grad_norms"].items()
             if abs(fault["grad_norms"][n] - v) > 1e-6 * max(v, 1e-12)}
    dw = {n for n in sound["grad_norms"] if n.endswith("dwconv.weight")}
    assert moved and moved <= dw
    assert sound["losses"] == fault["losses"]
