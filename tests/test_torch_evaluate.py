"""The port's evaluation, inference API and test_supernet CLI.

On the same weights, float32, with integer-exact inputs (records constant
on 2x2 blocks of integer pixels, Normalize mean 128 and std 64: JAX's bf16
eval batch and its 0.5 rescale equal the port's float32 ones):
- ``evaluate`` in whole and slide mode, with flip and with ratios
  (0.5, 1.0): the confusion matrix of JAX's ``make_eval_step`` over the
  same records; at batch 2 over 5 records (a padded tail) the metrics of
  JAX's ``evaluate``;
- ``cross_arch_evaluate``: JAX's anchors and metrics;
- ``evaluate_population``: JAX's ``evaluate_population`` metrics and the
  port's sequential ``evaluate`` confusion matrices, also with each arch on
  its own BN statistics (the model's come back);
- ``init_segmentor`` / ``inference_segmentor`` / ``show_result`` on a saved
  checkpoint, ``apis`` names;
- the copies of ``ModelSpace``, the rules and ``SweepLog`` give the JAX
  package's rows;
- ``tools/test_supernet.py`` end to end on the CPU, ``--vmap`` equal to the
  sequential sweep, and a rerun that skips the subnets already scored.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.archspace import ModelSpace as JModelSpace
from gaiaseg_tpu.archspace import build_model_sampler as j_build_sampler
from gaiaseg_tpu.archspace import build_sample_rule as j_build_rule
from gaiaseg_tpu.data import transforms as J
from gaiaseg_tpu.data.pipeline_cfg import \
    TestPipelineParams as JTestPipelineParams
from gaiaseg_tpu.engine.evaluate import cross_arch_evaluate as \
    j_cross_arch_evaluate
from gaiaseg_tpu.engine.evaluate import evaluate as j_evaluate
from gaiaseg_tpu.engine.evaluate import evaluate_population as \
    j_evaluate_population
from gaiaseg_tpu.engine.evaluate import make_eval_step
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.utils.config import Config as JConfig
from gaiaseg_tpu.utils.sweep import SweepLog as JSweepLog
from gaiaseg_tpu_torch import apis
from gaiaseg_tpu_torch.archspace import (ModelSpace, build_model_sampler,
                                         build_sample_rule)
from gaiaseg_tpu_torch.data import SyntheticDataset
from gaiaseg_tpu_torch.data import TestPipelineParams as EvalParams
from gaiaseg_tpu_torch.engine import (bn_stats, calibrate_bn,
                                      cross_arch_evaluate, evaluate,
                                      evaluate_population,
                                      inference_segmentor, init_segmentor,
                                      load_bn_stats, save_checkpoint,
                                      show_result)
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.tools import test_supernet
from gaiaseg_tpu_torch.utils import Config, SweepLog

from test_torch_segmentor import METAS, model_cfg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")
EXACT = dict(mean=(128.0, 128.0, 128.0), std=(64.0, 64.0, 64.0))
SLIDE = dict(mode="slide", crop_size=(24, 32), stride=(16, 20))
METRICS = ("mIoU", "mAcc", "aAcc")


class BlockDataset:
    """Records of 32x48 integer pixels constant on 2x2 blocks, 7-class
    labels with about a tenth ignored."""
    CLASSES = tuple(f"c{i}" for i in range(7))
    PALETTE = None

    def __init__(self, length=3, seed=0):
        self.length, self.seed = length, seed

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 1000 + i)
        small = rng.randint(0, 256, (16, 24, 3)).astype(np.uint8)
        img = np.repeat(np.repeat(small, 2, 0), 2, 1)
        gt = rng.randint(0, 7, (32, 48)).astype(np.int32)
        gt[rng.rand(32, 48) < 0.1] = 255
        return {"img": img, "gt": gt, "idx": i}


@pytest.fixture(scope="module")
def weights():
    cfg = model_cfg(True)
    model = j_build_segmentor(cfg)
    k = jax.random.PRNGKey(1)
    variables = jax.jit(lambda a: model.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 48, 3)),
        jnp.zeros((1, 32, 48), jnp.int32), a, compute_acc=False,
        method="forward_train"))(j_encode_arch(j_model_max_arch(cfg)))
    return jax.tree_util.tree_map(np.asarray, variables)


def models(variables, test_cfg=None):
    jcfg, cfg = model_cfg(True), model_cfg(False)
    if test_cfg is not None:
        jcfg["test_cfg"] = cfg["test_cfg"] = dict(test_cfg)
    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(variables, cfg))
    return j_build_segmentor(jcfg), model


def archs(meta=None):
    return (j_encode_arch(j_model_max_arch(model_cfg(True)), meta),
            encode_arch(model_max_arch(model_cfg(False)), meta))


def jax_confusion(jmodel, variables, ds, jarch, flip, ratios):
    step = make_eval_step(jmodel, 7, flip, ratios)
    mean, std = jnp.asarray(EXACT["mean"]), jnp.asarray(EXACT["std"])
    cm = np.zeros((7, 7), np.int64)
    for i in range(len(ds)):
        rec = ds[i]
        img = J.prepare_eval_batch(jnp.asarray(rec["img"][None]), mean, std)
        cm += np.asarray(step(variables, img, jnp.asarray(rec["gt"][None]),
                              jarch))
    return cm


@pytest.mark.parametrize("test_cfg,flip,ratios", [
    (None, False, None), (None, True, None), (None, False, (0.5, 1.0)),
    (SLIDE, True, (0.5, 1.0))],
    ids=["whole", "whole-flip", "whole-ms", "slide-flip-ms"])
def test_evaluate_matches_jax_confusion(weights, test_cfg, flip, ratios):
    jmodel, model = models(weights, test_cfg)
    ds = BlockDataset()
    jarch, arch = archs(METAS["random"])
    want = jax_confusion(jmodel, weights, ds, jarch, flip, ratios)
    res = evaluate(model, ds, arch, flip=flip, device="cpu",
                   test_params=EvalParams(**EXACT, img_ratios=ratios))
    np.testing.assert_array_equal(res["confusion"], want)
    assert res["confusion"].sum() == sum((ds[i]["gt"] != 255).sum()
                                         for i in range(len(ds)))
    assert model.training       # evaluate puts the model's mode back


def test_evaluate_padded_tail_matches_jax_evaluate(weights):
    jmodel, model = models(weights)
    ds = BlockDataset(length=5, seed=2)
    jarch, arch = archs(METAS["min"])
    want = j_evaluate(jmodel, weights, ds, jarch, batch_size=2,
                      test_params=JTestPipelineParams(**EXACT))
    got = evaluate(model, ds, arch, batch_size=2, device="cpu",
                   test_params=EvalParams(**EXACT))
    assert {k: got[k] for k in want} == want
    once = evaluate(model, ds, arch, batch_size=2, max_batches=1,
                    device="cpu", test_params=EvalParams(**EXACT))
    assert once["confusion"].sum() == sum(
        (ds[i]["gt"] != 255).sum() for i in range(2))


ANCHORS = [{"name": "MIN", **METAS["min"]}, {"name": "MAX"}]


def test_cross_arch_evaluate_matches_jax(weights):
    jmodel, model = models(weights)
    ds = BlockDataset()
    sampler_cfg = dict(type="anchor", anchors=ANCHORS)
    want = j_cross_arch_evaluate(
        jmodel, weights, j_build_sampler(sampler_cfg), ds,
        j_model_max_arch(model_cfg(True)),
        test_params=JTestPipelineParams(**EXACT))
    got = cross_arch_evaluate(model, build_model_sampler(sampler_cfg), ds,
                              model_max_arch(model_cfg(False)),
                              test_params=EvalParams(**EXACT),
                              device="cpu")
    assert list(got) == list(want) == ["MIN", "MAX"]
    for name in want:
        assert {k: got[name][k] for k in want[name]} == want[name]
        assert got[name]["seconds"] > 0


POPULATION = [METAS["max"], METAS["min"], METAS["random"]]


def test_evaluate_population_matches_jax_and_sequential(weights):
    jmodel, model = models(weights)
    ds = BlockDataset(length=3, seed=4)
    tp = EvalParams(**EXACT)
    want = j_evaluate_population(
        jmodel, weights, ds, [archs(m)[0] for m in POPULATION],
        batch_size=2, test_params=JTestPipelineParams(**EXACT))
    got = evaluate_population(model, ds, [archs(m)[1] for m in POPULATION],
                              batch_size=2, test_params=tp, device="cpu")
    assert len(got) == len(want) == 3
    for g, w, meta in zip(got, want, POPULATION):
        assert {k: g[k] for k in w} == w
        seq = evaluate(model, ds, archs(meta)[1], batch_size=2,
                       test_params=tp, device="cpu")
        np.testing.assert_array_equal(g["confusion"], seq["confusion"])


def test_evaluate_population_on_each_archs_statistics(weights):
    _, model = models(weights)
    ds = BlockDataset(length=3, seed=5)
    calib = SyntheticDataset(length=4, size=(32, 48), num_classes=7, seed=3)
    tp = EvalParams(**EXACT)
    own = bn_stats(model)
    pop_archs = [archs(m)[1] for m in POPULATION]
    stats = []
    for arch in pop_archs:
        calibrate_bn(model, calib, arch, num_batches=2, test_params=tp)
        stats.append(bn_stats(model))
        load_bn_stats(model, own)
    got = evaluate_population(model, ds, pop_archs, flip=True,
                              test_params=tp, stats=stats, device="cpu")
    for name, (mean, var) in bn_stats(model).items():   # ours came back
        assert torch.equal(mean, own[name][0])
        assert torch.equal(var, own[name][1])
    for g, arch, st in zip(got, pop_archs, stats):
        load_bn_stats(model, st)
        seq = evaluate(model, ds, arch, flip=True, test_params=tp,
                       device="cpu")
        np.testing.assert_array_equal(g["confusion"], seq["confusion"])
    with pytest.raises(ValueError, match="statistics"):
        evaluate_population(model, ds, pop_archs, stats=stats[:1],
                            device="cpu")


def _tiny_checkpoint(path, seed=0):
    cfg = Config.fromfile(TINY)
    torch.manual_seed(seed)
    model = build_segmentor(cfg["model"])
    save_checkpoint(path, model, meta={
        "iter": 1, "CLASSES": ["a", "b", "c", "d", "e"],
        "PALETTE": [[40 * i, 0, 0] for i in range(5)],
        "max_arch": model_max_arch(cfg["model"])})
    return cfg, model


def test_inference_api_on_a_checkpoint(tmp_path):
    path = str(tmp_path / "m.pth")
    cfg, model = _tiny_checkpoint(path)
    seg = init_segmentor(TINY, path, device="cpu")
    assert seg.CLASSES == ["a", "b", "c", "d", "e"] and not seg.model.training
    img = np.random.RandomState(0).randint(0, 255, (32, 32, 3)).astype(
        np.uint8)
    sub = {"arch.backbone.body.depth": [1, 1, 2, 1]}
    for meta in (None, sub):
        pred = inference_segmentor(seg, img, meta)
        assert pred.shape == (32, 32) and pred.dtype == np.int32
        x = torch.from_numpy(img[None]).permute(0, 3, 1, 2).float()
        norm = cfg["img_norm_cfg"]
        x = (x - torch.tensor(norm["mean"])[:, None, None]) \
            / torch.tensor(norm["std"])[:, None, None]
        with torch.no_grad():
            want = model.eval().simple_test(
                x, encode_arch(model_max_arch(cfg["model"]), meta))
        np.testing.assert_array_equal(pred, want[0].numpy())
    out = str(tmp_path / "overlay.png")
    blend = apis.show_result_pyplot(img, pred, seg.PALETTE, out_file=out)
    assert blend.shape == (32, 32, 3) and os.path.exists(out)
    np.testing.assert_array_equal(blend, show_result(img, pred, seg.PALETTE))
    ds = SyntheticDataset(length=2, size=(32, 32), num_classes=5, seed=1)
    assert apis.single_gpu_test(seg.model, ds, seg.arch(), device="cpu")[
        "mIoU"] == evaluate(seg.model, ds, seg.arch(), device="cpu")["mIoU"]
    apis.set_random_seed(3)
    a = (np.random.rand(), torch.rand(1))
    apis.set_random_seed(3)
    assert a == (np.random.rand(), torch.rand(1))


def _rows(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return [{"arch.backbone.body.depth": [int(rng.randint(2, 4)),
                                          int(rng.randint(3, 7)),
                                          int(rng.randint(5, 24)),
                                          int(rng.randint(2, 4))],
             "data.input_shape": [3, int(rng.choice([480, 560, 640])),
                                  int(rng.choice([480, 560, 640]))],
             "overhead.flops": float(rng.uniform(134e9, 141e9))}
            for _ in range(n)]


@pytest.mark.parametrize("rules", ["ar50to101v2_rules.py",
                                   "ar50to101v2_ft1x_rules.py"])
def test_model_space_and_rules_match_jax(tmp_path, rules):
    path = os.path.join(REPO, "configs", "_dynamic_", "rules", rules)
    rule_cfg = Config.fromfile(path)["model_sampling_rules"]
    rows = _rows()
    for r in rows:
        r["metric.mIoU"] = float(np.random.RandomState(len(r)).rand())
    got = ModelSpace.load(rows).apply_rule(build_sample_rule(rule_cfg))
    want = JModelSpace.load(rows).apply_rule(j_build_rule(
        JConfig.fromfile(path)["model_sampling_rules"]))
    assert got.pack() == want.pack() and len(got) > 0
    out = str(tmp_path / "space.json")
    got.dump(out)
    assert ModelSpace.load(out).pack() == want.pack()


def test_sweep_log_matches_jax(tmp_path):
    metas = [{"arch": {"d": [i]}} for i in range(3)]
    port, ref = SweepLog(str(tmp_path / "a.jsonl")), \
        JSweepLog(str(tmp_path / "b.jsonl"))
    for log in (port, ref):
        log.record(metas[0], {"mIoU": 0.5})
        log.record(metas[2], {"mIoU": 0.25})
    assert open(tmp_path / "a.jsonl").read() == \
        open(tmp_path / "b.jsonl").read()
    again = SweepLog(str(tmp_path / "a.jsonl"))
    assert [again.done(m) for m in metas] == [True, False, True]
    assert again.annotated([dict(m) for m in metas], "t") == \
        JSweepLog(str(tmp_path / "b.jsonl")).annotated(
            [dict(m) for m in metas], "t")


def _space(tmp_path):
    cfg = Config.fromfile(TINY)
    sampler = build_model_sampler(cfg["train_sampler"])
    metas = [sampler.sample() for _ in range(4)]
    path = str(tmp_path / "space.json")
    with open(path, "w") as f:
        json.dump(metas, f)
    return path


def test_test_supernet_cli_end_to_end(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "iter_1.pth")
    _tiny_checkpoint(ckpt)
    space = _space(tmp_path)
    base = [TINY, ckpt, "--model-space", space, "--device", "cpu",
            "--bn-calibrate", "2", "--batch-size", "2"]
    rows = test_supernet.main(base + ["--work-dir", str(tmp_path / "v"),
                                      "--vmap", "3"])
    seq = test_supernet.main(base + ["--work-dir", str(tmp_path / "s")])
    assert len(rows) == len(seq) == 4
    for a, b in zip(rows, seq):
        assert a == b and np.isfinite(a["metric"]["metric"]["mIoU"])
    with open(tmp_path / "v" / "test_supernet" / "metrics.json") as f:
        assert json.load(f) == rows
    # a rerun finds every subnet scored: no calibration, no eval
    import gaiaseg_tpu_torch.engine as engine
    calls = []
    for name in ("calibrate_bn", "evaluate", "evaluate_population"):
        monkeypatch.setattr(engine, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    again = test_supernet.main(base + ["--work-dir", str(tmp_path / "v"),
                                       "--vmap", "3"])
    assert again == rows and not calls
