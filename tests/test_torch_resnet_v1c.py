"""The port's DynamicResNet options against the JAX backbone.

Backbone alone, its variables seeded numpy arrays of the JAX module's
shapes (random BN parameters and statistics) carried by
``engine/convert.backbone_state_dict``; 4 zero-mean 64x64 images. The
reference is the JAX module in float64 (``test_torch_deeplab.py``'s
patch: JAX's float32 BN statistics are themselves far from float64, ROADMAP
C3). At MAX and at a subnet, in train mode, every output feature and every
updated running statistic is within 1e-5 of its tensor's max for the
port's float32 run with BN at JAX's init (scale 1, bias 0; random
statistics), and within 1e-10 for its float64 run with every value random
(where float32 itself reads up to 2e-5 from float64; its statistics within
1e-7, the converter's float32 rounding of the reference), for:

- the deep stem, its widths a 3-list (with contracted dilation, strides
  1/2/1/1 and dilations 1/1/2/4, the v1c config's) and a scalar;
- avg_down (the ResNet-D shortcut) at strides 1/2/2/2 and under dilation;
- norm_eval: the backbone normalizes with its running statistics in train
  mode, leaves them bit-unchanged and calls no collective, while a head's
  BN still trains.

Calibration under norm_eval (ROADMAP C11): JAX's ``calibrate_bn`` leaves
the backbone's statistics at the (0, 1) of its reset; the port keeps the
backbone's statistics and re-estimates the heads' as JAX does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaiaseg_tpu.ops.dynamic_layers as j_layers_module
from gaiaseg_tpu.data import SyntheticDataset as JSyntheticDataset
from gaiaseg_tpu.data.pipeline_cfg import \
    TestPipelineParams as JTestPipelineParams
from gaiaseg_tpu.engine import calibrate as jcal
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.models.backbones.dynamic_resnet import \
    DynamicResNet as JDynamicResNet
from gaiaseg_tpu_torch.data import SyntheticDataset
from gaiaseg_tpu_torch.data import TestPipelineParams as EvalParams
from gaiaseg_tpu_torch.engine import calibrate as cal
from gaiaseg_tpu_torch.engine.convert import (backbone_state_dict,
                                              variables_to_state_dict)
from gaiaseg_tpu_torch.models import (build_backbone, build_segmentor,
                                      encode_arch, model_max_arch)
from gaiaseg_tpu_torch.ops import dynamic_layers

from test_torch_deeplab import _Float64Numpy, seeded
from test_torch_segmentor import model_cfg as flagship_cfg

torch.set_num_threads(1)
RTOL = 1e-5
F64_RTOL = 1e-10
F64_STAT_RTOL = 1e-7    # the reference statistics pass engine/convert.py,
                        # which stores float32
CALIB_RTOL = 1e-4     # as tests/test_torch_calibrate.py, against float32 JAX
EXACT = dict(mean=(128.0, 128.0, 128.0), std=(64.0, 64.0, 64.0))

BASE = dict(body_width=[4, 8, 8, 16], body_depth=[2, 2, 2, 1])
V1C = dict(strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
           contract_dilation=True)
VARIANTS = {
    "deep_list": dict(BASE, stem_width=[4, 4, 8], deep_stem=True, **V1C),
    "deep_scalar": dict(BASE, stem_width=8, deep_stem=True),
    "avg_down": dict(BASE, stem_width=8, avg_down=True),
    "avg_down_dilated": dict(BASE, stem_width=[4, 4, 8], deep_stem=True,
                             avg_down=True, **V1C),
    "norm_eval": dict(BASE, stem_width=[4, 4, 8], deep_stem=True,
                      norm_eval=True, **V1C),
}
SUBS = {
    "deep_list": {"stem": {"width": [2, 4, 6]},
                  "body": {"width": [3, 6, 5, 12], "depth": [1, 2, 1, 1]}},
    "deep_scalar": {"stem": {"width": 6},
                    "body": {"width": [4, 5, 8, 10], "depth": [2, 1, 2, 1]}},
    "avg_down": {"stem": {"width": 6},
                 "body": {"width": [2, 8, 6, 9], "depth": [1, 2, 1, 1]}},
    "avg_down_dilated": {"stem": {"width": [4, 2, 6]},
                         "body": {"width": [4, 4, 8, 12],
                                  "depth": [2, 1, 1, 1]}},
    "norm_eval": {"stem": {"width": [2, 4, 6]},
                  "body": {"width": [3, 6, 5, 12], "depth": [1, 2, 1, 1]}},
}


def _backbone_cfg(name):
    return dict(type="DynamicResNet", out_indices=(0, 1, 2, 3),
                **VARIANTS[name])


def _max_arch(name):
    return model_max_arch({"backbone": _backbone_cfg(name)})["backbone"]


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """Seeded variables, the images, and JAX's float64 features and new
    statistics at MAX and at the subnet."""
    name = request.param
    rng = np.random.RandomState(3)
    img = rng.randn(4, 64, 64, 3).astype(np.float32)
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in VARIANTS[name].items()}
    max_arch = _max_arch(name)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(j_layers_module, "jnp", _Float64Numpy())
        jmodel = JDynamicResNet(dtype=jnp.float64, **cfg)
        k = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda: jmodel.init(
            k, jnp.zeros((1, 64, 64, 3)), max_arch))
        srng = np.random.RandomState(0)
        rand = jax.tree_util.tree_map_with_path(
            lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                                srng).astype(np.float32), shapes)
        init_bn = jax.tree_util.tree_map_with_path(
            lambda p, t: (np.ones_like(t) if p[-1].key == "scale" else
                          np.zeros_like(t) if p[-1].key == "bias" else t),
            rand)
        run = jax.jit(lambda v, a: jmodel.apply(
            jax.tree_util.tree_map(lambda t: t.astype(jnp.float64), v),
            jnp.asarray(img), a, train=True, mutable=["batch_stats"]))
        refs = {}
        for kind, variables in (("float32", init_bn), ("float64", rand)):
            for which, arch in (("max", max_arch), ("sub", SUBS[name])):
                feats, mut = run(variables, arch)
                refs[kind, which] = jax.tree_util.tree_map(
                    np.asarray, (feats, mut["batch_stats"]))
    return dict(name=name, img=img, refs=refs,
                variables={"float32": init_bn, "float64": rand},
                arch={"max": max_arch, "sub": SUBS[name]})


def _state_dict(variables, name):
    return backbone_state_dict(variables["params"], variables["batch_stats"],
                               prefix="",
                               avg_down=VARIANTS[name].get("avg_down", False))


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("which", ["max", "sub"])
def test_backbone_features_and_stats_match_jax(variant, which, dtype):
    name = variant["name"]
    variables = variant["variables"][dtype]
    rtol = RTOL if dtype == "float32" else F64_RTOL
    model = build_backbone(_backbone_cfg(name))
    model.load_state_dict(_state_dict(variables, name), strict=True)
    model = model.to(getattr(torch, dtype))
    before = {k: b.clone() for k, b in model.named_buffers()}
    x = torch.from_numpy(variant["img"].transpose(0, 3, 1, 2).copy())
    feats = model.train()(x.to(getattr(torch, dtype)), variant["arch"][which])
    feats_j, stats_j = variant["refs"][dtype, which]
    assert len(feats) == len(feats_j) == 4
    for i, (f, fj) in enumerate(zip(feats, feats_j)):
        c = f.shape[1]          # JAX masks the inactive lanes to zero
        assert not np.any(fj[..., c:])
        _close(f.detach().permute(0, 2, 3, 1).numpy(), fj[..., :c],
               f"feature {i}", rtol)
    want = _state_dict({"params": variables["params"],
                        "batch_stats": stats_j}, name)
    for key, buf in model.named_buffers():
        _close(buf.numpy(), want[key].numpy(), f"stat {key}",
               RTOL if dtype == "float32" else F64_STAT_RTOL)
        if VARIANTS[name].get("norm_eval"):
            assert torch.equal(buf, before[key]), key


def test_layout_follows_mmseg():
    sd = build_backbone(_backbone_cfg("avg_down_dilated")).state_dict()
    assert {f"stem.{i}.weight" for i in (0, 1, 3, 4, 6, 7)} <= set(sd)
    assert not any(k.startswith(("stem.2", "stem.5", "stem.8", "conv1"))
                   for k in sd)
    assert {"layer2.0.downsample.1.weight", "layer2.0.downsample.2.weight",
            "layer3.0.downsample.1.weight"} <= set(sd)
    assert not any(".downsample.0." in k for k in sd)
    model = build_backbone(_backbone_cfg("avg_down_dilated"))
    assert isinstance(model.layer2[0].downsample[0], torch.nn.AvgPool2d)
    assert model.layer2[0].downsample[1].stride == (1, 1)
    assert [model.layer4[i].conv2.dilation for i in range(1)] == [(2, 2)]
    assert model.layer3[0].conv2.dilation == (1, 1)
    assert model.layer3[1].conv2.dilation == (2, 2)


def test_norm_eval_calls_no_collective_and_heads_still_train(monkeypatch):
    """Under a world of 2 a training BN would all-reduce; the norm_eval
    backbone's never does, and a head's BN stays in train mode."""
    def refuse(*args, **kw):
        raise AssertionError("a collective was called")

    monkeypatch.setattr(dynamic_layers, "data_parallel", lambda: (0, 2))
    monkeypatch.setattr(dynamic_layers, "all_reduce_sum", refuse)
    cfg = flagship_cfg(False)
    cfg["backbone"] = dict(cfg["backbone"], norm_eval=True)
    model = build_segmentor(cfg).train()
    assert all(not m.training for m in model.backbone.modules()
               if isinstance(m, dynamic_layers.DynBatchNorm))
    assert model.decode_head.bottleneck.bn.training
    x = torch.randn(2, 3, 32, 32)
    model.backbone(x, encode_arch(model_max_arch(cfg))["backbone"])
    model.eval().train()
    assert not model.backbone.layer1[0].bn1.training


def test_calibrate_under_norm_eval_keeps_the_backbone_statistics():
    """JAX resets the backbone's statistics to (0, 1) and, under norm_eval,
    normalizes with those and never re-estimates them; the port keeps the
    backbone's. From a backbone already at (0, 1), where both normalize
    alike, the heads' calibrated statistics agree."""
    jcfg = flagship_cfg(True)
    jcfg["backbone"] = dict(jcfg["backbone"], norm_eval=True)
    cfg = flagship_cfg(False)
    cfg["backbone"] = dict(cfg["backbone"], norm_eval=True)
    jmodel = j_build_segmentor(jcfg)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 32, 32), jnp.int32),
        j_encode_arch(j_model_max_arch(jcfg)), method="forward_train"))
    srng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                            srng).astype(np.float32), shapes)
    kw = dict(length=5, size=(64, 64), num_classes=7, seed=2, cells=4)
    reset = dict(variables, batch_stats=dict(
        variables["batch_stats"], backbone_m=jcal.reset_bn_stats(
            variables["batch_stats"]["backbone_m"])))
    for start, same_start in ((variables, False), (reset, True)):
        start = jax.tree_util.tree_map(np.asarray, start)
        want_vars = jcal.calibrate_bn(
            jmodel, start, JSyntheticDataset(**kw),
            j_encode_arch(j_model_max_arch(jcfg)), num_batches=3,
            batch_size=2, test_params=JTestPipelineParams(**EXACT))
        want = variables_to_state_dict(
            jax.tree_util.tree_map(np.asarray, want_vars), cfg)
        model = build_segmentor(cfg)
        model.load_state_dict(variables_to_state_dict(start, cfg))
        before = {k: b.clone() for k, b in model.named_buffers()}
        cal.calibrate_bn(model.eval(), SyntheticDataset(**kw),
                         encode_arch(model_max_arch(cfg)), num_batches=3,
                         batch_size=2, test_params=EvalParams(**EXACT))
        n_backbone = 0
        for key, buf in model.named_buffers():
            if key.startswith("backbone."):
                # JAX's debias divides 1 - q by 1 - q in float32
                unit = 0.0 if key.endswith("running_mean") else 1.0
                np.testing.assert_allclose(want[key].numpy(), unit, rtol=0,
                                           atol=1e-6)
                assert torch.equal(buf, before[key]), key
                n_backbone += 1
            elif same_start:
                _close(buf.numpy(), want[key].numpy(), key, CALIB_RTOL)
        assert n_backbone > 0
