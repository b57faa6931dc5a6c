"""Port's sliced layers (gaiaseg_tpu_torch/ops) vs the JAX masked modules.

Same numpy inputs, weights carried from the JAX variables by the port's
converter (engine/convert.py), float32 on both sides. Each layer is held
at MAX width and at a sliced width: the port slices prefixes of the MAX
parameters where the JAX package masks, and the two must agree on every
active channel and on the BN running statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.models.backbones.dynamic_resnet import \
    DynamicResNet as JDynamicResNet
from gaiaseg_tpu.ops import blocks as jblocks
from gaiaseg_tpu.ops import dynamic_layers as jlayers
from gaiaseg_tpu.ops.masking import channel_mask
from gaiaseg_tpu_torch.engine.convert import (backbone_state_dict, bn_state,
                                              conv_state)
from gaiaseg_tpu_torch.models.backbones.dynamic_resnet import DynamicResNet
from gaiaseg_tpu_torch.ops.blocks import DynBottleneck
from gaiaseg_tpu_torch.ops.dynamic_layers import DynBatchNorm, DynConv2d

torch.set_num_threads(1)
ATOL = 1e-5


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).transpose(0, 3, 1, 2)
                            .copy())


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("case", ["max", "sliced", "in_tail",
                                  "bias_dilated"])
def test_dyn_conv2d_matches_jax(case):
    rng = np.random.RandomState(0)
    kw = dict(in_max=8, out=6, k=3, stride=1, dilation=1, bias=False)
    if case == "sliced":
        kw["stride"] = 2
    if case == "bias_dilated":
        kw.update(bias=True, dilation=2)
    x_max = rng.randn(2, 9, 9, kw["in_max"]).astype(np.float32)
    jmod = jlayers.DynConv2d(kw["out"], kw["k"], kw["stride"],
                             kw["dilation"], use_bias=kw["bias"],
                             dtype=jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x_max))
    if kw["bias"]:
        variables = {"params": {**variables["params"], "bias": jnp.asarray(
            rng.randn(kw["out"]).astype(np.float32))}}
    port = DynConv2d(kw["in_max"], kw["out"], kw["k"], kw["stride"],
                     kw["dilation"], bias=kw["bias"])
    port.load_state_dict(conv_state(variables["params"]))

    x, out_slice, in_tail = x_max, None, 0
    if case == "sliced":
        x, out_slice = x_max[..., :3], 4
    elif case == "in_tail":      # [elastic prefix 2 of 5, static tail 3]
        x, out_slice, in_tail = np.concatenate(
            [x_max[..., :2], x_max[..., 5:]], -1), 4, 3
    y_j = jmod.apply(variables, jnp.asarray(x), out_slice=out_slice,
                     in_tail=in_tail or None)
    y_p = port(_nchw(x), out_slice, in_tail)
    np.testing.assert_allclose(_nhwc(y_p), np.asarray(y_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["max", "sliced", "masked"])
def test_dyn_batchnorm_train_matches_jax(case):
    """Train-mode output and the running stats of ALL channels: updated on
    the active prefix (momentum 0.9 decay == torch 0.1, unbiased var), the
    rest untouched."""
    rng = np.random.RandomState(1)
    c_max, c = 6, (6 if case == "max" else 4)
    x_max = (rng.randn(3, 5, 5, c_max) * 2 + 1).astype(np.float32)
    jmod = jlayers.DynBatchNorm(c_max, dtype=jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x_max),
                          use_running_average=False)
    variables = {
        "params": {"scale": jnp.asarray(rng.rand(c_max) + 0.5, jnp.float32),
                   "bias": jnp.asarray(rng.randn(c_max), jnp.float32)},
        "batch_stats": {"mean": jnp.asarray(rng.randn(c_max), jnp.float32),
                        "var": jnp.asarray(rng.rand(c_max) + 0.5,
                                           jnp.float32)}}
    port = DynBatchNorm(c_max)
    port.load_state_dict(bn_state(variables["params"],
                                  variables["batch_stats"]))
    port.train()

    if case == "masked":   # JAX: MAX width, inactive lanes zero + mask
        mask = channel_mask(c, c_max, jnp.float32)
        x_j = x_max * np.asarray(mask)
        y_j, mut = jmod.apply(variables, jnp.asarray(x_j), mask,
                              use_running_average=False,
                              mutable=["batch_stats"])
        assert float(jnp.abs(y_j[..., c:]).max()) == 0.0
    else:
        y_j, mut = jmod.apply(variables, jnp.asarray(x_max[..., :c]),
                              use_running_average=False,
                              mutable=["batch_stats"])
    y_p = port(_nchw(x_max[..., :c]))
    np.testing.assert_allclose(_nhwc(y_p), np.asarray(y_j)[..., :c], rtol=0,
                               atol=ATOL)
    stats = mut["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=ATOL)


def _bottleneck_state(p, s):
    sd = {}
    for k in (1, 2, 3):
        sd.update({f"conv{k}.{n}": v for n, v in
                   conv_state(p[f"conv{k}"]).items()})
        sd.update({f"bn{k}.{n}": v for n, v in
                   bn_state(p[f"bn{k}"], s[f"bn{k}"]).items()})
    if "downsample_conv" in p:
        sd.update({f"downsample.0.{n}": v for n, v in
                   conv_state(p["downsample_conv"]).items()})
        sd.update({f"downsample.1.{n}": v for n, v in
                   bn_state(p["downsample_bn"], s["downsample_bn"]).items()})
    return sd


@pytest.mark.parametrize("width", [4, 2])
def test_dyn_bottleneck_train_matches_jax(width):
    """Block 0 of a stage (stride 2, projection shortcut) at MAX and at a
    sliced mid width: output on the 4*width active channels (the JAX
    masked lanes are zero) and the running stats of all four BNs."""
    rng = np.random.RandomState(2)
    planes, inplanes = 4, 6
    x = rng.randn(2, 8, 8, inplanes).astype(np.float32)
    jmod = jblocks.DynBottleneck(planes, strides=2, has_downsample=True,
                                 dtype=jnp.float32)
    out_mask = channel_mask(width * 4, planes * 4, jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), planes,
                          channel_mask(planes * 4, planes * 4, jnp.float32),
                          train=True)
    y_j, mut = jmod.apply(variables, jnp.asarray(x), width, out_mask,
                          train=True, mutable=["batch_stats"])
    port = DynBottleneck(inplanes, planes, stride=2, downsample=True)
    port.load_state_dict(_bottleneck_state(variables["params"],
                                           variables["batch_stats"]))
    port.train()
    y_p = port(_nchw(x), width)
    assert y_p.shape[1] == 4 * width
    y_j = np.asarray(y_j)
    np.testing.assert_allclose(_nhwc(y_p), y_j[..., :4 * width], rtol=0,
                               atol=ATOL)
    assert not np.any(y_j[..., 4 * width:])
    want = _bottleneck_state(variables["params"], mut["batch_stats"])
    got = port.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=ATOL, err_msg=k)


def test_dyn_bottleneck_depth_inactive_is_identity_in_jax():
    """The JAX depth gate (active=False) passes the input through and
    freezes the block's BN stats: exactly what the port's not calling the
    block does (held end to end by the backbone test below)."""
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, 6, 6, 16).astype(np.float32))
    jmod = jblocks.DynBottleneck(4, dtype=jnp.float32)
    mask = channel_mask(16, 16, jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(5), x, 4, mask, train=True)
    y, mut = jmod.apply(variables, x, 4, mask, train=True,
                        active=jnp.asarray(False), mutable=["batch_stats"])
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    for a, b in zip(jax.tree_util.tree_leaves(mut["batch_stats"]),
                    jax.tree_util.tree_leaves(variables["batch_stats"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


BACKBONE = dict(stem_width=8, body_width=(4, 8, 8, 8),
                body_depth=(2, 2, 3, 2))
ARCHS = {
    "max": {"stem": 8, "width": [4, 8, 8, 8], "depth": [2, 2, 3, 2]},
    "sliced": {"stem": 4, "width": [2, 4, 6, 4], "depth": [1, 2, 2, 1]},
    "min": {"stem": 4, "width": [2, 2, 2, 2], "depth": [1, 1, 1, 1]},
}


@pytest.fixture(scope="module")
def jax_backbone():
    model = JDynamicResNet(**BACKBONE, dtype=jnp.float32)
    x = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    arch0 = {"stem": {"width": jnp.asarray(8)},
             "body": {"width": jnp.asarray([4, 8, 8, 8]),
                      "depth": jnp.asarray([2, 2, 3, 2])}}
    variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(7),
                                             jnp.asarray(x), a, train=True)
                        )(arch0)
    apply = jax.jit(lambda v, a: model.apply(v, jnp.asarray(x), a, train=True,
                                             mutable=["batch_stats"]))
    return variables, apply, x


@pytest.mark.parametrize("name", list(ARCHS))
def test_dynamic_resnet_train_matches_jax(jax_backbone, name):
    """Every stage output (active channels) and every BN running stat after
    one train-mode forward, within 1e-4 of each tensor's max magnitude;
    blocks past the depth stay untouched."""
    variables, apply, x = jax_backbone
    a = ARCHS[name]
    arch_j = {"stem": {"width": jnp.asarray(a["stem"], jnp.int32)},
              "body": {"width": jnp.asarray(a["width"], jnp.int32),
                       "depth": jnp.asarray(a["depth"], jnp.int32)}}
    outs_j, mut = apply(variables, arch_j)
    port = DynamicResNet(**BACKBONE)
    port.load_state_dict(backbone_state_dict(variables["params"],
                                             variables["batch_stats"],
                                             prefix=""))
    port.train()
    outs_p = port(_nchw(x), {"stem": {"width": a["stem"]},
                             "body": {"width": a["width"],
                                      "depth": a["depth"]}})
    for i, (yp, yj) in enumerate(zip(outs_p, outs_j)):
        c = 4 * a["width"][i]
        assert yp.shape[1] == c
        yj = np.asarray(yj)[..., :c]
        np.testing.assert_allclose(_nhwc(yp), yj, rtol=0,
                                   atol=1e-4 * np.abs(yj).max(),
                                   err_msg=f"stage {i}")
    want = backbone_state_dict(variables["params"], mut["batch_stats"],
                               prefix="")
    got = port.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4 * v.abs().max().item(),
                                       err_msg=k)
