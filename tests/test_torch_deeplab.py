"""The port's DeepLabV3+ and ResNet-v1c supernets against the JAX package.

Two scaled-down configs of the repo's own (``configs/_dynamic_/models/
deeplabv3plus_ar50to101v2.py`` and ``pspnet_ar50to101_v1c.py``): output
stride 8 (strides 1/2/1/1, dilations 1/1/2/4, contracted), a separable
ASPP head with the c1 skip and an FCN aux head; a deep 3-list stem with a
PSP head and an FCN aux head with ``concat_input=True`` (``conv_cat``). At
32x32 the decode logits are 8x8 and the aux logits 4x4, so both losses take
the fused resize-CE (its plain version here; JAX's Pallas kernel in
interpret mode) at row factors 4 and 8, as on the card.

JAX variables are seeded numpy arrays of the JAX model's shapes (random BN
biases and statistics), carried to the port by ``engine/convert.py``.
JAX's float32 BN statistics (``E[x^2] - E[x]^2``, ROADMAP C3) read up to
3e-2 of a gradient's max from float64 on these nets, so the reference is
the JAX model run in float64: x64 on, the float32 casts of its layers,
resize and loss modules made float64 for the fixture's duration (the
package itself unchanged), the unfused loss. The train step takes JAX's
init for the kernels and the backbone and random values for the heads' BN
and biases, on 8 zero-mean images, where the port's float32 is within 5e-5
of float64 (fully random weights are ill-conditioned in any float32).
Under the parity rules of the separable ASPP (ROADMAP C9): at MAX every
value is random; at a subnet the inactive lanes of each ASPP ``dw_bn`` hold
bias 0 and statistics (0, 1), and their running statistics are compared on
the active lanes only.

- ``forward_train``: the loss within 1e-5 relative, every gradient and BN
  statistic within 1e-4 of its tensor's max, at MAX and at a subnet; the
  port run in float64 within 1e-6 (its loss's interpolation stays
  float32).
- Whole-mode logits within 1e-4 of max|ref|.
- C9: a bias on the inactive ``dw_bn`` lanes moves JAX's logits at the
  subnet; the port's supernet equals its extracted subnet whatever they
  hold.
- The v1c state dict round-trips through JAX's own converter (deep stem,
  ``conv_cat``).
- The two full configs build in the port at full width.
- Each head alone (``ASPPHead``, the separable ``DynamicASPPHead``, FCN
  under ``resize_concat`` with ``conv_cat``) on seeded features at MAX
  and narrowed: train-mode logits and statistics, eval-mode logits within
  1e-4 of max|ref| of JAX's float32 head.
"""
import os

import gaiaseg_tpu.models.losses.cross_entropy as j_ce_module
import gaiaseg_tpu.models.segmentors.encoder_decoder as j_ed_module
import gaiaseg_tpu.ops.dynamic_layers as j_layers_module
import gaiaseg_tpu.ops.resize as j_resize_module
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.engine.torch_convert import segmentor_state_dict_to_variables
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.engine.extract import extract_subnet
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.utils import Config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
RTOL = 1e-4
F64_RTOL = 1e-6
CE = dict(type="CrossEntropyLoss")
WIDTHS = [4, 8, 8, 16]


def model_cfg(kind: str, jax_side: bool):
    dt = {"dtype": jnp.float32} if jax_side else {}
    bb = dict(type="DynamicResNet", stem_width=8, body_width=WIDTHS,
              body_depth=[1, 2, 2, 1], strides=(1, 2, 1, 1),
              dilations=(1, 1, 2, 4), contract_dilation=True,
              out_indices=(0, 1, 2, 3), **dt)
    aux = dict(type="DynamicFCNHead", in_index=2, channels=8, num_convs=1,
               concat_input=False, dropout_ratio=0.0, num_classes=5,
               loss_decode=dict(CE, loss_weight=0.4), **dt)
    if kind == "deeplab":
        head = dict(type="DepthwiseSeparableASPPHead", in_index=3,
                    channels=8, dilations=(1, 2, 3), c1_in_index=0,
                    c1_channels=4, dropout_ratio=0.0, num_classes=5,
                    loss_decode=CE, **dt)
    else:
        bb.update(stem_width=[4, 4, 8], deep_stem=True)
        head = dict(type="DynamicPSPHead", in_index=3, channels=8,
                    pool_scales=(1, 2), dropout_ratio=0.0, num_classes=5,
                    loss_decode=CE, **dt)
        aux["concat_input"] = True
    cfg = dict(type="DynamicEncoderDecoder", backbone=bb, decode_head=head,
               auxiliary_head=aux, test_cfg=dict(mode="whole"))
    if jax_side:
        cfg["fused_loss"] = True
    return cfg


METAS = {
    "deeplab": {"arch.backbone.stem.width": 6,
                "arch.backbone.body.width": [3, 6, 8, 10],
                "arch.backbone.body.depth": [1, 1, 2, 1]},
    "v1c": {"arch.backbone.stem.width": [2, 4, 6],
            "arch.backbone.body.width": [4, 5, 6, 12],
            "arch.backbone.body.depth": [1, 2, 1, 1]},
}


def seeded(shape, path, rng):
    """Values of the right kind for each JAX leaf: He-scaled kernels, BN
    scales near 1, random biases and means, positive variances."""
    name = path[-1]
    if name == "kernel":
        return rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    return 0.1 * rng.randn(*shape)


def seeded_variables(jmodel, jcfg, hw=32, seed=0):
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, hw, hw, 3)),
        jnp.zeros((1, hw, hw), jnp.int32),
        j_encode_arch(j_model_max_arch(jcfg)), method="forward_train"))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                            rng).astype(np.float32), shapes)


def train_variables(jmodel, jcfg, seeded_vars):
    """JAX's init, but for the heads' random BN parameters, statistics and
    biases (``seeded_vars``'s)."""
    k = jax.random.PRNGKey(0)
    init = jax.jit(lambda a: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 32, 32), jnp.int32), a, method="forward_train"))(
        j_encode_arch(j_model_max_arch(jcfg)))

    def pick(path, rand, ini):
        keys = [getattr(q, "key", q) for q in path]
        head = keys[1] == "decode_head_m" or keys[1].startswith("aux_heads")
        return rand if head and keys[-1] != "kernel" else np.asarray(ini)
    return jax.tree_util.tree_map_with_path(pick, seeded_vars, init)


def dw_bn_lanes(variables, active, bias=0.0):
    """A copy of ``variables`` whose ASPP ``dw_bn`` lanes from ``active``
    on hold ``bias`` and running statistics (0, 1)."""
    out = jax.tree_util.tree_map(np.array, variables)
    head_p = out["params"]["decode_head_m"]
    head_s = out["batch_stats"]["decode_head_m"]
    for name, branch in head_p.get("aspp", {}).items():
        if "dw_bn" in branch:
            branch["dw_bn"]["bias"][active:] = bias
            head_s["aspp"][name]["dw_bn"]["mean"][active:] = 0.0
            head_s["aspp"][name]["dw_bn"]["var"][active:] = 1.0
    return out


def active_lanes(kind, sub):
    return METAS[kind]["arch.backbone.body.width"][3] * 4 if sub \
        else WIDTHS[3] * 4


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` meaning float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _as_f64(cfg):
    if isinstance(cfg, dict):
        return {k: _as_f64(v) for k, v in cfg.items()}
    return jnp.float64 if cfg is jnp.float32 else cfg


def jax_float64_reference(kind, cases, img, gt):
    """JAX's ``forward_train`` (loss, gradients, new BN statistics) and
    whole-mode logits in float64 for each ``(meta, train_vars, eval_vars)``
    of ``cases``, as numpy trees."""
    out = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in (j_layers_module, j_resize_module, j_ce_module,
                    j_ed_module):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jcfg = dict(_as_f64(model_cfg(kind, True)), fused_loss=False)
        jmodel = j_build_segmentor(jcfg)
        max_arch = j_model_max_arch(jcfg)
        k = jax.random.PRNGKey(0)

        def loss_fn(params, stats, arch):
            (total, _), mut = jmodel.apply(
                {"params": params, "batch_stats": stats}, jnp.asarray(img),
                jnp.asarray(gt), arch, False, method=jmodel.forward_train,
                mutable=["batch_stats"], rngs={"dropout": k})
            return total, mut

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        infer = jax.jit(lambda v, a: jmodel.apply(
            v, jnp.asarray(img), a, method=jmodel.whole_inference))
        for meta, train_vars, eval_vars in cases:
            arch = j_encode_arch(max_arch, meta)
            v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       train_vars)
            (total, mut), grads = value_and_grad(v["params"],
                                                 v["batch_stats"], arch)
            logits = infer(jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), eval_vars), arch)
            out.append(jax.tree_util.tree_map(np.asarray, dict(
                loss=total, grads=grads, stats=mut["batch_stats"],
                logits=logits)))
    return out


@pytest.fixture(scope="module", params=["deeplab", "v1c"])
def supernet(request):
    kind = request.param
    jcfg = model_cfg(kind, True)
    jmodel = j_build_segmentor(jcfg)
    variables = seeded_variables(jmodel, jcfg)
    train_vars = train_variables(jmodel, jcfg, variables)
    rng = np.random.RandomState(3)
    img = rng.randn(8, 32, 32, 3).astype(np.float32)
    gt = rng.randint(0, 5, (8, 32, 32)).astype(np.int32)
    gt[:, :4] = 255
    act = active_lanes(kind, True)
    cases = {False: (None, train_vars, variables),
             True: (METAS[kind], dw_bn_lanes(train_vars, act),
                    dw_bn_lanes(variables, act))}
    refs = jax_float64_reference(kind, list(cases.values()), img, gt)
    return dict(kind=kind, img=img, gt=gt, cases=cases,
                refs=dict(zip(cases, refs)))


def port_model(variables, kind):
    cfg = model_cfg(kind, False)
    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(variables, cfg),
                          strict=True)
    return model


def nchw(img):
    return torch.from_numpy(img.transpose(0, 3, 1, 2).copy())


def close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("sub", [False, True], ids=["max", "sub"])
def test_forward_train_loss_grads_and_stats_match_jax(supernet, sub):
    kind = supernet["kind"]
    meta, variables, _ = supernet["cases"][sub]
    ref = supernet["refs"][sub]
    cfg = model_cfg(kind, False)
    arch = encode_arch(model_max_arch(cfg), meta)
    gt = torch.from_numpy(supernet["gt"])
    model64 = port_model(variables, kind).double().train()
    model64.forward_train(nchw(supernet["img"]).double(), gt,
                          arch)[0].backward()
    model = port_model(variables, kind).train()
    total, logs = model.forward_train(nchw(supernet["img"]), gt, arch)
    assert set(logs) == {"decode.loss_seg", "aux_0.loss_seg"}
    total.backward()
    loss_j = float(ref["loss"])
    assert abs(float(total.detach()) - loss_j) <= LOSS_RTOL * abs(loss_j)
    want = variables_to_state_dict({"params": ref["grads"],
                                    "batch_stats": ref["stats"]}, cfg)
    grads64 = dict(model64.named_parameters())
    for key, p in model.named_parameters():
        g64 = grads64[key].grad
        assert (p.grad is None) == (g64 is None), key
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        close(g, want[key].numpy(), f"grad {key}")
        close(np.zeros(p.shape) if g64 is None else g64.numpy(),
              want[key].numpy(), f"float64 grad {key}", F64_RTOL)
    act = active_lanes(kind, sub)
    for key, buf in model.named_buffers():
        lanes = act if "depthwise_conv.bn" in key and "aspp" in key \
            else buf.shape[0]
        close(buf.numpy()[:lanes], want[key].numpy()[:lanes], f"stat {key}")


@pytest.mark.parametrize("sub", [False, True], ids=["max", "sub"])
def test_whole_inference_matches_jax(supernet, sub):
    kind = supernet["kind"]
    meta, _, variables = supernet["cases"][sub]
    model = port_model(variables, kind).eval()
    with torch.no_grad():
        got = model.whole_inference(nchw(supernet["img"]), encode_arch(
            model_max_arch(model_cfg(kind, False)), meta))
    assert tuple(got.shape) == (8, 5, 32, 32)
    close(got.permute(0, 2, 3, 1).numpy(), supernet["refs"][sub]["logits"],
          "logits")


def test_separable_aspp_leak_is_jax_only():
    """ROADMAP C9: JAX's unmasked ``dw_bn`` lets the inactive lanes' bias
    through to the pointwise conv; the port, sliced, does not, and its
    supernet at the arch equals the extracted subnet."""
    jcfg = model_cfg("deeplab", True)
    jmodel = j_build_segmentor(jcfg)
    variables = seeded_variables(jmodel, jcfg)
    meta = METAS["deeplab"]
    act = active_lanes("deeplab", True)
    img = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    infer = jax.jit(lambda v, a: jmodel.apply(
        v, jnp.asarray(img), a, method=jmodel.whole_inference))
    arch_j = j_encode_arch(j_model_max_arch(jcfg), meta)
    clean = np.asarray(infer(dw_bn_lanes(variables, act), arch_j))
    leaky = np.asarray(infer(dw_bn_lanes(variables, act, bias=3.0), arch_j))
    leak = float(np.abs(leaky - clean).max())
    print(f"C9: inactive dw_bn bias 3.0 moves JAX's subnet logits by {leak}")
    assert leak > 1e-2 * float(np.abs(clean).max())

    cfg = model_cfg("deeplab", False)
    model = port_model(dw_bn_lanes(variables, act, bias=3.0),
                       "deeplab").eval()
    sub_cfg, sub_sd, _ = extract_subnet(cfg, model.state_dict(), meta)
    sub = build_segmentor(sub_cfg)
    sub.load_state_dict(sub_sd, strict=True)
    x = nchw(img)
    with torch.no_grad():
        sup = model.whole_inference(x, encode_arch(model_max_arch(cfg),
                                                   meta))
        got = sub.eval().whole_inference(x, encode_arch(model_max_arch(
            sub_cfg)))
    assert torch.equal(got, sup)
    close(sup.permute(0, 2, 3, 1).numpy(), clean, "port vs clean JAX")


def test_v1c_state_dict_round_trips_through_jax_converter():
    jcfg = model_cfg("v1c", True)
    variables = seeded_variables(j_build_segmentor(jcfg), jcfg)
    model = port_model(variables, "v1c")
    assert "backbone.stem.6.weight" in model.state_dict()
    assert "auxiliary_head.conv_cat.conv.weight" in model.state_dict()
    back = segmentor_state_dict_to_variables(model.state_dict(), variables,
                                             jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("name,params_m,stem", [
    ("deeplabv3plus_ar50to101v2.py", 106.767702, 64),
    ("pspnet_ar50to101_v1c.py", 114.249734, [32, 32, 64])])
def test_full_configs_build_at_full_width(name, params_m, stem):
    cfg = Config.fromfile(os.path.join(REPO, "configs", "_dynamic_",
                                       "models", name))["model"]
    with torch.device("meta"):
        model = build_segmentor(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert abs(n / 1e6 - params_m) < 1e-6
    assert model_max_arch(cfg)["backbone"]["stem"]["width"] == stem
    layer4 = model.backbone.layer4
    assert layer4[0].conv2.dilation == (2, 2)
    assert layer4[1].conv2.dilation == (4, 4)
    assert layer4[0].conv2.stride == (1, 1)


HEADS = {
    "aspp": dict(type="ASPPHead", in_index=3, dilations=(1, 2, 3)),
    "aspp_separable": dict(type="DynamicASPPHead", in_index=3,
                           dilations=(1, 2), separable=True),
    "fcn_resize_concat": dict(type="FCNHead", in_index=[1, 2, 3],
                              input_transform="resize_concat", num_convs=2,
                              concat_input=True),
}
FEATS = [(16, 8), (32, 4), (32, 4), (64, 4)]     # (channels, size) at MAX


@pytest.mark.parametrize("narrow", [False, True], ids=["max", "narrow"])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax(name, narrow):
    """A head alone on seeded features, train mode (output and new
    statistics) then eval mode. ``narrow``: every feature at 3/4 of its
    channels, sliced for the port and zero-padded for JAX (its masked
    layout); the separable head's ``dw_bn`` lanes beyond hold bias 0 and
    statistics (0, 1) (ROADMAP C9)."""
    from gaiaseg_tpu.utils.registry import HEADS as J_HEADS
    from gaiaseg_tpu_torch.engine.convert import _head_state_dict
    from gaiaseg_tpu_torch.models import build_head
    cfg = dict(HEADS[name], channels=8, dropout_ratio=0.0, num_classes=5)
    rng = np.random.RandomState(2)
    feats = [rng.randn(4, s, s, c).astype(np.float32) for c, s in FEATS]
    act = [c * 3 // 4 if narrow else c for c, _ in FEATS]
    j_feats = [np.concatenate([f[..., :a], np.zeros_like(f[..., a:])], -1)
               for f, a in zip(feats, act)]
    jcls = J_HEADS.get(cfg["type"])
    jhead = jcls(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in cfg.items() if k != "type"},
                 in_channels=[FEATS[i][0] for i in cfg["in_index"]]
                 if isinstance(cfg["in_index"], list) else None,
                 dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in j_feats]))
    srng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                            srng).astype(np.float32), shapes)
    if name == "aspp_separable":
        variables = dw_bn_lanes({"params": {"decode_head_m": variables[
            "params"]}, "batch_stats": {"decode_head_m": variables[
                "batch_stats"]}}, act[3])
        variables = {k: v["decode_head_m"] for k, v in variables.items()}
    out_j, mut = jhead.apply(variables, [jnp.asarray(f) for f in j_feats],
                             train=True, mutable=["batch_stats"])
    eval_j = jhead.apply(variables, [jnp.asarray(f) for f in j_feats])

    def state_dict(stats):
        return {k[2:]: v for k, v in _head_state_dict(
            "h", variables["params"], stats, cfg).items()}

    head = build_head(cfg, [c for c, _ in FEATS])
    head.load_state_dict(state_dict(variables["batch_stats"]), strict=True)
    x = [nchw(f[..., :a]) for f, a in zip(feats, act)]
    out = head.train()(x)
    close(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out_j),
          "train logits")
    want = state_dict(jax.tree_util.tree_map(np.asarray,
                                             mut["batch_stats"]))
    for key, buf in head.named_buffers():
        lanes = act[3] if "depthwise_conv.bn" in key else buf.shape[0]
        close(buf.numpy()[:lanes], want[key].numpy()[:lanes], f"stat {key}")
    head.load_state_dict(state_dict(variables["batch_stats"]))
    with torch.no_grad():
        got = head.eval()(x)
    close(got.permute(0, 2, 3, 1).numpy(), np.asarray(eval_j),
          "eval logits")
