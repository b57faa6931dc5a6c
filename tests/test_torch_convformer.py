"""The port's ElasticConvformer supernet against the JAX package.

JAX's own small config (``tests/test_convformer.py`` ``CFG``: stem 8,
widths 16/32/64, depths 2/2/2, embed 64, one head, FFN ratio 2.0, patch
16) on 64x64 inputs, and that test's sub arch. JAX variables are seeded
numpy arrays of the JAX model's shapes (``tests/test_torch_deeplab.py``
``seeded``: random BN statistics, which ``norm_eval`` reads in train mode
too), carried to the port by ``engine/convert.py``; the reference is the
JAX model run in float64 (``tests/test_torch_convnext.py``
``jax_float64``): the port's float64 within 1e-6 and its float32 within
1e-4 of each tensor's max|ref|.

- Every block kind alone (the bottleneck with and without ``res_conv``
  and the FCU-up input, the transformer block, a fusion block, a
  downsampling one, the last fusion block) at MAX and narrowed, then the
  backbone at MAX, at the sub arch and at that arch one block deeper.
- ``norm_eval`` leaves every BN statistic alone under ``train()``.
- The converter fuses ``w_q/w_k/w_v`` into ``qkv`` and carries the BN
  statistics.
- A UPer segmentor's losses and every gradient at MAX and at the sub arch.
- FLOPs and parameters equal JAX's counter; calibration keeps the
  backbone's statistics under ``norm_eval`` (ROADMAP C11); a checkpoint
  round-trips; extraction raises (ROADMAP C16).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.archspace.complexity import \
    get_model_complexity_info as j_complexity
from gaiaseg_tpu.models import build_backbone as j_build_backbone
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.models.backbones import elastic_convformer as jcf
from gaiaseg_tpu.ops.masking import channel_mask
from gaiaseg_tpu_torch.archspace.complexity import get_model_complexity_info
from gaiaseg_tpu_torch.data import SyntheticDataset
from gaiaseg_tpu_torch.engine import (calibrate_bn, load_checkpoint, optim,
                                      save_checkpoint)
from gaiaseg_tpu_torch.engine.convert import (attn_state,
                                              convformer_state_dict,
                                              variables_to_state_dict)
from gaiaseg_tpu_torch.engine.extract import extract_subnet
from gaiaseg_tpu_torch.engine.train import train_step
from gaiaseg_tpu_torch.models import (build_backbone, build_segmentor,
                                      encode_arch, model_max_arch)
from gaiaseg_tpu_torch.models.backbones import elastic_convformer as pcf
from gaiaseg_tpu_torch.ops.dynamic_layers import DynBatchNorm
from test_torch_convnext import (F64_RTOL, LOSS_RTOL, RTOL, close_grads,
                                 f64_tree, jax_float64,
                                 jax_forward_train_f64)
from test_torch_deeplab import _as_f64, close, nchw, seeded

torch.set_num_threads(1)
F64 = jnp.float64
CFG = dict(type="ElasticConvformer", stem_width=8,
           body_width=(16, 32, 64), body_depth=(2, 2, 2),
           embed_dim=64, num_heads=1, mlp_ratio=20, patch_size=16,
           out_indices=(0, 1, 2, 3))
SUB = {"stem": {"width": 8},
       "body": {"depth": [1, 1, 1],
                "block": {"convblock": {"width": [8, 16, 32]},
                          "embed_dim": {"width": 32},
                          "transblock": {
                              "MHA": {"num_heads": [1, 1, 1]},
                              "FFN": {"feedforward_channels": [10, 10,
                                                               10]}}}}}
DEEPER = copy.deepcopy(SUB)
DEEPER["body"]["depth"] = [2, 1, 1]
ARCHS = {"max": None, "sub": SUB, "deeper": DEEPER}


def seeded_params(module, *args, seed=2, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kw))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p], rng),
        shapes)


def masked(rng, shape, active):
    """A seeded NHWC (or token) array, zero beyond ``active`` channels."""
    x = rng.randn(*shape)
    x[..., active:] = 0.0
    return x


def tokens(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# kind -> (JAX module, port module, input shapes: map NHWC, tokens)
def block_case(kind, narrow):
    e_max, e = 64, (32 if narrow else 64)
    ffn = 64 if narrow else 128
    if kind == "conv_res":
        w_in, w = (8, 16) if narrow else (16, 32)
        return (jcf.ElasticConvBlock(32, 2, True, dtype=F64),
                pcf.ElasticConvBlock(16, 32, 2, True),
                dict(x=(2, 16, 16, 16), act=w_in, width=w))
    if kind == "conv_up":
        w = 16 if narrow else 32
        return (jcf.ElasticConvBlock(32, 1, False, dtype=F64),
                pcf.ElasticConvBlock(32, 32, 1, False),
                dict(x=(2, 8, 8, 32), act=w, width=w, up=w // 4))
    if kind == "trans":
        return (jcf.ElasticTransBlock(e_max, 1, 128, dtype=F64),
                pcf.trans_block(e_max, 1, 128),
                dict(t=(2, 17, e_max), emb=e, ffn=ffn))
    w_in = 16 if narrow else 32
    spec = {"fusion": (dict(outplanes=32, dw_stride=2), (32, 32),
                       (2, 16, 16, 32), w_in, 65),
            "fusion_down": (dict(outplanes=32, dw_stride=2, strides=2,
                                 res_conv=True), (16, 32),
                            (2, 32, 32, 16), w_in // 2, 65),
            "last_fusion": (dict(outplanes=64, dw_stride=1, strides=2,
                                 res_conv=True, last_fusion=True),
                            (64, 64), (2, 8, 8, 64), 2 * w_in, 65)}[kind]
    jkw, (cin, cout), xshape, act, n_tok = spec
    pkw = {k: v for k, v in jkw.items() if k != "outplanes"}
    pkw["stride"] = pkw.pop("strides", 1)
    return (jcf.FusionBlock(embed_dim=e_max, max_heads=1, max_ffn=128,
                            dtype=F64, **jkw),
            pcf.FusionBlock(cin, cout, e_max, 1, 128, **pkw),
            dict(x=xshape, act=act, width=cout // 2 if narrow else cout,
                 t=(2, n_tok, e_max), emb=e, ffn=ffn))


KINDS = ["conv_res", "conv_up", "trans", "fusion", "fusion_down",
         "last_fusion"]


@pytest.mark.parametrize("narrow", [False, True], ids=["max", "narrow"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_matches_jax(kind, narrow):
    jmod, pmod, spec = block_case(kind, narrow)
    rng = np.random.RandomState(1)
    x = masked(rng, spec["x"], spec["act"]) if "x" in spec else None
    t = masked(rng, spec["t"], spec["emb"]) if "t" in spec else None
    if kind == "trans":
        e_mask = channel_mask(spec["emb"], 64, F64)
        args = (jnp.asarray(t), 1, spec["ffn"])
        params = seeded_params(jmod, *args, channel_mask(64, 64))
        call = (lambda: jmod.apply(params, *args, e_mask))
    elif kind.startswith("conv"):
        up = None
        if "up" in spec:
            up = masked(rng, spec["x"][:3] + (8,), spec["up"])
        args = (jnp.asarray(x), spec["width"])
        kw = {} if up is None else {"x_t_r": jnp.asarray(up)}
        params = seeded_params(jmod, *args, **kw)
        call = (lambda: jmod.apply(params, *args, **kw))
    else:
        e_mask = channel_mask(spec["emb"], 64, F64)
        args = (jnp.asarray(x), jnp.asarray(t), spec["width"], 1,
                spec["ffn"])
        params = seeded_params(jmod, *args, channel_mask(64, 64))
        call = (lambda: jmod.apply(params, *args, e_mask))
    want = jax_float64(call)
    # under a parent name, so a lone transformer layer reads as one
    sd = convformer_state_dict({"m": params["params"]},
                               {"m": params.get("batch_stats", {})},
                               prefix="")
    sd = {k[len("m."):]: v for k, v in sd.items()}
    for dtype, rtol in ((torch.float64, F64_RTOL), (torch.float32, RTOL)):
        m = copy.deepcopy(pmod).to(dtype)
        m.load_state_dict({k: v.to(dtype) for k, v in sd.items()},
                          strict=True)
        m.eval()
        if kind == "trans":
            got = [m(tokens(t[..., :spec["emb"]]).to(dtype), 1, spec["ffn"])]
            refs = [want[..., :spec["emb"]]]
        elif kind.startswith("conv"):
            xt = nchw(x[..., :spec["act"]]).to(dtype)
            got = list(m(xt, spec["width"],
                         None if up is None
                         else nchw(up[..., :spec["up"]]).to(dtype)))
            refs = [want[0][..., :spec["width"]],
                    want[1][..., :spec["width"] // 4]]
            got = [g.permute(0, 2, 3, 1) for g in got]
        else:
            out, out_t = m(nchw(x[..., :spec["act"]]).to(dtype),
                           tokens(t[..., :spec["emb"]]).to(dtype),
                           spec["width"], 1, spec["ffn"])
            got = [out.permute(0, 2, 3, 1), out_t]
            refs = [want[0][..., :spec["width"]],
                    want[1][..., :spec["emb"]]]
            assert not np.asarray(want[0])[..., spec["width"]:].any()
        for i, (g, r) in enumerate(zip(got, refs)):
            assert tuple(g.shape) == r.shape, (kind, i)
            close(g.detach().double().numpy(), r, f"{kind} {i} {dtype}",
                  rtol)


@pytest.fixture(scope="module")
def backbone():
    jbb = j_build_backbone(dict(CFG, dtype=jnp.float32))
    x = np.random.RandomState(0).randn(2, 64, 64, 3)
    variables = seeded_params(jbb, jnp.zeros((1, 64, 64, 3)),
                              j_model_max_arch({"backbone": CFG})[
                                  "backbone"], seed=3)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       variables)
    j64 = j_build_backbone(_as_f64(dict(CFG, dtype=jnp.float32)))
    outs = {}
    for name, arch in ARCHS.items():
        a = j_encode_arch(j_model_max_arch({"backbone": CFG}),
                          None if arch is None else {"arch": {
                              "backbone": arch}})["backbone"]
        outs[name] = jax_float64(lambda: j64.apply(f64_tree(variables),
                                                   jnp.asarray(x), a))
    return dict(x=x, variables=variables, outs=outs)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_backbone_matches_jax(backbone, name):
    sd = convformer_state_dict(backbone["variables"]["params"],
                               backbone["variables"]["batch_stats"],
                               prefix="")
    arch = encode_arch(model_max_arch({"backbone": CFG}),
                       None if ARCHS[name] is None else
                       {"arch": {"backbone": ARCHS[name]}})["backbone"]
    widths = arch["body"]["block"]["convblock"]["width"]
    widths = widths + [widths[-1]]
    want = backbone["outs"][name]
    assert [w.shape[1:3] for w in want] == [(16, 16), (8, 8), (4, 4),
                                            (2, 2)]
    for dtype, rtol in ((torch.float64, F64_RTOL), (torch.float32, RTOL)):
        bb = build_backbone(CFG).to(dtype)
        bb.load_state_dict(sd, strict=True)
        got = bb.train()(nchw(backbone["x"]).to(dtype), arch)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape[1] == widths[i]
            assert not np.asarray(w)[..., widths[i]:].any()
            close(g.detach().permute(0, 2, 3, 1).double().numpy(),
                  w[..., :widths[i]], f"{name} out {i} {dtype}", rtol)
    # depth gating is live (JAX test_convformer_masking_and_depth)
    assert not np.allclose(backbone["outs"]["sub"][0],
                           backbone["outs"]["deeper"][0])


def test_norm_eval_leaves_bn_statistics_alone():
    torch.manual_seed(0)
    bb = build_backbone(CFG).double()
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, DynBatchNorm):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 1.5)
    before = {k: v.clone() for k, v in bb.state_dict().items()}
    arch = model_max_arch({"backbone": CFG})["backbone"]
    x = torch.randn(2, 3, 64, 64, dtype=torch.float64)
    bb.train()
    assert bb.training and not any(
        m.training for m in bb.modules() if isinstance(m, DynBatchNorm))
    out_train = bb(x, arch)
    for k, v in bb.state_dict().items():
        assert torch.equal(v, before[k]), k
    out_eval = bb.eval()(x, arch)
    assert all(torch.equal(a, b) for a, b in zip(out_train, out_eval))
    moving = build_backbone(dict(CFG, norm_eval=False)).double().train()
    moving.load_state_dict(before)
    moving(x, arch)
    assert not torch.equal(moving.bn1.running_mean, before["bn1.running_mean"])


def test_converter_fuses_qkv_and_carries_bn_statistics(backbone):
    p = backbone["variables"]["params"]
    s = backbone["variables"]["batch_stats"]
    attn = p["stage1_block0"]["trans_block"]["attn"]
    sd = attn_state(attn, "a")
    want = np.concatenate([np.asarray(attn[n]["kernel"]).T
                           for n in ("w_q", "w_k", "w_v")])
    assert np.array_equal(sd["a.qkv.weight"].numpy(), want)
    assert np.array_equal(sd["a.qkv.bias"].numpy(), np.concatenate(
        [attn[n]["bias"] for n in ("w_q", "w_k", "w_v")]))
    full = convformer_state_dict(p, s)
    assert np.array_equal(
        full["backbone.stages.1.0.cnn_block.bn_res.running_var"].numpy(),
        s["stage1_block0"]["cnn_block"]["bn_res"]["var"])
    assert np.array_equal(
        full["backbone.last_fusion.fusion_block.conv_res.weight"].numpy(),
        np.asarray(p["last_fusion"]["fusion_block"]["conv_res"]["kernel"])
        .transpose(3, 2, 0, 1))
    assert set(full) == {f"backbone.{k}" for k in
                         build_backbone(CFG).state_dict()}


def seg_cfg(jax_side: bool):
    dt = {"dtype": jnp.float32} if jax_side else {}
    return dict(
        type="DynamicEncoderDecoder", backbone=dict(CFG, **dt),
        decode_head=dict(type="DynamicUPerHead", in_index=(0, 1, 2, 3),
                         input_transform="multiple_select", channels=16,
                         pool_scales=(1, 2), dropout_ratio=0.0,
                         num_classes=5,
                         loss_decode=dict(type="CrossEntropyLoss"), **dt),
        auxiliary_head=dict(type="DynamicFCNHead", in_index=2, channels=8,
                            num_convs=1, concat_input=False,
                            dropout_ratio=0.0, num_classes=5,
                            loss_decode=dict(type="CrossEntropyLoss",
                                             loss_weight=0.4), **dt),
        test_cfg=dict(mode="whole"), fused_loss=False)


SEG_METAS = {"max": None, "sub": {"arch": {"backbone": SUB}}}


@pytest.fixture(scope="module")
def segmentor():
    jcfg = seg_cfg(True)
    jmodel = j_build_segmentor(jcfg)
    arch = j_encode_arch(j_model_max_arch(jcfg))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64), jnp.int32), arch, method="forward_train"))
    rng = np.random.RandomState(4)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                            rng).astype(np.float32), shapes)
    rng = np.random.RandomState(5)
    img = rng.randn(8, 64, 64, 3).astype(np.float32)
    gt = rng.randint(0, 5, (8, 64, 64)).astype(np.int32)
    gt[:, :6] = 255
    refs = jax_forward_train_f64(jcfg, variables, list(SEG_METAS.values()),
                                 img, gt)
    return dict(variables=variables, img=img, gt=gt,
                refs=dict(zip(SEG_METAS, refs)))


@pytest.mark.parametrize("meta", sorted(SEG_METAS))
def test_segmentor_losses_and_grads_match_jax(segmentor, meta):
    ref = segmentor["refs"][meta]
    cfg = seg_cfg(False)
    arch = encode_arch(model_max_arch(cfg), SEG_METAS[meta])
    want = variables_to_state_dict({"params": ref["grads"],
                                    "batch_stats": ref["stats"]}, cfg)
    gt = torch.from_numpy(segmentor["gt"])
    for dtype, rtol, lrtol in ((torch.float64, F64_RTOL, F64_RTOL),
                               (torch.float32, RTOL, LOSS_RTOL)):
        model = build_segmentor(cfg)
        model.load_state_dict(variables_to_state_dict(
            segmentor["variables"], cfg), strict=True)
        model = model.to(dtype).train()
        total, logs = model.forward_train(nchw(segmentor["img"]).to(dtype),
                                          gt, arch)
        total.backward()
        for key in ("decode.loss_seg", "aux_0.loss_seg"):
            w = float(ref["logs"][key])
            assert abs(float(logs[key].detach()) - w) <= lrtol * abs(w), key
        close_grads({k: p.grad for k, p in model.named_parameters()},
                    want, dtype, rtol)
        for key, buf in model.named_buffers():
            close(buf.double().numpy(), want[key].numpy(),
                  f"stat {key} {dtype}", rtol)


def test_flops_params_calibration_checkpoint_and_extraction(tmp_path):
    """The port's counter equals JAX's (``complexity.py:239``) at MAX and
    the sub arch; the port module has the counter's parameters and those
    the counter leaves out (ROADMAP C17);
    calibration re-estimates the heads' BN statistics and keeps the
    backbone's under ``norm_eval`` (C11); a checkpoint round-trips; the
    extraction of a subnet raises (C16)."""
    cfg = seg_cfg(False)
    max_arch = model_max_arch(cfg)
    for meta in SEG_METAS.values():
        arch = encode_arch(max_arch, meta)
        got = get_model_complexity_info(cfg, arch, (3, 512, 512))
        assert got == j_complexity(seg_cfg(True), arch, (3, 512, 512))
    torch.manual_seed(0)
    model = build_segmentor(cfg)
    n = sum(p.numel() for p in model.parameters())
    # ROADMAP C17: the counter leaves out the cls token, each fusion
    # block's squeeze LayerNorm and expand BN, and all of the last fusion
    # block but its first bottleneck
    missed = sum(p.numel() for k, p in model.named_parameters()
                 if k == "backbone.cls_token"
                 or (k.startswith("backbone.stages.")
                     and (".squeeze_ln." in k or ".expand_bn." in k))
                 or (k.startswith("backbone.last_fusion.")
                     and not k.startswith("backbone.last_fusion.cnn_block.")))
    assert n == get_model_complexity_info(cfg, max_arch, (3, 64, 64))[
        "params"] + missed == 366994
    assert missed == 45472
    opt = optim.build_optimizer(model.parameters(),
                                dict(type="AdamW", lr=1e-3))
    train_step(model.train(), opt, torch.randn(2, 3, 64, 64),
               torch.randint(0, 5, (2, 64, 64)), max_arch, max_norm=5.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ds = SyntheticDataset(length=4, size=(64, 64), num_classes=5, seed=1)
    calibrate_bn(model, ds, max_arch, num_batches=2)
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])}
    assert moved and not any(k.startswith("backbone.") for k in moved)
    path = str(tmp_path / "c.pth")
    save_checkpoint(path, model, opt, {"iter": 1})
    torch.manual_seed(1)
    fresh = build_segmentor(cfg)
    fresh_opt = optim.build_optimizer(fresh.parameters(),
                                      dict(type="AdamW", lr=1e-3))
    load_checkpoint(path, fresh, fresh_opt)
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert str(opt.state_dict()) == str(fresh_opt.state_dict())
    with pytest.raises(NotImplementedError, match="ElasticConvformer"):
        extract_subnet(cfg, model.state_dict(), SEG_METAS["sub"])
