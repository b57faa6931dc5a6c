"""Port's elastic-ViT path (gaiaseg_tpu_torch) vs the JAX package.

Same numpy inputs, weights carried from the JAX variables by the port's
converter (engine/convert.py), float32 on both sides, dropout 0. A tiny
version of ``configs/_dynamic_/models/upernet_elastic_vit.py``: embed 32,
depth 4, 2 heads of 64, patch 4, ``img_size`` 32. Each module is held
against its JAX module within 1e-4 of each tensor's max magnitude (the
port slices prefixes where JAX masks, so only summation order differs):
DynLinear, DynLayerNorm, the bicubic pos-embed resize (up and down) against
``jax.image.resize``, ElasticTransformer (MAX, MIN, a random arch, with and
without the cls token, depth below the largest out index), the neck, the
UPer head; then the whole segmentor's loss and every gradient, and 3
AdamW + global-norm-clip steps against ``make_train_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.engine import optim as joptim
from gaiaseg_tpu.engine.torch_convert import vit_state_dict_to_params
from gaiaseg_tpu.engine.train import TrainState, make_train_step
from gaiaseg_tpu.models import build_backbone as j_build_backbone
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.models.decode_heads.uper_head import \
    DynamicUPerHead as JUPerHead
from gaiaseg_tpu.models.necks.multilevel_neck import \
    DynamicMultiLevelNeck as JNeck
from gaiaseg_tpu.ops import dynamic_layers as jlayers
from gaiaseg_tpu.ops.masking import channel_mask
from gaiaseg_tpu_torch.engine import optim
from gaiaseg_tpu_torch.engine.convert import (_head_state_dict, linear_state,
                                              ln_state, neck_state_dict,
                                              variables_to_state_dict,
                                              vit_state_dict)
from gaiaseg_tpu_torch.engine.train import train_step
from gaiaseg_tpu_torch.models import (build_backbone, build_segmentor,
                                      encode_arch, model_max_arch)
from gaiaseg_tpu_torch.models.backbones.elastic_transformer import \
    resize_pos_grid
from gaiaseg_tpu_torch.models.decode_heads.uper_head import DynamicUPerHead
from gaiaseg_tpu_torch.models.necks.multilevel_neck import \
    DynamicMultiLevelNeck
from gaiaseg_tpu_torch.ops.dynamic_layers import DynLayerNorm, DynLinear

torch.set_num_threads(1)
F32 = jnp.float32
RTOL = 1e-4


def _close(got, want, what="", floor=0.0, rtol=RTOL):
    """|got - want| <= rtol * max(max|want|, floor)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rtol * max(float(np.abs(want).max()), floor),
        err_msg=what)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).transpose(0, 3, 1, 2)
                            .copy())


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["max", "sliced"])
def test_dyn_linear_matches_jax(case):
    rng = np.random.RandomState(0)
    x_max = rng.randn(3, 5, 12).astype(np.float32)
    jmod = jlayers.DynLinear(10, dtype=F32)
    variables = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x_max)))
    variables["params"]["bias"] = rng.randn(10).astype(np.float32)
    port = DynLinear(12, 10)
    port.load_state_dict(linear_state(variables["params"]))
    x, out = (x_max, None) if case == "max" else (x_max[..., :7], 6)
    want = jmod.apply(variables, jnp.asarray(x), out_slice=out)
    _close(port(torch.from_numpy(x), out), want, case)


@pytest.mark.parametrize("case", ["max", "sliced", "masked"])
def test_dyn_layernorm_matches_jax(case):
    """eps 1e-6 and statistics over the active channels only: the port's
    prefix slice equals the JAX mask on the active channels."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 6, 16) * 3 + 1).astype(np.float32)
    jmod = jlayers.DynLayerNorm(16, dtype=F32)
    variables = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["params"] = {"scale": rng.randn(16).astype(np.float32),
                           "bias": rng.randn(16).astype(np.float32)}
    port = DynLayerNorm(16)
    port.load_state_dict(ln_state(variables["params"]))
    if case == "max":
        want, got = jmod.apply(variables, jnp.asarray(x)), port(
            torch.from_numpy(x))
    elif case == "sliced":
        want = jmod.apply(variables, jnp.asarray(x[..., :9]))
        got = port(torch.from_numpy(x[..., :9]))
    else:   # JAX masks channels 9.. of the full-width input
        want = jmod.apply(variables, jnp.asarray(x),
                          channel_mask(9, 16, F32))[..., :9]
        got = port(torch.from_numpy(x[..., :9]))
    _close(got, want, case)
    assert port.eps == 1e-6


@pytest.mark.parametrize("grid,out", [(8, (12, 12)), (8, (6, 6)),
                                      (8, (5, 11))])
def test_pos_embed_bicubic_matches_jax_image_resize(grid, out):
    """Keys cubic a = -0.5, half-pixel centres, antialias when shrinking."""
    rng = np.random.RandomState(2)
    pos = rng.randn(1, grid * grid, 7).astype(np.float32)
    want = jax.image.resize(jnp.asarray(pos.reshape(1, grid, grid, 7)),
                            (1,) + out + (7,), method="bicubic")
    got = resize_pos_grid(torch.from_numpy(pos), out)
    _close(got.reshape(1, out[0], out[1], 7), want, f"{grid}->{out}")


# --------------------------------------------------------------------- #
def vit_cfg(jax_side: bool, with_cls_token: bool = False):
    dt = {"dtype": F32} if jax_side else {}
    return dict(type="ElasticTransformer", embed_dim=32, depth=4,
                num_heads=2, ffn_ratio=4.0, patch_size=4, img_size=32,
                out_indices=(0, 1, 2, 3), with_cls_token=with_cls_token,
                use_flash=True, **dt)


def _random_meta(seed):
    rng = np.random.RandomState(seed)
    return {"arch.backbone.embedding.width": int(rng.choice([16, 24, 32])),
            "arch.backbone.encoder.depth": int(rng.randint(2, 5)),
            "arch.backbone.encoder.num_heads": [int(h) for h in
                                                rng.randint(1, 3, 4)],
            "arch.backbone.encoder.ffn_channels": [int(f) for f in
                                                   rng.randint(32, 129, 4)]}


METAS = {
    "max": None,
    "min": {"arch.backbone.embedding.width": 16,
            "arch.backbone.encoder.depth": 2},
    "random": _random_meta(7),
}


@pytest.mark.parametrize("with_cls", [False, True])
@pytest.mark.parametrize("name,size", [("max", 32), ("min", 32),
                                       ("random", 32), ("max", 48),
                                       ("random", 24)])
def test_elastic_transformer_matches_jax(name, size, with_cls):
    """Every output map; at MIN (depth 2) out indices 2 and 3 give the
    layer-1 output again. 48 and 24 pixels resize the 8x8 pos grid to
    12x12 and 6x6."""
    rng = np.random.RandomState(3)
    img = rng.randn(2, size, size, 3).astype(np.float32)
    jcfg, cfg = vit_cfg(True, with_cls), vit_cfg(False, with_cls)
    jbb = j_build_backbone(jcfg)
    max_arch = {"backbone": jbb.max_arch()}
    arch_j = j_encode_arch(max_arch, METAS[name])["backbone"]
    variables = _np(jbb.init(jax.random.PRNGKey(0), jnp.asarray(img),
                             j_encode_arch(max_arch)["backbone"]))
    want = jbb.apply(variables, jnp.asarray(img), arch_j)
    port = build_backbone(cfg)
    port.load_state_dict(vit_state_dict(variables["params"], prefix=""),
                         strict=True)
    arch = encode_arch(model_max_arch({"backbone": cfg}),
                       METAS[name])["backbone"]
    with torch.no_grad():
        got = port(_nchw(img), arch)
    emb = arch["embedding"]["width"]
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert np.all(w[..., emb:] == 0)
        _close(_nhwc(g), w[..., :emb], f"out {i}")
    if name == "min":
        assert torch.equal(got[2], got[1]) and torch.equal(got[3], got[1])


def test_neck_matches_jax():
    rng = np.random.RandomState(4)
    feats = [rng.randn(2, 8, 8, 32).astype(np.float32) for _ in range(4)]
    feats = [f * (np.arange(32) < 24) for f in feats]   # embed width 24
    jneck = JNeck(out_channels=16, scales=(4, 2, 1, 0.5), dtype=F32)
    variables = _np(jneck.init(jax.random.PRNGKey(0),
                               [jnp.asarray(f) for f in feats]))
    variables = jax.tree_util.tree_map(
        lambda a: a + rng.randn(*a.shape).astype(np.float32) * 0.1,
        variables)   # nonzero biases
    want = jneck.apply(variables, [jnp.asarray(f) for f in feats])
    port = DynamicMultiLevelNeck([32] * 4, 16, (4, 2, 1, 0.5))
    port.load_state_dict(neck_state_dict(variables["params"], prefix=""),
                         strict=True)
    with torch.no_grad():
        got = port([_nchw(f[..., :24]) for f in feats])
    assert [tuple(g.shape[2:]) for g in got] == [(32, 32), (16, 16), (8, 8),
                                                 (4, 4)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(_nhwc(g), w, f"level {i}")


@pytest.mark.parametrize("train", [False, True])
def test_uper_head_matches_jax(train):
    """Logits, and in train mode the BN running stats too."""
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, s, s, 12).astype(np.float32) for s in (16, 8, 4, 2)]
    jhead = JUPerHead(num_classes=5, channels=8, pool_scales=(1, 2),
                      dropout_ratio=0.0, dtype=F32)
    jf = [jnp.asarray(f) for f in feats]
    variables = _np(jhead.init(jax.random.PRNGKey(0), jf))
    out = jhead.apply(variables, jf, train=train, mutable=["batch_stats"])
    want, stats = out[0], _np(out[1]["batch_stats"])
    port = DynamicUPerHead([12] * 4, 8, (1, 2), num_classes=5,
                           in_index=[0, 1, 2, 3],
                           input_transform="multiple_select",
                           dropout_ratio=0.0)
    def state(batch_stats):
        sd = _head_state_dict("h", variables["params"], batch_stats,
                              {"pool_scales": (1, 2)})
        return {k[len("h."):]: v for k, v in sd.items()}

    port.load_state_dict(state(variables["batch_stats"]), strict=True)
    port.train(train)
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    _close(_nhwc(got), want, "logits")
    new = state(stats)
    for key, buf in port.named_buffers():
        _close(buf, new[key].numpy(), key)


# --------------------------------------------------------------------- #
def seg_cfg(jax_side: bool):
    dt = {"dtype": F32} if jax_side else {}
    cfg = dict(
        type="DynamicEncoderDecoder",
        backbone=vit_cfg(jax_side),
        neck=dict(type="DynamicMultiLevelNeck", in_channels=[32] * 4,
                  out_channels=32, scales=[4, 2, 1, 0.5], **dt),
        decode_head=dict(type="DynamicUPerHead", in_channels=[32] * 4,
                         in_index=(0, 1, 2, 3),
                         input_transform="multiple_select",
                         pool_scales=(1, 2, 3, 6), channels=16,
                         dropout_ratio=0.0, num_classes=5,
                         align_corners=False, **dt,
                         loss_decode=dict(type="CrossEntropyLoss",
                                          loss_weight=1.0)),
        auxiliary_head=dict(type="DynamicFCNHead", in_channels=32,
                            in_index=2, channels=8, num_convs=1,
                            concat_input=False, dropout_ratio=0.0,
                            num_classes=5, **dt,
                            loss_decode=dict(type="CrossEntropyLoss",
                                             loss_weight=0.4)),
        test_cfg=dict(mode="whole"))
    if jax_side:
        cfg["fused_loss"] = True   # aux logits 8x8 -> 32x32 take the kernel
    return cfg


@pytest.fixture(scope="module")
def seg():
    cfg = seg_cfg(True)
    model = j_build_segmentor(cfg)
    # batch 4: the 1x1 pool branch's BN sees one value per sample, and
    # with fewer the JAX float32 statistics (E[x^2] - E[x]^2) lose digits
    rng = np.random.RandomState(6)
    img = rng.randn(4, 32, 32, 3).astype(np.float32)
    gt = rng.randint(0, 5, (4, 32, 32)).astype(np.int32)
    gt[:, :3] = 255
    max_arch = j_model_max_arch(cfg)
    k = jax.random.PRNGKey(0)
    variables = _np(jax.jit(lambda a: model.init(
        {"params": k, "dropout": k}, jnp.asarray(img), jnp.asarray(gt), a,
        compute_acc=False, method="forward_train"))(j_encode_arch(max_arch)))

    def loss_fn(params, arch):
        (total, _), mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(img), jnp.asarray(gt), arch, False,
            method=model.forward_train, mutable=["batch_stats"],
            rngs={"dropout": k})
        return total, mut

    return dict(cfg=cfg, model=model, variables=variables, img=img, gt=gt,
                max_arch=max_arch,
                value_and_grad=jax.jit(jax.value_and_grad(loss_fn,
                                                          has_aux=True)))


def _port_segmentor(variables):
    model = build_segmentor(seg_cfg(False))
    model.load_state_dict(variables_to_state_dict(variables, seg_cfg(False)),
                          strict=True)
    return model


@pytest.mark.parametrize("name", list(METAS))
def test_vit_segmentor_loss_and_grads_match_jax(seg, name):
    meta = METAS[name]
    (total_j, mut), grads_j = seg["value_and_grad"](
        seg["variables"]["params"], j_encode_arch(seg["max_arch"], meta))
    model = _port_segmentor(seg["variables"]).train()
    total, logs = model.forward_train(
        _nchw(seg["img"]), torch.from_numpy(seg["gt"]),
        encode_arch(model_max_arch(seg_cfg(False)), meta))
    assert set(logs) == {"decode.loss_seg", "aux_0.loss_seg"}
    total.backward()
    assert abs(float(total.detach()) - float(total_j)) <= \
        RTOL * abs(float(total_j))
    want = variables_to_state_dict(
        {"params": _np(grads_j), "batch_stats": _np(mut["batch_stats"])},
        seg_cfg(False))
    # the neck's 3x3 conv biases feed train-mode BNs only, so their
    # gradients are zero in exact arithmetic (both sides give ~1e-9 noise):
    # such tensors are held to 1e-4 of 1e-3 of the largest gradient
    floor = 1e-3 * max(float(want[k].abs().max())
                       for k, _ in model.named_parameters())
    for key, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(g, want[key].numpy(), f"grad {key}", floor)
    for key, buf in model.named_buffers():
        _close(buf, want[key].numpy(), f"stat {key}")


def test_vit_whole_inference_matches_jax(seg):
    arch_j = j_encode_arch(seg["max_arch"], METAS["random"])
    want = seg["model"].apply(seg["variables"], jnp.asarray(seg["img"]),
                              arch_j, method="whole_inference")
    model = _port_segmentor(seg["variables"]).eval()
    arch = encode_arch(model_max_arch(seg_cfg(False)), METAS["random"])
    with torch.no_grad():
        got = model.whole_inference(_nchw(seg["img"]), arch)
    _close(_nhwc(got), want, "logits")


def test_vit_state_dict_read_by_jax_converter(seg):
    """The port's backbone state_dict (timm names, fused qkv) is what the
    JAX package's ``vit_state_dict_to_params`` reads."""
    params = seg["variables"]["params"]["backbone_m"]
    model = _port_segmentor(seg["variables"])
    sd = {k[len("backbone."):]: v.numpy()
          for k, v in model.state_dict().items() if k.startswith("backbone.")}
    zeroed = jax.tree_util.tree_map(np.zeros_like, params)
    back = vit_state_dict_to_params(sd, zeroed, ref_grid=8)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        np.testing.assert_array_equal(np.asarray(got), leaf,
                                      err_msg=str(path))


# --------------------------------------------------------------------- #
ADAMW = dict(type="AdamW", lr=6e-5, betas=(0.9, 0.999), weight_decay=0.01)


def _find(opt_state, field):
    if hasattr(opt_state, field):
        return getattr(opt_state, field)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            t = _find(s, field)
            if t is not None:
                return t
    return None


def _structural_zeros(model) -> dict:
    """Parameter elements whose gradient is zero in exact arithmetic: the
    key bias (softmax ignores a per-query constant) and the neck's 3x3 conv
    biases (only train-mode BNs read them). Adam scales their rounding
    noise to steps of about lr with a random sign, on either side."""
    inner = 2 * 64
    out = {}
    for key, p in model.named_parameters():
        if key.endswith("attn.qkv.bias"):
            mask = torch.zeros_like(p, dtype=torch.bool)
            mask[inner:2 * inner] = True
            out[key] = mask
        elif key.startswith("neck.convs.") and key.endswith(".bias"):
            out[key] = torch.ones_like(p, dtype=torch.bool)
    return out


def test_three_adamw_clip_steps_match_jax(seg):
    """MAX, MIN, random with the global-norm clip at a max_norm that the
    first step's gradient exceeds and the others do not. Parameters, BN
    stats and the first Adam moment within 1e-4, the second moment
    (quadratic in the gradient) within 2e-4, each of max(the tensor's max,
    1e-2 of the largest tensor's max): Adam divides each element by its own
    gradient scale, so a small element carries the rounding of the large
    ones. Elements with a gradient that is zero in exact arithmetic only
    move by at most 3 steps of lr."""
    rng = np.random.RandomState(8)
    batches = [(rng.randn(4, 32, 32, 3).astype(np.float32),
                rng.randint(0, 5, (4, 32, 32)).astype(np.int32))
               for _ in range(3)]
    metas = [METAS["max"], METAS["min"], METAS["random"]]
    clip = {"grad_clip": {"max_norm": 3.0}}
    variables = seg["variables"]
    tx = joptim.build_optimizer(ADAMW, clip)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree_util.tree_map(jnp.asarray,
                                                     variables["params"]),
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(seg["model"], tx, update_stats=True)

    model = _port_segmentor(variables).train()
    optimizer = optim.build_optimizer(model.parameters(), ADAMW)
    max_norm = optim.grad_clip_norm(clip)
    port_max = model_max_arch(seg_cfg(False))
    k = jax.random.PRNGKey(0)
    norms = []
    for (img, gt), meta in zip(batches, metas):
        state, logs = step(state, jnp.asarray(img), jnp.asarray(gt),
                           j_encode_arch(seg["max_arch"], meta), k)
        out = train_step(model, optimizer, _nchw(img), torch.from_numpy(gt),
                         encode_arch(port_max, meta), max_norm=max_norm)
        assert float(out["grad_norm"]) == pytest.approx(
            float(logs["grad_norm"]), rel=1e-4)
        norms.append(float(logs["grad_norm"]))
    assert norms[0] > max_norm and min(norms[1:]) < max_norm, norms

    stats = _np(state.batch_stats)
    want = variables_to_state_dict({"params": _np(state.params),
                                    "batch_stats": stats}, seg_cfg(False))
    got = model.state_dict()
    assert set(got) == set(want)
    zeros = _structural_zeros(model)
    start = variables_to_state_dict(variables, seg_cfg(False))

    def floor(tensors):
        return 1e-2 * max(float(t.abs().max()) for t in tensors)

    f = floor(want.values())
    for key in want:
        g, w = got[key].clone(), want[key]
        if key in zeros:
            m = zeros[key]
            assert float((g[m] - start[key][m]).abs().max()) <= 3 * 1.01 * \
                ADAMW["lr"], key
            g[m] = w[m]
        _close(g, w.numpy(), key, f)
    for field, torch_key, rtol in (("mu", "exp_avg", RTOL),
                                   ("nu", "exp_avg_sq", 2 * RTOL)):
        moment = variables_to_state_dict(
            {"params": _np(_find(state.opt_state, field)),
             "batch_stats": stats}, seg_cfg(False))
        f = floor(moment[k] for k, _ in model.named_parameters())
        for key, p in model.named_parameters():
            _close(optimizer.state[p][torch_key], moment[key].numpy(),
                   f"{field} {key}", f, rtol)


# --------------------------------------------------------------------- #
VIT_CONFIG = "configs/_dynamic_/models/upernet_elastic_vit.py"


def test_vit_config_arch_and_sampler_match_jax():
    """The shipped config through both packages' loaders: the MAX arch,
    the train sampler's draws (MAX, MIN, then width x depth draws) and
    their encoded archs, and the val anchors."""
    import os
    from gaiaseg_tpu.archspace.samplers import \
        build_model_sampler as j_build_model_sampler
    from gaiaseg_tpu.utils.config import Config as JConfig
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.utils import Config
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), VIT_CONFIG)
    opts = {"model.backbone.with_cls_token": False}
    cfg, jcfg = Config.fromfile(path), JConfig.fromfile(path)
    cfg.merge_from_dict(opts)
    jcfg.merge_from_dict(opts)
    assert cfg.to_dict() == jcfg.to_dict()
    port_max = model_max_arch(cfg["model"])
    assert port_max == j_model_max_arch(jcfg.to_dict()["model"])
    port, ref = build_model_sampler(cfg["train_sampler"]), \
        j_build_model_sampler(jcfg["train_sampler"])
    for _ in range(12):
        meta = port.sample()
        assert meta == ref.sample()
        want = jax.tree_util.tree_map(
            lambda x: np.asarray(x).tolist(),
            j_encode_arch(j_model_max_arch(jcfg.to_dict()["model"]), meta))
        assert encode_arch(port_max, meta) == want
    assert [m["name"] for m in build_model_sampler(
        cfg["val_sampler"]).traverse()] == ["MIN", "MAX"]
