"""The ViT's relative positions and token dropout against the JAX package.

``ElasticTransformer(with_rel_pos=True, drop_rate=...)`` at the tiny size of
``tests/test_torch_vit.py`` (embed 32, depth 4, 2 heads of 64, patch 4, an
8x8 grid) with ``rel_max_dist`` 3, so the distances clip. JAX variables
(seeded numpy arrays of its shapes, the tables included) go to the port
through ``engine/convert.py``; the reference is JAX in float64
(``tests/test_torch_convnext.py`` ``jax_float64``): the port's float64
within 1e-6 and its float32 within 1e-4 of each tensor's max|ref|.

- ``relative_index_2d`` equals JAX's; the per-row and per-column key
  groups the port computes on reproduce it entry for entry.
- The score side ``q . R[i, j]`` and the value side ``sum_j attn[i, j]
  R[i, j]`` against the dense ``[n, n, d]`` form of
  ``tests/test_backbones2.py:167`` and against JAX's module.
- The backbone with and without the cls token at MAX, at masked heads and
  a sub depth; a UPer segmentor's losses and every gradient (the tables'
  too) at MAX and at a sub arch.
- The converter's ``rel_pos``/``rel_pos_v`` keys.
- ``pos_drop`` at 0.1: the identity in eval mode; in training the kept
  share and the 1/0.9 scale, drawn from the step's generator.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.models import build_backbone as j_build_backbone
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.models.backbones import elastic_transformer as jvit
from gaiaseg_tpu_torch.engine import optim
from gaiaseg_tpu_torch.engine.convert import (variables_to_state_dict,
                                              vit_state_dict)
from gaiaseg_tpu_torch.engine.train import train_step
from gaiaseg_tpu_torch.models import (build_backbone, build_segmentor,
                                      encode_arch, model_max_arch)
from gaiaseg_tpu_torch.models.backbones import elastic_transformer as pvit
from gaiaseg_tpu_torch.ops.dropout import dropout
from test_torch_convnext import (F64_RTOL, LOSS_RTOL, RTOL, close_grads,
                                 f64_tree, jax_float64,
                                 jax_forward_train_f64)
from test_torch_deeplab import _as_f64, close, nchw, seeded
from test_torch_vit import seg_cfg as vit_seg_cfg

torch.set_num_threads(1)
MAX_DIST = 3


def rel_vit(jax_side: bool, with_cls: bool = True, drop_rate: float = 0.0):
    cfg = vit_seg_cfg(jax_side)["backbone"]
    cfg.update(with_cls_token=with_cls, with_rel_pos=True,
               rel_max_dist=MAX_DIST, drop_rate=drop_rate)
    return cfg


METAS = {
    "max": None,
    "heads": {"arch.backbone.encoder.num_heads": [1, 2, 1, 1],
              "arch.backbone.encoder.ffn_channels": [64, 128, 96, 32]},
    "sub": {"arch.backbone.embedding.width": 24,
            "arch.backbone.encoder.depth": 3,
            "arch.backbone.encoder.num_heads": [2, 1, 1, 2],
            "arch.backbone.encoder.ffn_channels": [128, 64, 48, 128]},
}


@pytest.mark.parametrize("gh,gw,dist,cls", [(3, 4, 2, True),
                                            (3, 4, 2, False),
                                            (5, 5, 14, True),
                                            (4, 7, 3, True),
                                            (6, 2, 1, False)])
def test_relative_index_and_groups_match_jax(gh, gw, dist, cls):
    want_r, want_c = jvit.relative_index_2d(gh, gw, dist, cls)
    got_r, got_c = pvit.relative_index_2d(gh, gw, dist, cls)
    assert np.array_equal(got_r, want_r) and np.array_equal(got_c, want_c)
    groups_r, groups_c = pvit.relative_groups(gh, gw, dist, cls)
    off = int(cls)
    key_row = [0] * off + [off + j // gw for j in range(gh * gw)]
    key_col = [0] * off + [off + j % gw for j in range(gh * gw)]
    assert np.array_equal(groups_r[:, key_row], want_r)
    assert np.array_equal(groups_c[:, key_col], want_c)


@pytest.mark.parametrize("cls", [True, False])
def test_score_and_value_sides_match_the_dense_form(cls):
    """Against the ``[n, n, d]`` embedding of ``tests/test_backbones2.py``
    ``test_rel_pos_value_contrib_matches_dense`` and JAX's module, in
    float64."""
    gh, gw, d = 3, 4, 8
    rng = np.random.RandomState(0)
    rel_r, rel_c = pvit.relative_index_2d(gh, gw, 2, cls)
    n = rel_r.shape[0]
    mod = pvit.ElasticRelativePosition2D(max_dist=2, head_dim=d).double()
    q = rng.randn(2, n, 3, d)
    logits = rng.randn(2, 3, n, n)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tr, tc = mod.rel_rows.detach().numpy(), mod.rel_cols.detach().numpy()
    emb = tr[rel_r] + tc[rel_c]                       # [n, n, d]
    index = tuple(torch.from_numpy(g) for g in pvit.relative_groups(
        gh, gw, 2, cls)) + (gh, gw, cls)
    scores = mod.scores(torch.from_numpy(q), index).detach().numpy()
    values = mod.values(torch.from_numpy(attn), index).detach().numpy()
    np.testing.assert_allclose(scores, np.einsum("bnhd,nmd->bhnm", q, emb),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(values, np.einsum("bhij,ijd->bihd", attn, emb),
                               rtol=0, atol=1e-12)
    jmod = jvit.ElasticRelativePosition2D(max_dist=2, head_dim=d,
                                          dtype=jnp.float64)
    params = {"params": {"rel_rows": tr, "rel_cols": tc}}

    def run():
        jr, jc = jnp.asarray(rel_r), jnp.asarray(rel_c)
        return (jmod.apply(params, jnp.asarray(q), jr, jc),
                jmod.apply(params, jnp.asarray(attn), jr, jc,
                           method="value_contrib"))
    j_scores, j_values = jax_float64(run)
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-12)
    np.testing.assert_allclose(values, j_values, rtol=0, atol=1e-12)


def seeded_tree(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *args, **kw))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                            rng).astype(np.float32), shapes)


@pytest.mark.parametrize("cls", [True, False], ids=["cls", "no_cls"])
@pytest.mark.parametrize("meta", sorted(METAS))
def test_backbone_matches_jax(meta, cls):
    jcfg = rel_vit(True, cls, drop_rate=0.1)
    jbb = j_build_backbone(jcfg)
    max_arch = {"backbone": jbb.max_arch()}
    img = np.random.RandomState(3).randn(2, 32, 32, 3)
    variables = seeded_tree(jbb, jnp.zeros((1, 32, 32, 3)),
                            j_encode_arch(max_arch)["backbone"])
    assert set(variables["params"]["layer0"]["attn"]) >= {"rel_pos",
                                                         "rel_pos_v"}
    arch_j = j_encode_arch(max_arch, METAS[meta])["backbone"]
    j64 = j_build_backbone(_as_f64(jcfg))
    want = jax_float64(lambda: j64.apply(f64_tree(variables),
                                         jnp.asarray(img), arch_j))
    cfg = rel_vit(False, cls, drop_rate=0.1)
    arch = encode_arch(model_max_arch({"backbone": cfg}),
                       METAS[meta])["backbone"]
    emb = arch["embedding"]["width"]
    sd = vit_state_dict(variables["params"], prefix="",
                        rel_max_dist=MAX_DIST)
    for dtype, rtol in ((torch.float64, F64_RTOL), (torch.float32, RTOL)):
        bb = build_backbone(cfg).to(dtype).eval()     # pos_drop off
        bb.load_state_dict(sd, strict=True)
        got = bb(nchw(img).to(dtype), arch)
        for i, (g, w) in enumerate(zip(got, want)):
            close(g.detach().permute(0, 2, 3, 1).double().numpy(),
                  w[..., :emb], f"{meta} out {i} {dtype}", rtol)


def test_converter_maps_the_tables():
    """Each layer's ``rel_pos``/``rel_pos_v`` -> ``rel_pos_embed_k``/``_v``.
    JAX's tables have 2 * 14 + 2 rows whatever ``rel_max_dist`` (its
    ``ElasticEncoderLayer`` passes none to ``ElasticMHA``, ROADMAP C18)
    and its index reads the first 2 * 3 + 2; the port's tables are those
    rows."""
    jbb = j_build_backbone(rel_vit(True))
    variables = seeded_tree(jbb, jnp.zeros((1, 32, 32, 3)), j_encode_arch(
        {"backbone": jbb.max_arch()})["backbone"])
    p = variables["params"]
    assert p["layer0"]["attn"]["rel_pos"]["rel_rows"].shape == (30, 64)
    sd = vit_state_dict(p, rel_max_dist=MAX_DIST)
    rows = 2 * MAX_DIST + 2
    for i in range(4):
        for jname, pname in (("rel_pos", "rel_pos_embed_k"),
                             ("rel_pos_v", "rel_pos_embed_v")):
            for t in ("rel_rows", "rel_cols"):
                got = sd[f"backbone.blocks.{i}.attn.{pname}.{t}"]
                assert tuple(got.shape) == (rows, 64)
                assert np.array_equal(got.numpy(), p[f"layer{i}"]["attn"][
                    jname][t][:rows])
    port = build_backbone(rel_vit(False))
    assert {f"backbone.{k}" for k in port.state_dict()} == set(sd)


SEG_METAS = {"max": None, "sub": METAS["sub"]}


def rel_seg_cfg(jax_side: bool):
    cfg = vit_seg_cfg(jax_side)
    cfg["backbone"] = rel_vit(jax_side)
    cfg["fused_loss"] = False
    return cfg


@pytest.fixture(scope="module")
def segmentor():
    jcfg = rel_seg_cfg(True)
    jmodel = j_build_segmentor(jcfg)
    rng = np.random.RandomState(6)
    img = rng.randn(4, 32, 32, 3).astype(np.float32)
    gt = rng.randint(0, 5, (4, 32, 32)).astype(np.int32)
    gt[:, :3] = 255
    variables = seeded_tree(
        jmodel, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32), jnp.int32),
        j_encode_arch(j_model_max_arch(jcfg)), method="forward_train")
    refs = jax_forward_train_f64(jcfg, variables, list(SEG_METAS.values()),
                                 img, gt)
    return dict(variables=variables, img=img, gt=gt,
                refs=dict(zip(SEG_METAS, refs)))


@pytest.mark.parametrize("meta", sorted(SEG_METAS))
def test_segmentor_losses_and_grads_match_jax(segmentor, meta):
    ref = segmentor["refs"][meta]
    cfg = rel_seg_cfg(False)
    arch = encode_arch(model_max_arch(cfg), SEG_METAS[meta])
    want = variables_to_state_dict({"params": ref["grads"],
                                    "batch_stats": ref["stats"]}, cfg)
    assert "backbone.blocks.0.attn.rel_pos_embed_v.rel_cols" in want
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


def test_pos_drop_in_eval_and_in_training():
    """Eval mode: the backbone at ``drop_rate`` 0.1 equals it at 0. In
    training the tokens go through ``ops.dropout`` with the step's
    generator: about 90% of the token values kept, each scaled by 1/0.9;
    the same generator state draws the same mask; a train step with
    relative positions and dropout runs and moves the tables."""
    torch.manual_seed(0)
    cfg = rel_vit(False, drop_rate=0.1)
    bb = build_backbone(cfg).double()
    plain = build_backbone(dict(cfg, drop_rate=0.0)).double()
    plain.load_state_dict(bb.state_dict())
    arch = model_max_arch({"backbone": cfg})["backbone"]
    x = torch.randn(2, 3, 32, 32, dtype=torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(bb.eval()(x, arch),
                                                 plain.eval()(x, arch)))
    bb.train()
    a = bb(x, arch, torch.Generator().manual_seed(5))
    b = bb(x, arch, torch.Generator().manual_seed(5))
    c = bb(x, arch, torch.Generator().manual_seed(6))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[-1], c[-1])
    t = torch.rand(64, 65, 32, dtype=torch.float64) + 0.5
    y = dropout(t, 0.1, torch.Generator().manual_seed(1))
    ratio = y / t
    kept = ratio != 0
    assert torch.all((ratio[kept] - 1 / 0.9).abs() < 1e-12)
    share, count = float(kept.double().mean()), t.numel()
    assert abs(share - 0.9) <= 4 * (0.9 * 0.1 / count) ** 0.5

    seg = copy.deepcopy(rel_seg_cfg(False))
    seg["backbone"]["drop_rate"] = 0.1
    model = build_segmentor(seg).train()
    opt = optim.build_optimizer(model.parameters(),
                                dict(type="AdamW", lr=1e-3))
    table = model.backbone.blocks[1].attn.rel_pos_embed_k.rel_rows
    before = table.detach().clone()
    out = train_step(model, opt, torch.randn(2, 3, 32, 32),
                     torch.randint(0, 5, (2, 32, 32)),
                     encode_arch(model_max_arch(seg)),
                     torch.Generator().manual_seed(0), max_norm=1.0)
    assert torch.isfinite(out["loss"]) and not torch.equal(table, before)
