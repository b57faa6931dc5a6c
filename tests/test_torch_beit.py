"""The port's BEiT teacher backbone and checkpoint surgery against the JAX
package.

- ``BEiT`` (per-block and shared relative-position tables, duplicate
  ``out_indices``, the four FPN adapters) on seeded JAX params carried by
  ``engine/convert.py``: the four maps within 1e-5 of each map's max|ref|
  of JAX's float32 module (a BEiT has no BN, so JAX's float32 is a
  reference here). The FPN's transposed convs (flax's kernel flipped in
  space), its tanh-GELU (the blocks' is exact) and the dropped k bias are
  each held on their own: the deconv to 1e-6, an erf GELU in ``fpn1``
  must miss JAX by more than 1e-4, and a JAX BEiT whose k bias is zeroed
  agrees with the random one within 1e-6 of max (float rounding).
- An official-layout BEiT ``.pth`` (``tests/test_vit_convert.py TBeit``)
  loads through the port's teacher loader as JAX's
  ``beit_state_dict_to_params`` loads it: every mapped entry equal to
  JAX's within 1e-6, tables resampled from the file's 4x4 window to the
  model's 8x8, the raw block-1 tokens within 2e-4 of the torch module's
  (JAX's own test's tolerance).
- Surgery: ``resample_rel_pos_bias_table`` and ``resize_pos_embed`` equal
  JAX's within 1e-6 of max; ``surgery_beit_checkpoint`` drops the stale
  index buffers.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from gaiaseg_tpu.engine import ckpt_surgery as j_surgery
from gaiaseg_tpu.engine.torch_convert import beit_state_dict_to_params
from gaiaseg_tpu.models import build_backbone as j_build_backbone
from gaiaseg_tpu_torch.engine import ckpt_surgery
from gaiaseg_tpu_torch.engine.convert import beit_state_dict, deconv_state
from gaiaseg_tpu_torch.models import build_backbone
from gaiaseg_tpu_torch.models.backbones import beit as beit_module

sys.path.insert(0, os.path.dirname(__file__))
from test_vit_convert import TBeit, _rand  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5
F32 = jnp.float32


def beit_cfg(shared: bool, jax_side: bool):
    cfg = dict(type="BEiT", embed_dim=32, depth=3, num_heads=2, patch_size=8,
               out_indices=(0, 2, 2, 1), use_rel_pos_bias=not shared,
               use_shared_rel_pos_bias=shared)
    if jax_side:
        cfg["dtype"] = F32
    else:
        cfg["img_size"] = 64
    return cfg


def seeded_params(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1]
        if name == "kernel":
            return rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*s.shape)
        if name.startswith("gamma"):
            return 0.5 + 0.1 * rng.randn(*s.shape)
        return 0.3 * rng.randn(*s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf([getattr(q, "key", q) for q in p], s)
        .astype(np.float32), shapes)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module", params=[False, True],
                ids=["per_block", "shared"])
def beit(request):
    shared = request.param
    jb = j_build_backbone(beit_cfg(shared, True))
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    params = seeded_params(shapes["params"], 1)
    run = jax.jit(lambda p: jb.apply({"params": p}, jnp.asarray(x)))
    ref = [np.asarray(o) for o in run(params)]
    model = build_backbone(beit_cfg(shared, False)).eval()
    model.load_state_dict(beit_state_dict(params, prefix=""), strict=True)
    return dict(shared=shared, x=x, params=params, ref=ref, run=run,
                model=model)


def port_maps(model, x):
    with torch.no_grad():
        return [o.permute(0, 2, 3, 1).numpy() for o in model(nchw(x))]


def close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def test_beit_maps_match_jax(beit):
    got = port_maps(beit["model"], beit["x"])
    shapes = [(2, 32, 32, 32), (2, 16, 16, 32), (2, 8, 8, 32), (2, 4, 4, 32)]
    assert [g.shape for g in got] == shapes
    for i, (g, r) in enumerate(zip(got, beit["ref"])):
        close(g, r, RTOL, f"map {i}")
    keys = set(beit["model"].state_dict())
    assert ("rel_pos_bias.relative_position_bias_table" in keys) \
        == beit["shared"]
    assert ("blocks.0.attn.relative_position_bias_table" in keys) \
        != beit["shared"]
    assert not any("relative_position_index" in k for k in keys)


def test_fpn1_gelu_is_tanh_and_erf_misses_jax(beit, monkeypatch):
    """flax ``nn.gelu`` is the tanh form; the exact one in ``fpn1`` misses
    JAX's first map by more than 1e-4 of its max."""
    gelu = beit["model"].fpn1[2]
    assert gelu.approximate == "tanh"
    monkeypatch.setattr(gelu, "approximate", "none")
    got = port_maps(beit["model"], beit["x"])[0]
    err = float(np.abs(got - beit["ref"][0]).max())
    assert err > 1e-4 * float(np.abs(beit["ref"][0]).max()), err


def test_dropped_k_bias_moves_nothing(beit):
    """q·b_k is the same for every key of a row, so softmax ignores it:
    JAX's BEiT with its k biases zeroed agrees with the random ones."""
    params = jax.tree_util.tree_map(np.array, beit["params"])
    for name, blk in params.items():
        if name.startswith("block"):
            d = blk["qkv"]["bias"].shape[0] // 3
            assert np.abs(blk["qkv"]["bias"][d:2 * d]).max() > 0.1
            blk["qkv"]["bias"][d:2 * d] = 0.0
    zeroed = beit["run"](params)
    for i, (z, r) in enumerate(zip(zeroed, beit["ref"])):
        close(np.asarray(z), r, 1e-6, f"map {i}")


def test_transposed_conv_is_flax_kernel_flipped():
    x = np.random.RandomState(0).randn(1, 4, 5, 3).astype(np.float32)
    deconv = fnn.ConvTranspose(6, (2, 2), (2, 2), dtype=F32)
    v = deconv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    p["bias"] = np.random.RandomState(2).randn(6).astype(np.float32)
    want = np.asarray(deconv.apply({"params": p}, jnp.asarray(x)))
    conv = torch.nn.ConvTranspose2d(3, 6, 2, 2)
    conv.load_state_dict(deconv_state(p))
    with torch.no_grad():
        got = conv(nchw(x)).permute(0, 2, 3, 1).numpy()
    close(got, want, 1e-6, "deconv")
    unflipped = p["kernel"].transpose(2, 3, 0, 1)
    assert not np.allclose(conv.weight.detach().numpy(), unflipped)


def test_official_beit_pth_loads_as_jax_loads_it(tmp_path):
    """A TBeit state dict (official layout: fused qkv weight, q/v biases,
    per-block tables of a 4x4 window) as a teacher segmentor's backbone,
    loaded into a BEiT of window 8."""
    from gaiaseg_tpu_torch.engine.teacher import load_teacher_checkpoint
    from gaiaseg_tpu_torch.models import build_segmentor
    tmodel = TBeit(dim=32, heads=2, depth=2, patch=4, grid=4).eval()
    _rand(tmodel)
    sd = {"backbone." + k: v for k, v in tmodel.state_dict().items()}
    path = str(tmp_path / "beit.pth")
    torch.save({"state_dict": sd}, path)
    cfg = dict(
        type="DynamicDistiller",
        backbone=dict(type="DynamicResNet", stem_width=8,
                      body_width=[8, 8, 8, 8], body_depth=[1, 1, 1, 1]),
        decode_head=dict(type="DynamicFCNHead", in_index=3, channels=8,
                         num_convs=1, concat_input=False, num_classes=4),
        teacher_backbone=dict(type="BEiT", embed_dim=32, depth=2,
                              num_heads=2, patch_size=4,
                              out_indices=(0, 0, 1, 1), img_size=32),
        distill_cfg=dict(pairwise_weight=0.5))
    model = build_segmentor(cfg).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    res = load_teacher_checkpoint(path, model)
    assert all(k.startswith("t_backbone.fpn") for k in res["kept_init"])
    for k in res["kept_init"]:
        assert torch.equal(model.state_dict()[k], before[k]), k

    jb = j_build_backbone(dict(type="BEiT", embed_dim=32, depth=2,
                               num_heads=2, patch_size=4,
                               out_indices=(0, 0, 1, 1), dtype=F32))
    x = np.random.RandomState(2).randn(1, 32, 32, 3).astype(np.float32)
    init = jax.tree_util.tree_map(np.asarray, jb.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = beit_state_dict(beit_state_dict_to_params(tmodel.state_dict(),
                                                     init), "t_backbone")
    got = model.state_dict()
    table = "t_backbone.blocks.0.attn.relative_position_bias_table"
    assert tuple(got[table].shape) == ((2 * 8 - 1) ** 2 + 3, 2)
    for k in res["loaded"]:
        close(got[k].numpy(), want[k].numpy(), 1e-6, k)

    # the raw block-1 tokens (map 2, fpn3) against the torch module, at
    # the file's own 4x4 window
    small = build_backbone(dict(cfg["teacher_backbone"], img_size=16)).eval()
    small.load_state_dict({k: v for k, v in tmodel.state_dict().items()},
                          strict=False)
    x16 = x[:, :16, :16]
    rel = torch.from_numpy(beit_module.relative_position_index(4, 4)
                           .astype(np.int64))
    with torch.no_grad():
        ref = tmodel(nchw(x16), rel).reshape(1, 4, 4, 32).numpy()
        f3 = small(nchw(x16))[2].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(f3, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("src,dst", [(4, 8), (14, 32), (8, 4)])
def test_resample_rel_pos_bias_table_matches_jax(src, dst):
    table = np.random.RandomState(src).randn((2 * src - 1) ** 2 + 3,
                                             3).astype(np.float32)
    got = ckpt_surgery.resample_rel_pos_bias_table(table, src, dst)
    want = j_surgery.resample_rel_pos_bias_table(table, src, dst)
    assert got.shape == want.shape == ((2 * dst - 1) ** 2 + 3, 3)
    close(got, want, 1e-6, "table")
    np.testing.assert_array_equal(got[-3:], table[-3:])
    assert ckpt_surgery.table_window(got.shape[0]) == dst


@pytest.mark.parametrize("src,dst", [((14, 14), (32, 32)), ((8, 8), (5, 7))])
def test_resize_pos_embed_matches_jax(src, dst):
    pos = np.random.RandomState(1).randn(1, src[0] * src[1] + 1,
                                         16).astype(np.float32)
    got = ckpt_surgery.resize_pos_embed(pos, src, dst)
    want = j_surgery.resize_pos_embed(pos, src, dst)
    assert got.shape == want.shape == (1, dst[0] * dst[1] + 1, 16)
    close(got, np.asarray(want), 1e-6, "pos_embed")


def test_surgery_beit_checkpoint_drops_index_and_resamples():
    tmodel = TBeit(dim=32, heads=2, depth=2, patch=4, grid=4)
    _rand(tmodel)
    sd = dict(tmodel.state_dict())
    sd["blocks.0.attn.relative_position_index"] = torch.zeros(17, 17)
    out = ckpt_surgery.surgery_beit_checkpoint(sd, 8)
    assert "blocks.0.attn.relative_position_index" not in out
    key = "blocks.1.attn.relative_position_bias_table"
    want = j_surgery.resample_rel_pos_bias_table(sd[key].numpy(), 4, 8)
    close(out[key].numpy(), want, 1e-6, key)
    assert out["cls_token"] is sd["cls_token"]
    same = ckpt_surgery.surgery_beit_checkpoint(sd, 4)
    assert same[key] is sd[key]
