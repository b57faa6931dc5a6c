"""The port's SegFormer supernet (ElasticMixViT + SegFormerHead) against the
JAX package.

The tiny config of JAX's own test (``tests/test_backbones2.py``
``test_elastic_mixvit_segformer``: widths 8/16/24/32, depths 1/1/2/1, 1 head
of 32, SR ratios 4/2/2/1, FFN ratio 2.0, a head of 16 channels, 5 classes)
on 32x32 inputs, dropout off, and the same with 2 heads a stage. JAX
variables are seeded numpy arrays of the JAX model's shapes
(``tests/test_torch_deeplab.py`` ``seeded``), carried to the port by
``engine/convert.py``. The reference is the JAX model run in float64 (x64
on, the float32 casts of its layer, resize, loss, segmentor, MixViT and
SegFormer modules made float64 for the fixture's duration, the package
itself unchanged; JAX's softmax cast to float32 becomes float64 with
them): the port's float64 within 1e-6 (measured: the loss within 1e-15)
and its float32 within 1e-4 of each tensor's max|ref|.

- Backbone features, whole-mode logits, the CE loss and every gradient and
  BN statistic at MAX, at JAX's test subnet (widths 4/8/16/16, depths 1,
  FFN ratio 1.0) and, in the 2-head net, at an arch with 2 heads of 32 over
  widths of 8 (heads x 32 > width) and 1 head of 2 elsewhere.
- Two AdamW + clip steps (MAX, then the subnet) against JAX's
  ``make_train_step``, both in float64.
- A block past a stage's depth and the weights of an inactive head take no
  part; k's bias takes no gradient (the port leaves it out of the scores,
  which it cannot move).
- Both registry names of the backbone and the head build; ``count_flops``
  raises for the backbone in both packages (ROADMAP C10) and extraction
  raises ``NotImplementedError`` in the port (C16); calibration re-estimates
  only the head's ``fuse.bn``.
- ``chip_smoke.py``'s SegFormer cycle draws what JAX's sampler draws.
- The tiny supernet trains a sandwich cycle on the CPU and its slide eval
  equals the mean of its windows.
"""
import os

import gaiaseg_tpu.models.backbones.elastic_mixvit as j_mixvit_module
import gaiaseg_tpu.models.decode_heads.segformer_head as j_segformer_module
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.archspace.complexity import \
    get_model_complexity_info as j_complexity
from gaiaseg_tpu.engine import optim as joptim
from gaiaseg_tpu.engine.train import TrainState, make_train_step
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu_torch.archspace.complexity import get_model_complexity_info
from gaiaseg_tpu_torch.engine import calibrate_bn, optim
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.engine.extract import extract_subnet
from gaiaseg_tpu_torch.engine.train import train_segmentor, train_step
from gaiaseg_tpu_torch.models import (build_backbone, build_head,
                                      build_segmentor, encode_arch,
                                      model_max_arch)
from gaiaseg_tpu_torch.utils import Config
from test_torch_convnext import (ADAMW, F32_MODULES, _find, f64_tree,
                                 seeded_variables)
from test_torch_deeplab import _as_f64, _Float64Numpy, close, nchw

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
F64_RTOL = 1e-6
MIXVIT_F32_MODULES = F32_MODULES + (j_mixvit_module, j_segformer_module)
W, D, H, R = ("arch.backbone.body.width", "arch.backbone.body.depth",
              "arch.backbone.body.num_heads", "arch.backbone.body.ffn_ratio10")
# case: (heads of the net, meta)
CASES = {
    "max": ((1, 1, 1, 1), None),
    "sub": ((1, 1, 1, 1), {W: [4, 8, 16, 16], D: [1, 1, 1, 1],
                           H: [1, 1, 1, 1], R: [10, 10, 10, 10]}),
    "heads2": ((2, 2, 2, 2), {W: [8, 16, 16, 32], D: [1, 1, 2, 1],
                              H: [2, 1, 2, 1], R: [20, 10, 20, 20]}),
}


def model_cfg(jax_side: bool, heads=(1, 1, 1, 1)):
    cfg = dict(
        type="DynamicEncoderDecoder",
        backbone=dict(type="ElasticMixViT", widths=(8, 16, 24, 32),
                      depths=(1, 1, 2, 1), num_heads=tuple(heads),
                      sr_ratios=(4, 2, 2, 1), ffn_ratio10=20,
                      out_indices=(0, 1, 2, 3)),
        decode_head=dict(type="SegFormerHead", in_index=(0, 1, 2, 3),
                         input_transform="multiple_select", channels=16,
                         dropout_ratio=0.0, num_classes=5,
                         loss_decode=dict(type="CrossEntropyLoss")),
        test_cfg=dict(mode="whole"), fused_loss=False)
    if jax_side:
        cfg["backbone"]["dtype"] = cfg["decode_head"]["dtype"] = jnp.float32
    return cfg


def jax_float64(fn):
    """``fn()`` with x64 on and the float32 casts of the JAX modules on
    this path made float64; its result as numpy."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in MIXVIT_F32_MODULES:
            mp.setattr(mod, "jnp", _Float64Numpy())
        return jax.tree_util.tree_map(np.asarray, fn())


def close_grads(grads, want, what, dtype):
    """Each gradient within RTOL (float32) or F64_RTOL (float64) of its
    reference's max|ref|. A reference below 1e-12 of the largest gradient
    is zero in exact arithmetic (k's bias, the biases in front of the
    head's train-mode BN): the port's value there is rounding, held to
    1e-9 of the largest gradient in float64 and 1e-6 in float32 (8 float32
    ulps)."""
    rtol, zero = (F64_RTOL, 1e-9) if dtype == torch.float64 else (RTOL, 1e-6)
    top = max(float(np.abs(w.numpy()).max()) for k, w in want.items()
              if k in grads)
    for key, g in grads.items():
        g = np.zeros(want[key].shape) if g is None else g.double().numpy()
        ref = want[key].numpy()
        atol = zero * top if np.abs(ref).max() <= 1e-12 * top \
            else rtol * float(np.abs(ref).max())
        np.testing.assert_allclose(g, ref, rtol=0, atol=atol,
                                   err_msg=f"grad {key} {what}")


def port_model(variables, cfg, dtype=torch.float64):
    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(variables, cfg),
                          strict=True)
    return model.to(dtype)


@pytest.fixture(scope="module")
def supernet():
    """Per heads config: seeded variables; per case: JAX's float64
    features, whole logits, loss, gradients and new BN statistics."""
    rng = np.random.RandomState(3)
    img = rng.randn(2, 32, 32, 3)
    gt = rng.randint(0, 5, (2, 32, 32)).astype(np.int32)
    gt[:, :4] = 255
    nets = {}
    for heads in {h for h, _ in CASES.values()}:
        jcfg = model_cfg(True, heads)
        jmodel = j_build_segmentor(jcfg)
        nets[heads] = seeded_variables(
            jmodel, arch=j_encode_arch(j_model_max_arch(jcfg)),
            seed=sum(heads))
    refs = {}
    for name, (heads, meta) in CASES.items():
        jcfg = model_cfg(True, heads)
        variables = nets[heads]

        def run():
            jmodel = j_build_segmentor(_as_f64(jcfg))
            arch = j_encode_arch(j_model_max_arch(jcfg), meta)
            v = f64_tree(variables)
            x = jnp.asarray(img)

            def loss_fn(params):
                (total, _), mut = jmodel.apply(
                    {"params": params, "batch_stats": v["batch_stats"]}, x,
                    jnp.asarray(gt), arch, False,
                    method=jmodel.forward_train, mutable=["batch_stats"])
                return total, mut
            (loss, mut), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(v["params"])
            feats = jmodel.apply(v, x, arch, method=jmodel.extract_feat)
            return dict(loss=loss, grads=grads, stats=mut["batch_stats"],
                        feats=feats, logits=jmodel.apply(v, x, arch))
        refs[name] = jax_float64(run)
    return dict(nets=nets, refs=refs, img=img, gt=gt)


def _arch(name):
    heads, meta = CASES[name]
    return heads, meta, encode_arch(model_max_arch(model_cfg(False, heads)),
                                    meta)


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(CASES))
def test_features_and_logits_match_jax(supernet, name):
    heads, _, arch = _arch(name)
    ref = supernet["refs"][name]
    widths = arch["backbone"]["body"]["width"]
    cfg = model_cfg(False, heads)
    for dtype, rtol in ((torch.float64, F64_RTOL), (torch.float32, RTOL)):
        model = port_model(supernet["nets"][heads], cfg, dtype).eval()
        img = nchw(supernet["img"]).to(dtype)
        with torch.no_grad():
            feats = model.extract_feat(img, arch)
            logits = model.encode_decode(img, arch)
        assert len(feats) == len(ref["feats"]) == 4
        for i, (g, w) in enumerate(zip(feats, ref["feats"])):
            assert g.shape[1] == widths[i]
            assert not w[..., widths[i]:].any()
            close(g.permute(0, 2, 3, 1).double().numpy(),
                  w[..., :widths[i]], f"{name} stage {i} {dtype}", rtol)
        close(logits.permute(0, 2, 3, 1).double().numpy(), ref["logits"],
              f"{name} logits {dtype}", rtol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_grads_and_stats_match_jax(supernet, name):
    heads, _, arch = _arch(name)
    ref = supernet["refs"][name]
    cfg = model_cfg(False, heads)
    want = variables_to_state_dict({"params": ref["grads"],
                                    "batch_stats": ref["stats"]}, cfg)
    gt = torch.from_numpy(supernet["gt"])
    for dtype, rtol in ((torch.float64, F64_RTOL), (torch.float32, RTOL)):
        model = port_model(supernet["nets"][heads], cfg, dtype).train()
        total, logs = model.forward_train(nchw(supernet["img"]).to(dtype),
                                          gt, arch)
        assert set(logs) == {"decode.loss_seg"}
        total.backward()
        # k's bias moves no softmax: the port leaves it out of the scores
        assert all(getattr(model.backbone, f"stage{i}_block0").attn.k.bias
                   .grad is None for i in range(4))
        loss_j = float(ref["loss"])
        assert abs(float(total.detach()) - loss_j) <= rtol * abs(loss_j)
        close_grads({k: p.grad for k, p in model.named_parameters()},
                    want, f"{name} {dtype}", dtype)
        for key, buf in model.named_buffers():
            close(buf.double().numpy(), want[key].numpy(),
                  f"stat {key} {dtype}", rtol)


def test_two_adamw_clip_steps_match_jax(supernet):
    """AdamW + the global-norm clip at MAX, then at the subnet, float64 on
    both sides: parameters, BN statistics and both Adam moments within
    1e-6 of each tensor's max. Parameters whose gradient is zero in exact
    arithmetic (k's bias: one bias on every key moves no softmax, and the
    port leaves it out; the biases in front of the head's train-mode BN;
    q and k where the reduced map is one key, whose softmax is 1) take
    Adam steps of either sign from rounding: they move by at most 2 steps
    of lr, and
    their moments are not compared."""
    rng = np.random.RandomState(8)
    batches = [(rng.randn(2, 32, 32, 3), rng.randint(0, 5, (2, 32, 32))
                .astype(np.int32)) for _ in range(2)]
    metas = [CASES["max"][1], CASES["sub"][1]]
    clip = {"grad_clip": {"max_norm": 1.0}}
    variables = supernet["nets"][(1, 1, 1, 1)]
    jcfg = model_cfg(True)

    def run():
        jmodel = j_build_segmentor(_as_f64(jcfg))
        tx = joptim.build_optimizer(ADAMW, clip)
        v = f64_tree(variables)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"],
                           opt_state=tx.init(v["params"]))
        step = make_train_step(jmodel, tx, update_stats=True)
        norms = []
        for (img, gt), meta in zip(batches, metas):
            state, logs = step(state, jnp.asarray(img), jnp.asarray(gt),
                               j_encode_arch(j_model_max_arch(jcfg), meta),
                               jax.random.PRNGKey(0))
            norms.append(logs["grad_norm"])
        return (state.params, state.batch_stats, _find(state.opt_state, "mu"),
                _find(state.opt_state, "nu"), norms)
    params, stats, mu, nu, norms = jax_float64(run)

    cfg = model_cfg(False)
    model = port_model(variables, cfg).train()
    optimizer = optim.build_optimizer(model.parameters(), ADAMW)
    max_norm = optim.grad_clip_norm(clip)
    for (img, gt), meta, norm in zip(batches, metas, norms):
        out = train_step(model, optimizer, nchw(img).double(),
                         torch.from_numpy(gt),
                         encode_arch(model_max_arch(cfg), meta),
                         max_norm=max_norm)
        assert float(out["grad_norm"]) == pytest.approx(float(norm),
                                                        rel=F64_RTOL)
    assert max(norms) > max_norm, norms       # the clip engaged

    grads = variables_to_state_dict(
        {"params": supernet["refs"]["max"]["grads"],
         "batch_stats": supernet["refs"]["max"]["stats"]}, cfg)
    top = max(float(g.abs().max()) for g in grads.values())
    zeros = {k for k, _ in model.named_parameters()
             if float(grads[k].abs().max()) <= 1e-12 * top}
    one_key = ("backbone.stage2_", "backbone.stage3_")
    assert zeros and all(
        k.endswith("attn.k.bias") or k.startswith("decode_head.mlp")
        or k == "backbone.out_norm3.bias"
        or (k.startswith(one_key) and ".attn.q." in k or ".attn.k." in k)
        for k in zeros), sorted(zeros)
    want = variables_to_state_dict({"params": params,
                                    "batch_stats": stats}, cfg)
    start = variables_to_state_dict(variables, cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for key in want:
        if key in zeros:
            assert float((got[key] - start[key]).abs().max()) <= \
                2 * 1.01 * ADAMW["lr"], key
        else:
            close(got[key].numpy(), want[key].numpy(), key, F64_RTOL)
    for moment, torch_key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
        ref = variables_to_state_dict({"params": moment,
                                       "batch_stats": stats}, cfg)
        for key, p in model.named_parameters():
            if key not in zeros:
                close(optimizer.state[p][torch_key].numpy(),
                      ref[key].numpy(), f"{torch_key} {key}", F64_RTOL)


# --------------------------------------------------------------------- #
def test_inactive_blocks_and_heads_take_no_part():
    """New weights in the blocks past each stage's depth and in the rows
    of q, k, v (and columns of proj) past the active heads leave the
    subnet's outputs bit for bit; at MAX they change them."""
    cfg = model_cfg(False, (2, 2, 2, 2))
    torch.manual_seed(0)
    model = build_segmentor(cfg).double().eval()
    x = torch.randn(2, 3, 32, 32, dtype=torch.float64)
    _, _, sub = _arch("heads2")
    sub["backbone"]["body"]["num_heads"] = [1, 1, 1, 1]
    sub["backbone"]["body"]["depth"] = [1, 1, 1, 1]
    top = encode_arch(model_max_arch(cfg))
    with torch.no_grad():
        before_sub, before_top = model(x, sub), model(x, top)
        bb = model.backbone
        for i in range(4):
            for j in range(bb.depths[i]):
                block = getattr(bb, f"stage{i}_block{j}")
                if j >= sub["backbone"]["body"]["depth"][i]:
                    for p in block.parameters():
                        p.add_(torch.randn_like(p))
                    continue
                attn = block.attn
                for lin in (attn.q, attn.k, attn.v):
                    lin.weight[32:].add_(torch.randn_like(lin.weight[32:]))
                    lin.bias[32:].add_(1.0)
                attn.proj.weight[:, 32:].add_(1.0)
        assert torch.equal(before_sub, model(x, sub))
        assert not torch.allclose(before_top, model(x, top))


@pytest.mark.parametrize("backbone,head", [
    ("ElasticMixViT", "SegFormerHead"), ("ElasticSegFormer", "SegformerHead")])
def test_both_registry_names_build(backbone, head):
    cfg = model_cfg(False)
    bb = build_backbone(dict(cfg["backbone"], type=backbone))
    assert bb.out_channels() == (8, 16, 24, 32)
    dh = build_head(dict(cfg["decode_head"], type=head), bb.out_channels())
    assert [type(m).__name__ for m in (bb, dh)] == ["ElasticMixViT",
                                                    "SegFormerHead"]
    assert dh.in_channels == [8, 16, 24, 32]
    assert [tuple(getattr(dh, f"mlp{i}").weight.shape) for i in range(4)] \
        == [(16, 8), (16, 16), (16, 24), (16, 32)]
    assert model_max_arch(dict(cfg, backbone=dict(
        cfg["backbone"], type=backbone))) == {"backbone": {"body": {
            "width": [8, 16, 24, 32], "depth": [1, 1, 2, 1],
            "num_heads": [1, 1, 1, 1], "ffn_ratio10": [20, 20, 20, 20]}}}


def test_converter_names_every_port_tensor(supernet):
    """The converted state dict holds exactly the port's keys (JAX's names
    in PyTorch form) at the port's shapes."""
    cfg = model_cfg(False, (2, 2, 2, 2))
    sd = variables_to_state_dict(supernet["nets"][(2, 2, 2, 2)], cfg)
    model = build_segmentor(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    for key in ("backbone.patch0.weight", "backbone.patch_norm3.bias",
                "backbone.stage2_block1.attn.sr_norm.weight",
                "backbone.stage0_block0.ffn.dwconv.bias",
                "backbone.out_norm0.weight", "decode_head.mlp3.weight",
                "decode_head.fuse.bn.running_var",
                "decode_head.conv_seg.weight"):
        assert key in want, key
    assert want["backbone.stage0_block0.attn.q.weight"] == (64, 8)
    assert want["backbone.stage0_block0.attn.sr.weight"] == (8, 8, 4, 4)
    assert want["backbone.stage0_block0.ffn.dwconv.weight"] == (16, 1, 3, 3)
    assert "backbone.stage3_block0.attn.sr.weight" not in want


def test_flops_raise_and_extraction_raises():
    """ROADMAP C10: neither FLOPs counter has a MixViT entry; C16: the
    port's extraction raises for any backbone but DynamicResNet."""
    cfg = model_cfg(False)
    arch = encode_arch(model_max_arch(cfg))
    for counter in (get_model_complexity_info, j_complexity):
        with pytest.raises(NotImplementedError, match="ElasticMixViT"):
            counter(cfg, arch, (3, 64, 64))
    model = build_segmentor(cfg)
    with pytest.raises(NotImplementedError, match="ElasticMixViT"):
        extract_subnet(cfg, model.state_dict(), CASES["sub"][1])


def test_calibration_changes_only_the_fuse_bn():
    from gaiaseg_tpu_torch.data import SyntheticDataset
    cfg = model_cfg(False)
    torch.manual_seed(0)
    model = build_segmentor(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ds = SyntheticDataset(length=4, size=(32, 32), num_classes=5, seed=1)
    calibrate_bn(model, ds, encode_arch(model_max_arch(cfg)), num_batches=2)
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])}
    assert moved == {"decode_head.fuse.bn.running_mean",
                     "decode_head.fuse.bn.running_var"}


def test_chip_smoke_sampler_and_archs_match_jax():
    """The SegFormer cycle ``chip_smoke.py`` trains (the config's own
    sampler) draws what JAX's sampler draws, every draw encodes to JAX's
    nested arch at full width, and the full-width port has JAX's
    parameters (24.73 M)."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    from gaiaseg_tpu.archspace.samplers import \
        build_model_sampler as j_build_model_sampler
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    cfg = chip_smoke._segformer_cfg()
    assert cfg["data"]["train"]["size"] == [1024, 2048]
    assert cfg["model"]["test_cfg"] == {"mode": "slide",
                                        "crop_size": (1024, 1024),
                                        "stride": (768, 768)}
    port, ref = build_model_sampler(cfg["train_sampler"]), \
        j_build_model_sampler(cfg["train_sampler"])
    model = cfg.to_dict()["model"]
    port_max, j_max = model_max_arch(model), j_model_max_arch(model)
    assert port_max == jax.tree_util.tree_map(int, j_max)
    draws = [port.sample() for _ in range(8)]
    assert draws == [ref.sample() for _ in range(8)]
    assert [d.get("name") for d in draws[:4]] == ["MAX", "MIN", None, None]
    for d in draws:
        want = jax.tree_util.tree_map(
            lambda v: np.asarray(v).tolist(), j_encode_arch(j_max, d))
        assert encode_arch(port_max, d) == want, d
    with torch.device("meta"):
        seg = build_segmentor(model)
    n = sum(p.numel() for p in seg.parameters())
    jmodel = j_build_segmentor(model)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, 64, 3)),
        j_encode_arch(j_max)))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        shapes["params"])) == 24_726_995


def test_tiny_supernet_trains_a_cycle_and_slides():
    """The config's sandwich cycle shape (MAX, MIN, 2 random) on the tiny
    net: ``train_segmentor`` on the CPU gives finite losses; in float64
    the slide logits over 3 windows (a float32 canvas) equal each window's
    whole logits averaged over their cover."""
    cfg = Config(dict(
        model=dict(model_cfg(False), fused_loss=None,
                   test_cfg=dict(mode="slide", crop_size=(32, 32),
                                 stride=(24, 24))),
        train_sampler=dict(type="concat", model_samplers=[
            dict(type="anchor", anchors=[
                dict(name="MAX", **{W: [8, 16, 24, 32], D: [1, 1, 2, 1]}),
                dict(name="MIN", **{W: [4, 8, 16, 16], D: [1, 1, 1, 1]})]),
            dict(type="repeat", times=2, model_sampler=dict(
                type="composite", model_samplers=[
                    dict(type="range", key=W, start=[4, 8, 16, 16],
                         end=[8, 16, 24, 32], step=[4, 8, 8, 16]),
                    dict(type="range", key=D, start=[1, 1, 1, 1],
                         end=[1, 1, 2, 1], step=[1, 1, 1, 1])]))]),
        data=dict(samples_per_gpu=2, train=dict(
            type="SyntheticDataset", size=[32, 32], length=8, num_classes=5,
            seed=0)),
        optimizer=dict(type="AdamW", lr=6e-5, weight_decay=0.01),
        optimizer_config=dict(grad_clip=dict(max_norm=1.0)),
        lr_config=dict(policy="poly", power=1.0, min_lr=0.0, by_epoch=False),
        log_config=dict(interval=1)))
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"])
    history = train_segmentor(model, cfg, device="cpu", max_iters=4,
                              seed=0)[1]["loss"]
    assert [r["arch"] for r in history] == ["MAX", "MIN", "random", "random"]
    assert all(np.isfinite(r["loss"]) for r in history)
    model.double().eval()
    img = torch.randn(1, 3, 32, 80, dtype=torch.float64)
    arch = encode_arch(model_max_arch(cfg["model"]))
    with torch.no_grad():
        got = model.slide_inference(img, arch, (32, 32), (24, 24))
        canvas = torch.zeros(1, 5, 32, 80, dtype=torch.float64)
        count = torch.zeros(1, 1, 32, 80, dtype=torch.float64)
        for x0 in (0, 24, 48):
            canvas[..., x0:x0 + 32] += model.whole_inference(
                img[..., x0:x0 + 32], arch)
            count[..., x0:x0 + 32] += 1
    torch.testing.assert_close(got.double(), canvas / count, rtol=1e-6,
                               atol=1e-7)
