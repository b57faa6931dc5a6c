"""The port's DynamicConvNeXt supernet against the JAX package.

The tiny config of the repo (``configs/tests/tiny_convnext_uper.py``: dims
8/16/24/32, depths 2/2/3/2, a UPer head of 16 and an FCN aux head of 8, 5
classes, 32x32 crops) with stochastic depth and head dropout off for the
comparisons. JAX variables are seeded numpy arrays of the JAX model's
shapes (``tests/test_torch_deeplab.py`` ``seeded``: the layer scales
``gamma`` random at 0.1, not 1e-6, so the blocks matter), carried to the
port by ``engine/convert.py``. The reference is the JAX model run in
float64 (x64 on, the float32 casts of its layer, resize, loss and
segmentor modules made float64 for the fixture's duration, the package
itself unchanged): the port's float64 within 1e-6 and its float32 within
1e-4 of each tensor's max|ref|.

- A block and the backbone at MAX and at two sub archs (the MIN, and one of
  mixed widths below each stage's depth); a block past a stage's depth
  passes ``x`` on; the tanh GELU (flax's ``nn.gelu``).
- ``drop_path``: the identity at rate 0 and in eval mode (as JAX's), and at
  rate 0.3 each sample kept with the binomial share and scaled by 1/keep.
- The segmentor's losses and every gradient through the unfused loss at MAX
  and at both sub archs; three AdamW + clip steps against JAX's
  ``make_train_step``, both sides in float64.
- ``tools/train_supernet.py`` on the config (8 iterations, its eval and
  checkpoint), resume; calibration leaves the backbone (no BN) alone.
- FLOPs and parameters equal JAX's counter; the port module at MAX and a
  static sub net has the counter's parameters plus the layer scales,
  which the counter leaves out (ROADMAP C17).
- ROADMAP C16: JAX's ``extract_subnet`` returns the MAX net for the sub
  arch; the port's raises.
- The sandwich cycles ``chip_smoke.py`` trains draw what JAX's samplers
  draw, and encode to JAX's archs.
"""
import copy
import os

import gaiaseg_tpu.models.backbones.dynamic_convnext as j_convnext_module
import gaiaseg_tpu.models.backbones.elastic_transformer as j_vit_module
import gaiaseg_tpu.models.losses.cross_entropy as j_ce_module
import gaiaseg_tpu.models.segmentors.encoder_decoder as j_ed_module
import gaiaseg_tpu.ops.dynamic_layers as j_layers_module
import gaiaseg_tpu.ops.resize as j_resize_module
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gaiaseg_tpu.archspace.complexity import \
    get_model_complexity_info as j_complexity
from gaiaseg_tpu.engine import optim as joptim
from gaiaseg_tpu.engine.extract import extract_subnet as j_extract_subnet
from gaiaseg_tpu.engine.train import TrainState, make_train_step
from gaiaseg_tpu.models import build_backbone as j_build_backbone
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.models.backbones.dynamic_convnext import \
    DynamicConvNeXtBlock as JBlock
from gaiaseg_tpu.models.backbones.dynamic_convnext import \
    drop_path as j_drop_path
from gaiaseg_tpu_torch.archspace.complexity import get_model_complexity_info
from gaiaseg_tpu_torch.engine import (calibrate_bn, load_checkpoint, optim,
                                      save_checkpoint)
from gaiaseg_tpu_torch.engine.convert import (convnext_state_dict,
                                              variables_to_state_dict)
from gaiaseg_tpu_torch.engine.extract import extract_subnet
from gaiaseg_tpu_torch.engine.train import train_step
from gaiaseg_tpu_torch.models import (build_backbone, build_segmentor,
                                      encode_arch, model_max_arch)
from gaiaseg_tpu_torch.models.backbones.dynamic_convnext import \
    DynamicConvNeXtBlock
from gaiaseg_tpu_torch.ops.dropout import drop_path
from gaiaseg_tpu_torch.tools import train_supernet
from gaiaseg_tpu_torch.utils import Config
from test_torch_deeplab import _as_f64, _Float64Numpy, close, nchw, seeded

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tests", "tiny_convnext_uper.py")
LOSS_RTOL = 1e-5
RTOL = 1e-4
F64_RTOL = 1e-6
# every JAX module on these paths that casts to float32
F32_MODULES = (j_layers_module, j_resize_module, j_ce_module, j_ed_module,
               j_vit_module, j_convnext_module)

METAS = {
    "max": None,
    "min": {"arch.backbone.body.width": [4, 8, 16, 16],
            "arch.backbone.body.depth": [1, 1, 2, 1]},
    "mixed": {"arch.backbone.body.width": [8, 8, 24, 16],
              "arch.backbone.body.depth": [2, 1, 3, 1]},
}


def model_cfg(jax_side: bool, dtype=jnp.float32):
    """The tiny config's model, stochastic depth and dropout off."""
    cfg = copy.deepcopy(Config.fromfile(TINY)["model"])
    cfg["backbone"]["drop_path_rate"] = 0.0
    cfg["fused_loss"] = False
    for part in (cfg["backbone"], cfg["decode_head"], cfg["auxiliary_head"]):
        if part is not cfg["backbone"]:
            part["dropout_ratio"] = 0.0
        if jax_side:
            part["dtype"] = dtype
    return cfg


def seeded_variables(jmodel, hw=32, seed=0, arch=None):
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, hw, hw, 3)),
        jnp.zeros((1, hw, hw), jnp.int32), arch, method="forward_train"))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                            rng).astype(np.float32), shapes)


def f64_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def jax_float64(fn):
    """Run ``fn()`` with x64 on and every float32 cast of the JAX path
    modules made float64; returns its result as numpy."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in F32_MODULES:
            mp.setattr(mod, "jnp", _Float64Numpy())
        return jax.tree_util.tree_map(np.asarray, fn())


def jax_forward_train_f64(jcfg, variables, metas, img, gt):
    """JAX float64 ``forward_train``: for each meta (loss, log dict,
    gradients, new BN statistics)."""
    def run():
        jmodel = j_build_segmentor(_as_f64(jcfg))
        max_arch = j_model_max_arch(jcfg)
        k = jax.random.PRNGKey(0)

        def loss_fn(params, stats, arch):
            (total, logs), mut = jmodel.apply(
                {"params": params, "batch_stats": stats}, jnp.asarray(img),
                jnp.asarray(gt), arch, False, method=jmodel.forward_train,
                mutable=["batch_stats"], rngs={"dropout": k})
            return total, (logs, mut)
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        v = f64_tree(variables)
        out = []
        for meta in metas:
            (total, (logs, mut)), grads = vg(
                v["params"], v["batch_stats"], j_encode_arch(max_arch, meta))
            out.append(dict(loss=total, logs=logs, grads=grads,
                            stats=mut["batch_stats"]))
        return out
    return jax_float64(run)


def close_grads(grads, want, what, rtol):
    """Each gradient within ``rtol`` of its reference's max|ref|. A
    reference below 1e-12 of the largest is zero in exact arithmetic (an
    out-norm's bias feeding a 1x1 conv and a train-mode BN): its port value
    is held to ``rtol`` of 1e-3 of the largest gradient instead."""
    top = max(float(np.abs(w.numpy()).max()) for k, w in want.items()
              if k in grads)
    for key, g in grads.items():
        g = np.zeros(want[key].shape) if g is None else g.double().numpy()
        ref = want[key].numpy()
        floor = 1e-3 * top if np.abs(ref).max() <= 1e-12 * top else 0.0
        np.testing.assert_allclose(
            g, ref, rtol=0, atol=rtol * max(float(np.abs(ref).max()), floor),
            err_msg=f"grad {key} {what}")


def port_model(variables, cfg, dtype=torch.float32):
    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(variables, cfg),
                          strict=True)
    return model.to(dtype)


@pytest.fixture(scope="module")
def supernet():
    jcfg = model_cfg(True)
    jmodel = j_build_segmentor(jcfg)
    arch = j_encode_arch(j_model_max_arch(jcfg))
    variables = seeded_variables(jmodel, arch=arch)
    rng = np.random.RandomState(3)
    img = rng.randn(4, 32, 32, 3).astype(np.float32)
    gt = rng.randint(0, 5, (4, 32, 32)).astype(np.int32)
    gt[:, :4] = 255
    refs = jax_forward_train_f64(jcfg, variables, list(METAS.values()),
                                 img, gt)
    return dict(jcfg=jcfg, jmodel=jmodel, variables=variables, img=img,
                gt=gt, refs=dict(zip(METAS, refs)))


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("width", [8, 5], ids=["max", "sliced"])
def test_block_matches_jax(width):
    """One block (dim 8) on a seeded map, the active channels sliced for
    the port and zero-padded for JAX."""
    dim = 8
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 9, dim)
    x[..., width:] = 0.0
    jblock = JBlock(dim, dtype=jnp.float64)
    shapes = jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 9, 9, dim)), dim))
    srng = np.random.RandomState(2)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                            srng), shapes)

    def run():
        return jblock.apply(params, jnp.asarray(x), width)
    full = jax_float64(run)
    want = full[..., :width]
    assert not full[..., width:].any()
    sd = convnext_state_dict(params["params"], prefix="")
    for dtype, rtol in ((torch.float64, F64_RTOL), (torch.float32, RTOL)):
        block = DynamicConvNeXtBlock(dim).to(dtype)
        block.load_state_dict(sd, strict=True)
        got = block(nchw(x[..., :width]).to(dtype))
        close(got.detach().permute(0, 2, 3, 1).double().numpy(), want,
              f"block {dtype}", rtol)


@pytest.mark.parametrize("meta", sorted(METAS))
def test_backbone_matches_jax(supernet, meta):
    jcfg = model_cfg(True)
    bb_cfg = dict(jcfg["backbone"])
    jbb = j_build_backbone(_as_f64(bb_cfg))
    arch = j_encode_arch(j_model_max_arch(jcfg), METAS[meta])
    params = {"params": supernet["variables"]["params"]["backbone_m"]}
    img = supernet["img"]
    outs = jax_float64(lambda: jbb.apply(f64_tree(params), jnp.asarray(img),
                                         arch["backbone"]))
    widths = arch["backbone"]["body"]["width"]
    cfg = model_cfg(False)
    parch = encode_arch(model_max_arch(cfg), METAS[meta])["backbone"]
    sd = convnext_state_dict(params["params"], prefix="")
    for dtype, rtol in ((torch.float64, F64_RTOL), (torch.float32, RTOL)):
        bb = build_backbone(cfg["backbone"]).to(dtype)
        bb.load_state_dict(sd, strict=True)
        got = bb(nchw(img).to(dtype), parch)
        assert len(got) == len(outs) == 4
        for i, (g, w) in enumerate(zip(got, outs)):
            wd = int(widths[i])
            assert g.shape[1] == wd
            assert not w[..., wd:].any()
            close(g.detach().permute(0, 2, 3, 1).double().numpy(),
                  w[..., :wd], f"{meta} out {i} {dtype}", rtol)


def test_blocks_past_the_depth_pass_x_on():
    """Blocks past a stage's active depth take no part: new weights there
    leave the outputs as they were, at MAX depth they change them."""
    cfg = model_cfg(False)
    torch.manual_seed(0)
    bb = build_backbone(cfg["backbone"]).double()
    x = torch.randn(2, 3, 32, 32, dtype=torch.float64)
    sub = encode_arch(model_max_arch(cfg), METAS["min"])["backbone"]
    top = encode_arch(model_max_arch(cfg))["backbone"]
    before_sub, before_top = bb(x, sub), bb(x, top)
    with torch.no_grad():
        for i, stage in enumerate(bb.stages):
            for block in stage[sub["body"]["depth"][i]:]:
                for p in block.parameters():
                    p.add_(torch.randn_like(p))
    for a, b in zip(before_sub, bb(x, sub)):
        assert torch.equal(a, b)
    assert not any(torch.allclose(a, b)
                   for a, b in zip(before_top, bb(x, top)))


def test_block_gelu_is_flax_tanh_form():
    """flax's ``nn.gelu`` (the block's, JAX ``dynamic_convnext.py:56``) is
    the tanh form; it is 4.7e-4 from the exact one, far above the float64
    tolerance the block is held to."""
    from flax import linen as nn
    x = np.linspace(-6.0, 6.0, 24001)
    with jax.enable_x64(True):
        flax_gelu = np.asarray(nn.gelu(jnp.asarray(x)))
    t = torch.from_numpy(x)
    tanh = F.gelu(t, approximate="tanh").numpy()
    exact = F.gelu(t).numpy()
    assert np.abs(flax_gelu - tanh).max() <= 1e-12
    gap = np.abs(tanh - exact).max()
    assert 4e-4 < gap < 5e-4


def test_drop_path_identity_at_rate_0_and_in_eval():
    x = np.random.RandomState(0).randn(6, 4, 3, 3).astype(np.float32)
    want = np.asarray(j_drop_path(jnp.asarray(x), 0.0,
                                  jax.random.PRNGKey(0), True))
    t = torch.from_numpy(x)
    g = torch.Generator().manual_seed(0)
    assert np.array_equal(drop_path(t, 0.0, g, True).numpy(), want)
    assert np.array_equal(drop_path(t, 0.3, g, False).numpy(), x)
    assert np.array_equal(np.asarray(j_drop_path(
        jnp.asarray(x), 0.3, jax.random.PRNGKey(0), False)), x)
    block = DynamicConvNeXtBlock(4, dp_rate=0.3).double().eval()
    y = torch.randn(3, 4, 9, 9, dtype=torch.float64)
    assert torch.equal(block(y, g), block(y))


def test_drop_path_keeps_a_sample_with_its_share_and_scale():
    """Rate 0.3 over 4,000 samples: the kept share within 4 binomial
    standard deviations of 0.7 (JAX's ``bernoulli(keep)``), each kept
    sample scaled by exactly 1/0.7 as a whole, each dropped one all zero;
    the same generator state draws the same samples."""
    rate, n = 0.3, 4000
    x = torch.rand(n, 2, 3, 3, dtype=torch.float64) + 0.5
    y = drop_path(x, rate, torch.Generator().manual_seed(1), True)
    ratio = (y / x).reshape(n, -1)
    kept = ratio[:, 0] != 0
    assert torch.all((ratio == 0).all(1) | (ratio - 1 / 0.7).abs().lt(
        1e-12).all(1))
    share = float(kept.double().mean())
    assert abs(share - 0.7) <= 4 * (0.7 * 0.3 / n) ** 0.5
    again = drop_path(x, rate, torch.Generator().manual_seed(1), True)
    assert torch.equal(y, again)


@pytest.mark.parametrize("meta", sorted(METAS))
def test_forward_train_losses_and_grads_match_jax(supernet, meta):
    ref = supernet["refs"][meta]
    cfg = model_cfg(False)
    arch = encode_arch(model_max_arch(cfg), METAS[meta])
    gt = torch.from_numpy(supernet["gt"])
    want = variables_to_state_dict({"params": ref["grads"],
                                    "batch_stats": ref["stats"]}, cfg)
    for dtype, rtol, lrtol in ((torch.float64, F64_RTOL, F64_RTOL),
                               (torch.float32, RTOL, LOSS_RTOL)):
        model = port_model(supernet["variables"], cfg, dtype).train()
        total, logs = model.forward_train(nchw(supernet["img"]).to(dtype),
                                          gt, arch)
        total.backward()
        for k in ("decode.loss_seg", "aux_0.loss_seg"):
            want_k = float(ref["logs"][k])
            assert abs(float(logs[k].detach()) - want_k) <= \
                lrtol * abs(want_k), k
        assert abs(float(total.detach()) - float(ref["loss"])) <= \
            lrtol * abs(float(ref["loss"]))
        close_grads({k: p.grad for k, p in model.named_parameters()},
                    want, dtype, rtol)
        for key, buf in model.named_buffers():
            close(buf.double().numpy(), want[key].numpy(),
                  f"stat {key} {dtype}", rtol)


ADAMW = dict(type="AdamW", lr=1e-3, weight_decay=0.01)


def _find(opt_state, field):
    if hasattr(opt_state, field):
        return getattr(opt_state, field)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            t = _find(s, field)
            if t is not None:
                return t
    return None


def test_three_adamw_clip_steps_match_jax(supernet):
    """MAX, MIN and a mixed arch, AdamW + the global-norm clip (the
    config's optimizer, at a max_norm the first step's gradient does not
    reach and the others exceed), in float64 on both sides (JAX's float32
    train-mode BN, ROADMAP C3, leaves its own float64 steps by the second
    step here): parameters, BN statistics and both Adam
    moments within 1e-6 of each tensor's max. The out-norm biases whose
    gradient is zero in exact arithmetic (``close_grads``) take Adam steps
    of either sign from rounding; they move by at most 3 steps of lr, and
    their moments are not compared."""
    rng = np.random.RandomState(8)
    batches = [(rng.randn(2, 32, 32, 3), rng.randint(0, 5, (2, 32, 32))
                .astype(np.int32)) for _ in range(3)]
    metas = [METAS["max"], METAS["min"], METAS["mixed"]]
    clip = {"grad_clip": {"max_norm": 5.0}}
    variables = supernet["variables"]
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
        max_arch = j_model_max_arch(jcfg)
        for (img, gt), meta in zip(batches, metas):
            state, logs = step(state, jnp.asarray(img), jnp.asarray(gt),
                               j_encode_arch(max_arch, meta),
                               jax.random.PRNGKey(0))
            norms.append(logs["grad_norm"])
        return (state.params, state.batch_stats, _find(state.opt_state, "mu"),
                _find(state.opt_state, "nu"), norms)
    params, stats, mu, nu, norms = jax_float64(run)

    cfg = model_cfg(False)
    model = port_model(variables, cfg, torch.float64).train()
    optimizer = optim.build_optimizer(model.parameters(), ADAMW)
    max_norm = optim.grad_clip_norm(clip)
    port_max = model_max_arch(cfg)
    for (img, gt), meta, norm in zip(batches, metas, norms):
        out = train_step(model, optimizer, nchw(img).double(),
                         torch.from_numpy(gt), encode_arch(port_max, meta),
                         max_norm=max_norm)
        assert float(out["grad_norm"]) == pytest.approx(float(norm),
                                                        rel=F64_RTOL)
    assert norms[0] < max_norm < min(norms[1:]), norms

    grads = variables_to_state_dict(
        {"params": supernet["refs"]["max"]["grads"],
         "batch_stats": supernet["refs"]["max"]["stats"]}, cfg)
    top = max(float(g.abs().max()) for g in grads.values())
    zeros = {k for k, _ in model.named_parameters()
             if float(grads[k].abs().max()) <= 1e-12 * top}
    assert zeros and all(k.startswith("backbone.norm") for k in zeros)
    want = variables_to_state_dict({"params": params,
                                    "batch_stats": stats}, cfg)
    start = variables_to_state_dict(variables, cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for key in want:
        if key in zeros:
            assert float((got[key] - start[key]).abs().max()) <= \
                3 * 1.01 * ADAMW["lr"], key
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
def test_cli_trains_the_tiny_config_and_resumes(tmp_path):
    """8 iterations with drop path 0.1 and head dropout (AdamW + clip 5,
    poly LR), the eval at 8 and the checkpoint; then 2 more resumed from
    it (the run's last checkpoint at 10)."""
    wd = str(tmp_path / "wd")
    history = train_supernet.main([TINY, "--device", "cpu", "--work-dir",
                                   wd])
    assert [r["iter"] for r in history["loss"]] == [4, 8]
    assert all(np.isfinite(r["loss"]) for r in history["loss"])
    assert [e["iter"] for e in history["eval"]] == [8]
    assert 0.0 <= history["eval"][0]["metrics"]["MAX"]["mIoU"] <= 1.0
    raw = torch.load(os.path.join(wd, "iter_8.pth"), map_location="cpu",
                     weights_only=False)
    assert raw["meta"]["iter"] == 8
    assert raw["meta"]["max_arch"] == {"backbone": {"body": {
        "width": [8, 16, 24, 32], "depth": [2, 2, 3, 2]}}}
    assert "backbone.stages.2.2.gamma" in raw["state_dict"]
    more = train_supernet.main([TINY, "--device", "cpu", "--work-dir", wd,
                                "--max-iters", "10", "--resume-from",
                                os.path.join(wd, "iter_8.pth")])
    assert more["loss"] == []       # no log boundary in iterations 9-10
    raw = torch.load(os.path.join(wd, "iter_10.pth"), map_location="cpu",
                     weights_only=False)
    assert raw["meta"]["iter"] == 10


def test_checkpoint_round_trip_and_calibration(tmp_path):
    """A supernet and its AdamW state round-trip through a ``.pth``;
    calibration re-estimates the heads' BN and leaves the BN-free backbone
    as it was."""
    from gaiaseg_tpu_torch.data import SyntheticDataset
    cfg = Config.fromfile(TINY)
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"]).train()
    opt = optim.build_optimizer(model.parameters(), ADAMW)
    arch = encode_arch(model_max_arch(cfg["model"]))
    train_step(model, opt, torch.randn(2, 3, 32, 32),
               torch.randint(0, 5, (2, 32, 32)), arch,
               torch.Generator().manual_seed(0))
    path = str(tmp_path / "c.pth")
    save_checkpoint(path, model, opt, {"iter": 1})
    torch.manual_seed(1)
    fresh = build_segmentor(cfg["model"])
    fresh_opt = optim.build_optimizer(fresh.parameters(), ADAMW)
    assert load_checkpoint(path, fresh, fresh_opt)["iter"] == 1
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert str(opt.state_dict()) == str(fresh_opt.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ds = SyntheticDataset(length=4, size=(32, 32), num_classes=5, seed=1)
    calibrate_bn(model, ds, arch, num_batches=2)
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved and all(k.startswith("decode_head.")
                         or k.startswith("auxiliary_head.") for k in moved)
    assert all(k.endswith(("running_mean", "running_var")) for k in moved)
    empty = build_backbone(cfg["model"]["backbone"])
    assert calibrate_bn(empty, ds, {"body": arch["backbone"]["body"]},
                        num_batches=1) is empty


def test_flops_and_params_match_jax_counter():
    """The port's counter equals JAX's (``complexity.py:179``) at MAX and
    the sub archs, at 512x512. The port module at MAX, and a static net of
    a sub arch's widths and depths, has the counter's parameters plus the
    layer scales ``gamma`` (width x depth a stage), which the counter
    leaves out (ROADMAP C17; both counters keep JAX's number)."""
    cfg = Config.fromfile(TINY)["model"]
    max_arch = model_max_arch(cfg)
    for name, meta in METAS.items():
        arch = encode_arch(max_arch, meta)
        got = get_model_complexity_info(cfg, arch, (3, 512, 512))
        want = j_complexity(cfg, arch, (3, 512, 512))
        assert got == want, name
        sub = copy.deepcopy(cfg)
        sub["backbone"]["dims"] = arch["backbone"]["body"]["width"]
        sub["backbone"]["depths"] = arch["backbone"]["body"]["depth"]
        for head in (sub["decode_head"], sub["auxiliary_head"]):
            head.pop("in_channels", None)
        model = build_segmentor(sub)
        n = sum(p.numel() for p in model.parameters())
        gammas = sum(p.numel() for k, p in model.named_parameters()
                     if k.endswith(".gamma"))
        assert gammas == sum(w * d for w, d in zip(
            arch["backbone"]["body"]["width"],
            arch["backbone"]["body"]["depth"]))
        assert n == got["params"] + gammas, (name, n, got["params"])


def test_extraction_of_a_convnext_subnet(supernet):
    """ROADMAP C16: JAX's ``subnet_model_cfg`` writes ``body_width`` and
    ``body_depth``, which ``DynamicConvNeXt`` has no field for, so its
    extraction returns the supernet's 81,186 parameters for the MIN arch;
    the port raises, naming the backbone."""
    jcfg = dict(Config.fromfile(TINY)["model"], backbone=dict(
        Config.fromfile(TINY)["model"]["backbone"], dtype=jnp.float32))
    sub_cfg, sub_vars, _ = j_extract_subnet(jcfg, supernet["variables"],
                                            METAS["min"], img_size=(32, 32))
    n_sub = sum(np.size(a) for a in jax.tree_util.tree_leaves(
        sub_vars["params"]))
    n_sup = sum(np.size(a) for a in jax.tree_util.tree_leaves(
        supernet["variables"]["params"]))
    assert n_sub == n_sup == 81186
    assert "body_width" in sub_cfg["backbone"]
    cfg = Config.fromfile(TINY)["model"]
    model = build_segmentor(cfg)
    assert sum(p.numel() for p in model.parameters()) == 81186
    with pytest.raises(NotImplementedError, match="DynamicConvNeXt"):
        extract_subnet(cfg, model.state_dict(), METAS["min"])


@pytest.mark.parametrize("name", ["convnext", "conformer", "vit_relpos"])
def test_chip_smoke_samplers_and_archs_match_jax(name):
    """The sandwich cycles ``chip_smoke.py`` trains (its new ranges among
    them) draw what JAX's samplers draw from the same config, and every
    draw, dot-keyed, encodes to JAX's nested arch at full width."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    from gaiaseg_tpu.archspace.samplers import \
        build_model_sampler as j_build_model_sampler
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    cfg = getattr(chip_smoke, f"_{name}_cfg")()
    port, ref = build_model_sampler(cfg["train_sampler"]), \
        j_build_model_sampler(cfg["train_sampler"])
    model = cfg.to_dict()["model"]
    port_max, j_max = model_max_arch(model), j_model_max_arch(model)
    assert port_max == jax.tree_util.tree_map(int, j_max)
    draws = [port.sample() for _ in range(8)]
    assert draws == [ref.sample() for _ in range(8)]
    assert [d.get("name", "random") for d in draws[:4]] == (
        ["MAX", "MIN", "random", "random"] if name != "vit_relpos"
        else ["MAX", "MIN", "MAX", "MIN"])
    for d in draws:
        want = jax.tree_util.tree_map(
            lambda v: np.asarray(v).tolist(), j_encode_arch(j_max, d))
        assert encode_arch(port_max, d) == want, d
    with torch.device("meta"):
        seg = build_segmentor(model)
    n = sum(p.numel() for p in seg.parameters()) / 1e6
    assert round(n, 2) == {"convnext": 60.24, "conformer": 110.60,
                           "vit_relpos": 144.16}[name]
