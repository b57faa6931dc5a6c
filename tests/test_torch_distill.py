"""The port's distillation losses and DynamicDistiller against the JAX
package.

- ``distill_softened_ce`` (T 1 and 2) and ``pairwise_gram_loss`` (the whole
  maps; the 50% window at JAX's own draw from a key, passed as offsets; a
  3x3 map, where the window is skipped) within 1e-6 relative of JAX's; the
  port's own draw from a generator lands in range and equals the explicit
  offsets it drew. ``pixel_accuracy`` (top-1, top-2, a threshold) equal to
  JAX's.
- The distiller segmentor of ``tests/test_distiller.py:14-28`` (BEiT
  teacher + FCN teacher head) and ``:148-162`` (a DynamicResNet teacher at
  its MAX), at 64x64 so the student's top map is 2x2 and the pairwise loss
  is not 0, 8 zero-mean images: ``forward_train``'s losses, every student
  gradient and BN statistic at MAX and at a subnet against JAX run in
  float64 (x64, the float32 casts of its layer / resize / loss / segmentor
  / BEiT modules patched for the fixture, as ``tests/test_torch_deeplab.py``
  does; ROADMAP C3): each loss within 1e-5 relative, gradients and
  statistics within 1e-4 of each tensor's max in float32, 1e-6 in float64
  (the loss's interpolation stays float32). JAX's teacher gradients are
  zero; the port's teacher takes none. ``compute_acc`` (the plain
  segmentor's too, against JAX's float32) logs ``decode.acc_seg`` equal
  to JAX's (float64 model; the ratio in float32,
  1e-7 relative; the losses 1e-6).
- The teacher stays in eval mode under ``train()``; the optimizer holds no
  teacher parameter; a train step leaves every teacher tensor bit-equal.
- The four distiller configs of the repo build at full width.
"""
import os

import gaiaseg_tpu.models.backbones.beit as j_beit_module
import gaiaseg_tpu.models.losses.cross_entropy as j_ce_module
import gaiaseg_tpu.models.losses.dice_focal as j_df_module
import gaiaseg_tpu.models.segmentors.dynamic_distiller as j_dd_module
import gaiaseg_tpu.models.segmentors.encoder_decoder as j_ed_module
import gaiaseg_tpu.ops.dynamic_layers as j_layers_module
import gaiaseg_tpu.ops.resize as j_resize_module
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.models.losses.cross_entropy import \
    distill_softened_ce as j_distill_ce
from gaiaseg_tpu.models.losses.cross_entropy import \
    pairwise_gram_loss as j_pairwise
from gaiaseg_tpu.models.losses.dice_focal import \
    pixel_accuracy as j_pixel_accuracy
from gaiaseg_tpu_torch.engine import build_optimizer, trainable_parameters
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.engine.train import train_step
from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                      fill_img_size, model_max_arch)
from gaiaseg_tpu_torch.models.losses import (distill_softened_ce,
                                             pairwise_gram_loss,
                                             pixel_accuracy)
from gaiaseg_tpu_torch.utils import Config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
RTOL = 1e-4
F64_RTOL = 1e-6
HW = 64


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_distill_softened_ce_matches_jax(temperature):
    rng = np.random.RandomState(0)
    s = rng.randn(2, 6, 5, 7).astype(np.float32) * 3
    t = rng.randn(2, 6, 5, 7).astype(np.float32) * 3
    got = float(distill_softened_ce(nchw(s), nchw(t), temperature))
    want = float(j_distill_ce(jnp.asarray(s), jnp.asarray(t), temperature))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("case", ["whole", "window", "small_map"])
def test_pairwise_gram_loss_matches_jax(case):
    hw = 3 if case == "small_map" else 8
    rng = np.random.RandomState(1)
    s = rng.randn(2, hw, hw + 1, 5).astype(np.float32)
    t = rng.randn(2, hw, hw + 1, 7).astype(np.float32)
    key = None if case == "whole" else jax.random.PRNGKey(4)
    want = float(j_pairwise(jnp.asarray(s), jnp.asarray(t), key))
    offsets = None
    if case == "window":    # JAX's own draw, as pairwise_gram_loss draws
        ky, kx = jax.random.split(key)
        sh, sw = hw // 2, (hw + 1) // 2
        offsets = (int(jax.random.randint(ky, (), 0, hw - sh + 1)),
                   int(jax.random.randint(kx, (), 0, hw + 1 - sw + 1)))
    gen = torch.Generator().manual_seed(0) if case == "small_map" else None
    got = float(pairwise_gram_loss(nchw(s), nchw(t), gen, offsets))
    assert got == pytest.approx(want, rel=1e-6)
    if case == "window":    # the whole maps give another value
        assert abs(float(pairwise_gram_loss(nchw(s), nchw(t))) - want) > 1e-3


def test_pairwise_window_drawn_from_the_generator():
    from gaiaseg_tpu_torch.models.losses.cross_entropy import _crop_offsets
    rng = np.random.RandomState(2)
    s = nchw(rng.randn(2, 8, 6, 5).astype(np.float32))
    t = nchw(rng.randn(2, 8, 6, 4).astype(np.float32))
    for seed in range(6):
        yx = _crop_offsets(8, 6, 4, 3, torch.Generator().manual_seed(seed))
        assert 0 <= int(yx[0]) <= 4 and 0 <= int(yx[1]) <= 3
        got = pairwise_gram_loss(s, t, torch.Generator().manual_seed(seed))
        want = pairwise_gram_loss(s, t, offsets=(int(yx[0]), int(yx[1])))
        assert float(got) == float(want)


@pytest.mark.parametrize("topk,thresh", [(1, None), (2, None), (1, 0.3)])
def test_pixel_accuracy_matches_jax(topk, thresh):
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 9, 10, 5).astype(np.float32)
    label = rng.randint(0, 5, (2, 9, 10)).astype(np.int32)
    label[:, :2] = 255
    got = float(pixel_accuracy(nchw(logits), torch.from_numpy(label),
                               topk=topk, thresh=thresh))
    want = float(j_pixel_accuracy(jnp.asarray(logits), jnp.asarray(label),
                                  topk=topk, thresh=thresh))
    assert got == pytest.approx(want, abs=1e-7)


# --------------------------------------------------------------------- #
STUDENT = dict(
    backbone=dict(type="DynamicResNet", stem_width=8,
                  body_width=[8, 8, 16, 16], body_depth=[1, 2, 2, 1],
                  out_indices=(0, 1, 2, 3)),
    decode_head=dict(type="DynamicPSPHead", in_index=3, channels=8,
                     pool_scales=(1, 2), dropout_ratio=0.0, num_classes=4,
                     loss_decode=dict(type="CrossEntropyLoss")),
    auxiliary_head=dict(type="DynamicFCNHead", in_index=2, channels=8,
                        num_convs=1, concat_input=False, dropout_ratio=0.0,
                        num_classes=4,
                        loss_decode=dict(type="CrossEntropyLoss",
                                         loss_weight=0.4)))
TEACHERS = {
    "beit": dict(
        teacher_backbone=dict(type="BEiT", embed_dim=32, depth=2,
                              num_heads=2, patch_size=8,
                              out_indices=(0, 1, 1, 1),
                              use_rel_pos_bias=True),
        teacher_decode_head=dict(type="DynamicFCNHead", in_index=1,
                                 channels=8, num_convs=1,
                                 concat_input=False, dropout_ratio=0.0,
                                 num_classes=4)),
    "resnet": dict(
        teacher_backbone=dict(type="DynamicResNet", stem_width=8,
                              body_width=[8, 8, 16, 16],
                              body_depth=[1, 1, 1, 1],
                              out_indices=(0, 1, 2, 3)),
        teacher_decode_head=dict(type="DynamicPSPHead", in_index=3,
                                 channels=8, pool_scales=(1, 2),
                                 dropout_ratio=0.0, num_classes=4)),
}
META = {"arch.backbone.stem.width": 6,
        "arch.backbone.body.width": [4, 6, 12, 10],
        "arch.backbone.body.depth": [1, 1, 2, 1]}


def _with_dtype(cfg, dtype):
    if isinstance(cfg, dict):
        out = {k: _with_dtype(v, dtype) for k, v in cfg.items()}
        if "type" in out and "Loss" not in out["type"]:
            out["dtype"] = dtype
        return out
    return cfg


def model_cfg(teacher: str, jax_side: bool, dtype=jnp.float32):
    cfg = dict(type="DynamicDistiller", **STUDENT, **TEACHERS[teacher],
               distill_cfg=dict(temperature=2.0, distill_weight=1.0,
                                pairwise_weight=0.5),
               test_cfg=dict(mode="whole"))
    if jax_side:
        return {k: _with_dtype(v, dtype) if k != "distill_cfg" else v
                for k, v in cfg.items()}
    if teacher == "beit":
        cfg["teacher_backbone"] = dict(cfg["teacher_backbone"], img_size=HW)
    return cfg


def seeded_variables(jmodel, jcfg, img, gt, jax_init=True):
    """JAX's init for the student's backbone and conv kernels; seeded
    values for the rest (the heads' BN and biases, the whole teacher:
    its tables, q/k/v biases, gammas and its heads' statistics).
    ``jax_init=False``: seeded values everywhere (no compile)."""
    k = jax.random.PRNGKey(0)

    def init_fn(a):
        return jmodel.init({"params": k, "dropout": k}, jnp.asarray(img),
                           jnp.asarray(gt), a, False, method="forward_train")
    arch = j_encode_arch(j_model_max_arch(jcfg))
    init = jax.jit(init_fn)(arch) if jax_init \
        else jax.eval_shape(init_fn, arch)
    rng = np.random.RandomState(0)

    def pick(path, ini):
        keys = [getattr(q, "key", q) for q in path]
        if jax_init and (keys[1] == "backbone_m" or (
                keys[-1] == "kernel" and not keys[1].startswith("t_"))):
            return np.asarray(ini)
        name = keys[-1]
        if name == "kernel":
            v = rng.randn(*ini.shape) / np.sqrt(np.prod(ini.shape[:-1]))
        elif name == "var":
            v = rng.uniform(0.5, 1.5, ini.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*ini.shape)
        elif name.startswith("gamma"):
            v = 0.5 + 0.1 * rng.randn(*ini.shape)
        else:
            v = 0.1 * rng.randn(*ini.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(pick, init)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` meaning float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def jax_float64_reference(teacher, variables, metas, img, gt):
    out = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in (j_layers_module, j_resize_module, j_ce_module,
                    j_ed_module, j_dd_module, j_beit_module, j_df_module):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jcfg = dict(model_cfg(teacher, True, jnp.float64), fused_loss=False)
        jmodel = j_build_segmentor(jcfg)
        max_arch = j_model_max_arch(jcfg)

        def loss_fn(params, stats, arch):
            (total, logs), mut = jmodel.apply(
                {"params": params, "batch_stats": stats}, jnp.asarray(img),
                jnp.asarray(gt), arch, False, method=jmodel.forward_train,
                mutable=["batch_stats"])
            return total, (logs, mut)

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables)
        for meta in metas:
            arch = j_encode_arch(max_arch, meta)
            (total, (logs, mut)), grads = value_and_grad(
                v["params"], v["batch_stats"], arch)
            out.append(jax.tree_util.tree_map(np.asarray, dict(
                loss=total, logs=logs, grads=grads,
                stats=mut["batch_stats"])))
        acc_logs = jax.jit(lambda p, s, a: jmodel.apply(
            {"params": p, "batch_stats": s}, jnp.asarray(img),
            jnp.asarray(gt), a, True, method=jmodel.forward_train,
            mutable=["batch_stats"])[0][1])(
            v["params"], v["batch_stats"], j_encode_arch(max_arch))
        out.append(jax.tree_util.tree_map(np.asarray, acc_logs))
    return out


@pytest.fixture(scope="module", params=sorted(TEACHERS))
def distiller(request):
    teacher = request.param
    rng = np.random.RandomState(5)
    img = rng.randn(8, HW, HW, 3).astype(np.float32)
    gt = rng.randint(0, 4, (8, HW, HW)).astype(np.int32)
    gt[:, :6] = 255
    jcfg = model_cfg(teacher, True)
    variables = seeded_variables(j_build_segmentor(jcfg), jcfg, img, gt)
    *refs, acc = jax_float64_reference(teacher, variables, [None, META],
                                       img, gt)
    return dict(teacher=teacher, img=img, gt=gt, variables=variables,
                refs=dict(zip([False, True], refs)), acc=acc)


def port_model(d, dtype=torch.float32):
    cfg = model_cfg(d["teacher"], False)
    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(d["variables"], cfg),
                          strict=True)
    return model.to(dtype).train()


@pytest.mark.parametrize("sub", [False, True], ids=["max", "sub"])
def test_distiller_losses_grads_and_stats_match_jax(distiller, sub):
    d = distiller
    ref = d["refs"][sub]
    cfg = model_cfg(d["teacher"], False)
    arch = encode_arch(model_max_arch(cfg), META if sub else None)
    gt = torch.from_numpy(d["gt"])
    model64 = port_model(d, torch.float64)
    total64, logs64 = model64.forward_train(nchw(d["img"]).double(), gt, arch)
    total64.backward()
    model = port_model(d)
    total, logs = model.forward_train(nchw(d["img"]), gt, arch)
    total.backward()
    keys = {"decode.loss_seg", "aux_0.loss_seg", "distill_loss_seg",
            "pairwise_loss_seg"}
    assert set(logs) == set(ref["logs"]) == keys
    for k in keys:
        want = float(ref["logs"][k])
        assert want > 1e-3, k
        assert abs(float(logs[k].detach()) - want) <= LOSS_RTOL * abs(want), k
        assert abs(float(logs64[k]) - want) <= F64_RTOL * abs(want), k
    assert abs(float(total.detach()) - float(ref["loss"])) <= \
        LOSS_RTOL * float(ref["loss"])

    for name in ("t_backbone", "t_decode_head"):
        assert all(float(np.abs(g).max()) == 0.0 for g in
                   jax.tree_util.tree_leaves(ref["grads"][name])), name
    want = variables_to_state_dict({"params": ref["grads"],
                                    "batch_stats": ref["stats"]}, cfg)
    grads64 = dict(model64.named_parameters())
    for key, p in model.named_parameters():
        if key.startswith("t_"):
            assert p.grad is None and not p.requires_grad, key
            continue
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        close(g, want[key].numpy(), RTOL, f"grad {key}")
        g64 = grads64[key].grad
        close(np.zeros(p.shape) if g64 is None else g64.numpy(),
              want[key].numpy(), F64_RTOL, f"float64 grad {key}")
    for key, buf in model.named_buffers():
        if "running" in key:
            close(buf.numpy(), want[key].numpy(), RTOL, f"stat {key}")


def test_compute_acc_logs_accuracy_as_jax(distiller):
    d = distiller
    cfg = model_cfg(d["teacher"], False)
    model = port_model(d, torch.float64)
    _, logs = model.forward_train(nchw(d["img"]).double(),
                                  torch.from_numpy(d["gt"]),
                                  encode_arch(model_max_arch(cfg)),
                                  compute_acc=True)
    assert set(logs) == set(d["acc"]) == {
        "decode.loss_seg", "decode.acc_seg", "aux_0.loss_seg",
        "distill_loss_seg", "pairwise_loss_seg"}
    # the accuracy's ratio is float32 (as JAX's float32), the aux loss's
    # interpolation float32
    for k, v in d["acc"].items():
        assert float(logs[k]) == pytest.approx(
            float(v), rel=1e-7 if "acc" in k else F64_RTOL), k
    assert 0.0 < float(logs["decode.acc_seg"]) < 1.0


def test_segmentor_compute_acc_matches_jax():
    """The plain segmentor's ``compute_acc`` mode (every head resized to the
    label, unfused losses, ``{head}.acc_seg``) against JAX's float32 at its
    init (1e-5 relative on the losses; the accuracies within one pixel of
    the 2x32x32)."""
    jcfg = dict(type="DynamicEncoderDecoder",
                **_with_dtype(STUDENT, jnp.float32))
    jmodel = j_build_segmentor(jcfg)
    rng = np.random.RandomState(6)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    gt = rng.randint(0, 4, (2, 32, 32)).astype(np.int32)
    variables = seeded_variables(jmodel, jcfg, img, gt)
    want = jax.jit(lambda v: jmodel.apply(
        v, jnp.asarray(img), jnp.asarray(gt),
        j_encode_arch(j_model_max_arch(jcfg)), True,
        method=jmodel.forward_train, mutable=["batch_stats"])[0][1])(
            variables)
    cfg = dict(type="DynamicEncoderDecoder", **STUDENT)
    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(variables, cfg),
                          strict=True)
    with torch.no_grad():
        _, logs = model.train().forward_train(
            nchw(img), torch.from_numpy(gt),
            encode_arch(model_max_arch(cfg)), compute_acc=True)
    assert set(logs) == set(want) == {"decode.loss_seg", "decode.acc_seg",
                                      "aux_0.loss_seg", "aux_0.acc_seg"}
    for k, v in want.items():
        tol = dict(abs=1.0 / gt.size) if "acc" in k \
            else dict(rel=LOSS_RTOL)
        assert float(logs[k]) == pytest.approx(float(v), **tol), k


def test_teacher_frozen_in_train_mode_and_outside_the_optimizer(distiller):
    d = distiller
    cfg = model_cfg(d["teacher"], False)
    model = port_model(d).train()
    teacher = [m for name, m in model.named_modules()
               if name.split(".")[0].startswith("t_")]
    assert teacher and not any(m.training for m in teacher)
    assert model.decode_head.training
    params = trainable_parameters(model, cfg)
    t_ids = {id(p) for n, p in model.named_parameters() if n.startswith("t_")}
    assert t_ids and not t_ids & {id(p) for p in params}
    opt = build_optimizer(params, dict(type="SGD", lr=0.1, momentum=0.9,
                                       weight_decay=5e-4))
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert not t_ids & held
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logs = train_step(model, opt, nchw(d["img"]), torch.from_numpy(d["gt"]),
                      encode_arch(model_max_arch(cfg)),
                      torch.Generator().manual_seed(0), max_norm=1.0)
    assert np.isfinite(float(logs["loss"]))
    after = model.state_dict()
    for k, v in before.items():
        same = torch.equal(after[k], v)
        assert same == k.startswith("t_") or "num_batches" in k, k


@pytest.mark.parametrize("name,teacher,total_m,teacher_m", [
    ("local_examples/train_supernet/soak_distill_512.py", "BEiT",
     239.804985, 125.574483),
    ("local_examples/train_supernet/soak_distill_resnet_teacher.py",
     "DynamicResNet", 225.506489, 111.275987),
    ("tests/tiny_distill.py", "BEiT", 0.180559, 0.047405),
    ("_dynamic_/models/pspnet_distill_beit.py", "BEiT", 240.385593,
     126.155091)])
def test_distill_configs_build_at_full_width(name, teacher, total_m,
                                             teacher_m):
    cfg = Config.fromfile(os.path.join(REPO, "configs", name))
    model_cfg_ = fill_img_size(cfg)
    with torch.device("meta"):
        model = build_segmentor(model_cfg_)
    assert type(model).__name__ == "DynamicDistiller"
    assert type(model.t_backbone).__name__ == teacher
    n = sum(p.numel() for p in model.parameters())
    n_t = sum(p.numel() for m in model.teacher_modules()
              for p in m.parameters())
    assert abs(n / 1e6 - total_m) < 1e-6 and abs(n_t / 1e6 - teacher_m) \
        < 1e-6, (n, n_t)
    if teacher == "BEiT":
        crop = model_cfg_["teacher_backbone"]["img_size"]
        patch = model.t_backbone.patch_size
        assert model.t_backbone.window == (crop[0] // patch,
                                           crop[1] // patch)
