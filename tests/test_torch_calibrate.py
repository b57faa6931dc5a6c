"""The port's silent step and BN calibration against the JAX package.

- ``train_step(update_stats=False)`` against JAX ``make_train_step(
  update_stats=False)``: equal loss, gradients (against ``jax.grad`` of
  the ``mutable=[]`` loss) and updated parameters (within 1e-4 of each
  tensor's max), every running statistic bit-unchanged; and its loss and
  gradients bit-equal to the port's full step's.
- Batch 1 through the PSP head's 1x1 pool (one value a channel), where
  torch's ``F.batch_norm`` refuses to train: the step against JAX's full
  step, running statistics included (ROADMAP C6).
- ``calibrate_bn`` against JAX ``calibrate_bn`` at the MAX and MIN anchors:
  the same batches (the JAX ``BatchLoader`` order), every debiased
  statistic within 1e-4 of its tensor's max (worst seen 1.9e-5 at MAX,
  7.3e-6 at MIN). The inputs are integer-exact (mean 128, std 64), so JAX's
  bf16 eval batch equals the port's float32 one. 1e-5 is out of reach
  against the float32 JAX model: at MAX it is itself 2.2e-5 from a float64
  run of the port (its BN variance is E[x^2] - E[x]^2, ROADMAP C3), while
  the port's float32 calibration is within 1e-5 of the float64 one (its own
  test below; 6.5e-6 seen).
- The frozen teacher's statistics survive reset and debias; the decay comes
  from the modules' momentum; modules that disagree raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from gaiaseg_tpu.data import SyntheticDataset as JSyntheticDataset
from gaiaseg_tpu.data.pipeline_cfg import \
    TestPipelineParams as JTestPipelineParams
from gaiaseg_tpu.engine import calibrate as jcal
from gaiaseg_tpu.engine import optim as joptim
from gaiaseg_tpu.engine.train import TrainState, make_train_step
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu_torch.data import SyntheticDataset
from gaiaseg_tpu_torch.data import TestPipelineParams as EvalParams
from gaiaseg_tpu_torch.engine import calibrate as cal
from gaiaseg_tpu_torch.engine import optim
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.engine.train import train_step
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.ops import DynBatchNorm

from test_torch_segmentor import METAS, model_cfg

torch.set_num_threads(1)
RTOL = 1e-4
CALIB_RTOL = 1e-4       # against JAX's float32 model
F64_RTOL = 1e-5         # the port's float32 calibration against float64
CALIB_SIZE = (128, 128)  # layer4 at 4x4: 32 values a channel in a batch
EXACT = dict(mean=(128.0, 128.0, 128.0), std=(64.0, 64.0, 64.0))
SGD = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=5e-4)


def jax_variables(batch=4, seed=3):
    """JAX init of the test model (float32) and a batch of its inputs."""
    cfg = model_cfg(True)
    model = j_build_segmentor(cfg)
    rng = np.random.RandomState(seed)
    img = rng.randn(batch, 32, 32, 3).astype(np.float32)
    gt = rng.randint(0, 7, (batch, 32, 32)).astype(np.int32)
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda a: model.init(
        {"params": k, "dropout": k}, jnp.asarray(img), jnp.asarray(gt), a,
        compute_acc=False, method="forward_train"))(
            j_encode_arch(j_model_max_arch(cfg)))
    return model, jax.tree_util.tree_map(np.asarray, variables), img, gt


def port_model(variables):
    model = build_segmentor(model_cfg(False))
    model.load_state_dict(variables_to_state_dict(variables,
                                                  model_cfg(False)))
    return model


def _close(got, want, what, rtol=RTOL, floor=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    np.testing.assert_allclose(
        got, want, rtol=0, atol=max(rtol * float(np.abs(want).max()), floor),
        err_msg=what)


def _jax_step(jmodel, variables, img, gt, meta, update_stats):
    tx = joptim.build_optimizer(SGD)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree_util.tree_map(jnp.asarray,
                                                     variables["params"]),
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(jmodel, tx, update_stats=update_stats,
                           with_logs=True)
    cfg = model_cfg(True)
    state, logs = step(state, jnp.asarray(img), jnp.asarray(gt),
                       j_encode_arch(j_model_max_arch(cfg), meta),
                       jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, state), logs


def _port_step(variables, img, gt, meta, update_stats):
    model = port_model(variables).train()
    opt = optim.build_optimizer(model.parameters(), SGD)
    before = {k: v.clone() for k, v in model.named_buffers()}
    logs = train_step(model, opt, torch.from_numpy(
        img.transpose(0, 3, 1, 2).copy()), torch.from_numpy(gt),
        encode_arch(model_max_arch(model_cfg(False)), meta),
        update_stats=update_stats)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return model, logs, before, grads


def _jax_silent_grads(jmodel, variables, img, gt, meta):
    """JAX's gradient of the silent step's loss (``mutable=[]``)."""
    cfg = model_cfg(True)

    def loss(params):
        (total, _), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(img), jnp.asarray(gt),
            j_encode_arch(j_model_max_arch(cfg), meta), False,
            method=jmodel.forward_train, mutable=[],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return total

    grads = jax.jit(jax.grad(loss))(variables["params"])
    return variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": variables["batch_stats"]}, model_cfg(False))


@pytest.mark.parametrize("name", ["max", "random"])
def test_silent_step_matches_jax(name):
    jmodel, variables, img, gt = jax_variables()
    meta = METAS[name]
    state, jlogs = _jax_step(jmodel, variables, img, gt, meta, False)
    model, logs, before, grads = _port_step(variables, img, gt, meta, False)
    assert abs(float(logs["decode.loss_seg"])
               - float(jlogs["decode.loss_seg"])) <= \
        RTOL * abs(float(jlogs["decode.loss_seg"]))
    want_grads = _jax_silent_grads(jmodel, variables, img, gt, meta)
    for key, g in grads.items():
        _close(g, want_grads[key], f"grad {key}")
    want = variables_to_state_dict({"params": state.params,
                                    "batch_stats": state.batch_stats},
                                   model_cfg(False))
    for key, p in model.named_parameters():
        _close(p, want[key], key)
    for key, buf in model.named_buffers():
        assert torch.equal(buf, before[key]), key
        assert torch.equal(want[key], before[key]), key   # JAX's too
    # the full step: the same loss and gradients, bit for bit
    _, full_logs, _, full_grads = _port_step(variables, img, gt, meta, True)
    assert torch.equal(full_logs["loss"], logs["loss"])
    for key, g in full_grads.items():
        assert torch.equal(g, grads[key]), key


def test_batch_one_through_the_one_by_one_pool_matches_jax():
    """Batch 1: the PSP head's 1x1 branch and layer4 (1x1 at a 32x32 input)
    hold one value a channel. Torch's F.batch_norm raises there ("Expected
    more than 1 value per channel"); the JAX module normalizes it to 0 and
    unbiases its variance by n / max(n - 1, 1) = 1. Where the port's zeros
    then flow on as exact zeros, JAX carries the rounding of its folded
    scale and shift (``x * inv - mean * inv``, ``inv = rsqrt(eps) = 316``):
    tensors that are that noise alone on its side (max 1e-6) compare
    within 1e-5 absolute."""
    jmodel, variables, img, gt = jax_variables(batch=1, seed=4)
    state, jlogs = _jax_step(jmodel, variables, img, gt, None, True)
    model, logs, _, _ = _port_step(variables, img, gt, None, True)
    assert abs(float(logs["loss"]) - float(jlogs["decode.loss_seg"])
               - float(jlogs["aux_0.loss_seg"])) <= \
        RTOL * abs(float(logs["loss"]))
    want = variables_to_state_dict({"params": state.params,
                                    "batch_stats": state.batch_stats},
                                   model_cfg(False))
    for key, t in model.state_dict().items():
        _close(t, want[key], key, floor=1e-5)
    pooled = model.decode_head.psp_modules[0][1].bn
    assert torch.isfinite(pooled.running_var).all()


def _datasets():
    kw = dict(length=5, size=CALIB_SIZE, num_classes=7, seed=2, cells=4)
    return JSyntheticDataset(**kw), SyntheticDataset(**kw)


@pytest.mark.parametrize("name", ["max", "min"])
def test_calibrate_bn_matches_jax(name):
    jmodel, variables, _, _ = jax_variables()
    jds, ds = _datasets()
    meta = METAS[name]
    cfg = model_cfg(True)
    want_vars = jcal.calibrate_bn(
        jmodel, variables, jds, j_encode_arch(j_model_max_arch(cfg), meta),
        num_batches=3, batch_size=2,
        test_params=JTestPipelineParams(**EXACT))
    want = variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_vars), model_cfg(False))
    model = port_model(variables).eval()
    out = cal.calibrate_bn(model, ds,
                           encode_arch(model_max_arch(model_cfg(False)), meta),
                           num_batches=3, batch_size=2,
                           test_params=EvalParams(**EXACT))
    assert out is model and not model.training
    for key, buf in model.named_buffers():
        _close(buf, want[key], key, CALIB_RTOL)


def test_calibrate_bn_float32_within_1e5_of_float64():
    _, variables, _, _ = jax_variables()
    _, ds = _datasets()
    arch = encode_arch(model_max_arch(model_cfg(False)))
    kw = dict(num_batches=3, batch_size=2,
              test_params=EvalParams(**EXACT))
    f32 = cal.calibrate_bn(port_model(variables), ds, arch, **kw)
    f64 = cal.calibrate_bn(port_model(variables).double(), ds, arch, **kw)
    want = dict(f64.named_buffers())
    for key, buf in f32.named_buffers():
        _close(buf.double(), want[key], key, F64_RTOL)


class _WithTeacher(nn.Module):
    def __init__(self):
        super().__init__()
        self.t_backbone = DynBatchNorm(3)
        self.backbone = DynBatchNorm(3)


def test_reset_and_debias_skip_the_frozen_teacher():
    model = _WithTeacher()
    with torch.no_grad():
        for m, (mean, var) in ((model.t_backbone, (7.0, 2.5)),
                               (model.backbone, (4.0, 9.0))):
            m.running_mean.fill_(mean)
            m.running_var.fill_(var)
    stats = {"t_backbone": {"bn": {"mean": jnp.full(3, 7.0),
                                   "var": jnp.full(3, 2.5)}},
             "backbone": {"bn": {"mean": jnp.full(3, 4.0),
                                 "var": jnp.full(3, 9.0)}}}
    cal.reset_bn_stats(model)
    want = jcal.reset_bn_stats(stats)
    cal.debias_bn_stats(model, 0.9, 8)
    want = jcal._debias_stats(want, 0.9, 8)
    for name in ("t_backbone", "backbone"):
        m = getattr(model, name)
        np.testing.assert_array_equal(m.running_mean.numpy(),
                                      np.asarray(want[name]["bn"]["mean"]))
        np.testing.assert_allclose(m.running_var.numpy(),
                                   np.asarray(want[name]["bn"]["var"]),
                                   rtol=1e-6)
    assert float(model.t_backbone.running_mean[0]) == 7.0


def test_debias_follows_the_modules_momentum():
    """Torch's momentum 0.2 is a decay of 0.8: the port debiases by
    1 - 0.8^k, as JAX's ``_debias_stats`` does when told 0.8."""
    model = _WithTeacher()
    for m in model.modules():
        if isinstance(m, DynBatchNorm):
            m.momentum = 0.2
    assert cal.bn_decay(model) == pytest.approx(0.8)
    rng = np.random.RandomState(0)
    mean, var = rng.randn(3).astype(np.float32), \
        rng.uniform(0.5, 2, 3).astype(np.float32)
    with torch.no_grad():
        model.backbone.running_mean.copy_(torch.from_numpy(mean))
        model.backbone.running_var.copy_(torch.from_numpy(var))
    cal.debias_bn_stats(model, cal.bn_decay(model), 5)
    want = jcal._debias_stats({"b": {"mean": jnp.asarray(mean),
                                     "var": jnp.asarray(var)}}, 0.8, 5)
    np.testing.assert_allclose(model.backbone.running_mean.numpy(),
                               np.asarray(want["b"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(model.backbone.running_var.numpy(),
                               np.asarray(want["b"]["var"]), rtol=1e-6)
    model.t_backbone.momentum = 0.1
    with pytest.raises(ValueError, match="momenta"):
        cal.bn_decay(model)


def test_calibrate_estimate_independent_of_num_batches():
    """Every batch holds the same records (length == batch size), so the
    debiased estimate does not depend on k (JAX
    ``tests/test_calibrate.py``'s test, on the port)."""
    model = build_segmentor(model_cfg(False))
    ds = SyntheticDataset(length=2, size=(32, 32), num_classes=7, cells=2)
    arch = encode_arch(model_max_arch(model_cfg(False)))
    cal.calibrate_bn(model, ds, arch, num_batches=2, batch_size=2)
    two = cal.bn_stats(model)
    cal.calibrate_bn(model, ds, arch, num_batches=8, batch_size=2)
    for name, (mean, var) in cal.bn_stats(model).items():
        np.testing.assert_allclose(mean.numpy(), two[name][0].numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), two[name][1].numpy(),
                                   rtol=1e-4, atol=1e-5)
