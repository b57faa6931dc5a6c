"""Data-parallel training across 2 gloo processes of this CPU against one
process at the global batch, and against the JAX package.

The rule: W ranks x B compute what one process computes at batch W·B.

- ``sync_batch_norm`` (``DynBatchNorm`` in train mode under 2 ranks) equals
  ``DynBatchNorm`` on the concatenated batch: outputs, input and parameter
  gradients, running statistics (float64, within 1e-10 of each tensor's
  max), at a sliced width, at one value per channel a rank, and in the
  silent step. ``stat_groups`` across ranks equals the one-process groups;
  one process's ``stat_groups=2`` equals JAX's within 1e-5 of max.
- The fused and the unfused loss on 2 ranks, one of them with about 90% of
  its labels ignored: the ranks' shares add up to the one-process loss and
  to JAX's ``fused_resize_ce`` (interpret mode) within 1e-6, the gradients
  too. Averaging per-rank means fails this.
- One ``train_step`` on 2 ranks x 4 equals the port at 1 x 8 (float64,
  1e-10 of each tensor's max) and JAX at batch 8 on the 8-device CPU mesh
  (1e-4 of max, as tests/test_torch_train.py).
- 4 iterations of ``train_segmentor`` (val workflow, silent steps, a
  calibrated checkpoint, in-loop eval) on 2 ranks x 4: weights, BN
  statistics and momenta bit-equal across the ranks and within 1e-8 of
  each tensor's max of the one-process run at 8, in float64 (the batches
  cast from the pipeline's float32); the LR scaled by the global batch;
  one checkpoint, from rank 0. The tiny config amplifies any difference
  in the weights: in one process, weights moved by 1e-12 drift apart by
  orders of magnitude within 4 iterations (more at batch 4 than at 8), so
  float32's rounding alone takes two float32 runs far apart.
- The train and test_supernet CLIs on 2 processes with the JAX flags.
- Without a process group no ``torch.distributed`` collective is called.

The JAX package is imported inside the tests, so that the spawned ranks,
which import this module, load torch alone.
"""
import contextlib
import importlib
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaiaseg_tpu_torch import parallel
from gaiaseg_tpu_torch.ops.dynamic_layers import DynBatchNorm

from test_torch_parallel import TINY, _free_port, run_ranks

torch.set_num_threads(1)
F64_RTOL = 1e-10


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


# --------------------------------------------------------------------- #
BN_CASES = {   # name: (global input shape, active channels, stat_groups)
    "sliced": ((4, 8, 5, 5), 6, 1),
    "one_value_a_rank": ((2, 8, 1, 1), 8, 1),
    "groups_2": ((4, 8, 3, 3), 5, 2),
    "groups_4": ((8, 8, 3, 3), 8, 4),
}


def _bn_inputs(name):
    shape, c, groups = BN_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(*shape) * 2 + 1
    dy = rng.randn(shape[0], c, *shape[2:])
    params = rng.rand(4, 8)
    return x[:, :c], dy, params, groups


def _bn_run(name, rows, update_stats=True):
    x, dy, params, groups = _bn_inputs(name)
    bn = DynBatchNorm(8, stat_groups=groups).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params[0] + 0.5))
        bn.bias.copy_(torch.from_numpy(params[1]))
        bn.running_mean.copy_(torch.from_numpy(params[2]))
        bn.running_var.copy_(torch.from_numpy(params[3] + 0.5))
    bn.update_stats = update_stats
    xt = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(dy[rows])).sum().backward()
    return {"y": y.detach(), "dx": xt.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean,
            "var": bn.running_var}


def _bn_ranks(rank, world):
    out = {}
    for name, (shape, _, _) in BN_CASES.items():
        n = shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        out[name] = _bn_run(name, rows)
        out[name + "/silent"] = _bn_run(name, rows, update_stats=False)
    bad = DynBatchNorm(4, stat_groups=3).double().train()
    try:
        bad(torch.zeros(3, 4, 2, 2, dtype=torch.float64))
    except ValueError as e:
        out["refused"] = str(e)
    return out


def test_sync_batch_norm_equals_the_concatenated_batch(tmp_path):
    ranks = run_ranks(_bn_ranks, tmp_path)
    for name in BN_CASES:
        for tag, update in ((name, True), (name + "/silent", False)):
            want = _bn_run(name, slice(None), update_stats=update)
            for key in ("y", "dx"):
                _close(torch.cat([r[tag][key] for r in ranks]), want[key],
                       F64_RTOL, f"{tag} {key}")
            for key in ("dw", "db"):    # each rank's share; summed after
                _close(sum(r[tag][key] for r in ranks), want[key],
                       F64_RTOL, f"{tag} {key}")
            for key in ("mean", "var"):
                for r in ranks:
                    _close(r[tag][key], want[key], F64_RTOL, f"{tag} {key}")
    # the silent step leaves the running statistics as they were
    params = _bn_inputs("sliced")[2]
    np.testing.assert_array_equal(ranks[0]["sliced/silent"]["mean"].numpy(),
                                  params[2])
    assert all("stat_groups=3 over 2 ranks of batch 3" in r["refused"]
               for r in ranks)


def test_stat_groups_match_jax_and_the_builder_passes_them():
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.ops.dynamic_layers import DynBatchNorm as JBN

    from gaiaseg_tpu_torch.models import build_segmentor
    from gaiaseg_tpu_torch.utils import Config

    rng = np.random.RandomState(3)
    x = (rng.randn(4, 4, 5, 5) * 2 + 1).astype(np.float32)   # NCHW, c 4
    bn = DynBatchNorm(6, stat_groups=2).train()
    y = bn(torch.from_numpy(x)).detach().numpy()
    jbn = JBN(6, dtype=jnp.float32, stat_groups=2)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    v = jbn.init(jax.random.PRNGKey(0), jnp.zeros((4, 5, 5, 6)),
                 use_running_average=False)
    yj, mut = jbn.apply(v, xj, use_running_average=False,
                        mutable=["batch_stats"])
    _close(y, np.asarray(yj).transpose(0, 3, 1, 2), 1e-5, "output")
    _close(bn.running_mean.numpy(), mut["batch_stats"]["mean"], 1e-5, "mean")
    _close(bn.running_var.numpy(), mut["batch_stats"]["var"], 1e-5, "var")

    cfg = Config.fromfile(TINY)["model"]
    for part in ("backbone", "decode_head", "auxiliary_head"):
        cfg[part]["norm_cfg"] = dict(type="DynSyncBN", group_size=1,
                                     stat_groups=2)
    model = build_segmentor(cfg)
    groups = {m.stat_groups for m in model.modules()
              if isinstance(m, DynBatchNorm)}
    assert groups == {2}


# --------------------------------------------------------------------- #
LOSS_SHAPE = (4, 5, 4, 4, 32, 32)     # n, c, h, w, H, W (fused gate open)


def _loss_inputs():
    n, c, h, w, H, W = LOSS_SHAPE
    rng = np.random.RandomState(9)
    logits = rng.randn(n, c, h, w).astype(np.float32)
    label = rng.randint(0, c, (n, H, W)).astype(np.int32)
    label[:2][rng.rand(2, H, W) < 0.1] = 255
    label[2:][rng.rand(2, H, W) < 0.9] = 255     # rank 1: ~90% ignored
    return logits, label


def _losses(rank, world):
    from gaiaseg_tpu_torch.models.losses.cross_entropy import \
        softmax_cross_entropy
    from gaiaseg_tpu_torch.ops.cuda.resize_ce import (
        fused_resize_ce, fused_resize_ce_reference)
    from gaiaseg_tpu_torch.ops.resize import resize_bilinear
    logits, label = _loss_inputs()
    n = logits.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    hw = LOSS_SHAPE[4:]

    def unfused(x, lab, out_hw):
        return softmax_cross_entropy(resize_bilinear(x, out_hw, False), lab)

    out = {}
    for name, fn in (("fused", fused_resize_ce),
                     ("reference", fused_resize_ce_reference),
                     ("unfused", unfused)):
        x = torch.from_numpy(logits[rows]).requires_grad_()
        loss = fn(x, torch.from_numpy(label[rows]), hw)
        grad, = torch.autograd.grad(loss, x)
        out[name] = {"share": loss.detach(),
                     "global": parallel.sum_over_ranks(loss.detach()),
                     "grad": grad}
    return out


def test_loss_is_the_global_mean_with_unequal_valid_counts(tmp_path):
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.ops.pallas import resize_ce as jrc

    ranks = run_ranks(_losses, tmp_path)
    one = _losses(0, 1)
    logits, label = _loss_inputs()
    j_loss, j_grad = jax.value_and_grad(
        lambda lg: jrc.fused_resize_ce(lg, jnp.asarray(label),
                                       LOSS_SHAPE[4:], 255, True))(
        jnp.asarray(logits.transpose(0, 2, 3, 1)))
    j_grad = np.asarray(j_grad).transpose(0, 3, 1, 2)
    valid = [(label[r * 2:(r + 1) * 2] != 255).sum() for r in range(2)]
    assert valid[0] > 5 * valid[1]       # far from equal counts
    for name in ("fused", "reference", "unfused"):
        total = float(ranks[0][name]["share"] + ranks[1][name]["share"])
        for r in ranks:
            assert abs(float(r[name]["global"]) - total) <= 1e-6
        assert abs(total - float(one[name]["share"])) <= 1e-6, name
        assert abs(total - float(j_loss)) <= 1e-6, name
        grad = torch.cat([r[name]["grad"] for r in ranks]).numpy()
        np.testing.assert_allclose(grad, one[name]["grad"].numpy(), rtol=0,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(grad, j_grad, rtol=0, atol=1e-7,
                                   err_msg=name)


# --------------------------------------------------------------------- #
SGD = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=5e-4)


def _step_inputs():
    rng = np.random.RandomState(21)
    img = rng.randn(8, 32, 32, 3).astype(np.float32)    # zero-mean: JAX's
    gt = rng.randint(0, 7, (8, 32, 32)).astype(np.int32)   # float32 BN holds
    gt[rng.rand(8, 32, 32) < 0.2] = 255
    return img, gt


def _train_step(rank, world, model_cfg, state, meta):
    from gaiaseg_tpu_torch.engine import optim
    from gaiaseg_tpu_torch.engine.train import train_step
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    model = build_segmentor(model_cfg)
    model.load_state_dict(state)
    model.double().train()
    optimizer = optim.build_optimizer(model.parameters(), SGD)
    img, gt = _step_inputs()
    n = img.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    logs = train_step(model, optimizer,
                      torch.from_numpy(img[rows].transpose(0, 3, 1, 2)
                                       .copy()).double(),
                      torch.from_numpy(gt[rows]),
                      encode_arch(model_max_arch(model_cfg), meta))
    return {"state": model.state_dict(),
            "momentum": {k: optimizer.state[p]["momentum_buffer"]
                         for k, p in model.named_parameters()},
            "loss": parallel.sum_over_ranks(logs["loss"])}


def test_train_step_two_ranks_equal_one_process_and_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.engine import optim as joptim
    from gaiaseg_tpu.engine.train import TrainState, make_train_step
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu.models import encode_arch as j_encode_arch
    from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
    from gaiaseg_tpu.parallel.mesh import make_mesh, replicate, shard_batch

    from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
    from test_torch_segmentor import METAS, model_cfg
    from test_torch_train import _find_trace, _np

    img, gt = _step_inputs()
    meta = METAS["random"]     # a subnet: some tensors get no gradient
    jcfg = model_cfg(True)
    jmodel = j_build_segmentor(jcfg)
    j_max = j_model_max_arch(jcfg)
    k = jax.random.PRNGKey(0)
    variables = _np(jax.jit(lambda a: jmodel.init(
        {"params": k, "dropout": k}, jnp.asarray(img), jnp.asarray(gt), a,
        compute_acc=False, method="forward_train"))(j_encode_arch(j_max)))
    state = variables_to_state_dict(variables, model_cfg(False))

    ranks = run_ranks(_train_step, tmp_path, model_cfg(False), state, meta)
    one = _train_step(0, 1, model_cfg(False), state, meta)
    assert float(ranks[0]["loss"]) == pytest.approx(float(one["loss"]),
                                                    rel=1e-12, abs=0)
    for key, want in one["state"].items():
        for r in ranks:
            _close(r["state"][key], want, F64_RTOL, key)
    for key, want in one["momentum"].items():
        for r in ranks:
            _close(r["momentum"][key], want, F64_RTOL, f"momentum {key}")

    # JAX: the same batch of 8 sharded over the 8-device CPU mesh
    mesh = make_mesh()
    assert mesh.devices.size == 8
    tx = joptim.build_optimizer(SGD)
    jstate = replicate(TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"])), mesh)
    batch = shard_batch({"img": img, "gt": gt}, mesh)
    jstate, _ = make_train_step(jmodel, tx, update_stats=True)(
        jstate, batch["img"], batch["gt"], j_encode_arch(j_max, meta), k)
    stats = _np(jstate.batch_stats)
    want = variables_to_state_dict({"params": _np(jstate.params),
                                    "batch_stats": stats}, model_cfg(False))
    momentum = variables_to_state_dict(
        {"params": _np(_find_trace(jstate.opt_state)), "batch_stats": stats},
        model_cfg(False))
    for key in want:
        _close(ranks[0]["state"][key], want[key], 1e-4, f"jax {key}")
    for key in one["momentum"]:
        _close(ranks[0]["momentum"][key], momentum[key], 1e-4,
               f"jax momentum {key}")


# --------------------------------------------------------------------- #
LOOP_ITERS = 4
LOOP_RTOL = 1e-8
PER_SAMPLE_LR = 0.00125    # the flagship's lr_scaler.base_lr


def _loop_cfg(batch):
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict({
        "data.samples_per_gpu": batch,
        "lr_scaler": {"policy": "linear", "base_lr": PER_SAMPLE_LR},
        # no clip: a clipped update hides the gradients' scale
        "optimizer_config": {"grad_clip": None},
        "log_config.interval": 2, "checkpoint_config.interval": LOOP_ITERS,
        "evaluation.interval": LOOP_ITERS,
        "workflow": [["train", 2], ["val", 1]]})
    return cfg


@contextlib.contextmanager
def _float64_batches():
    """The loop's train, val and eval batches in float64 (the pipeline's
    float32 values, cast), for a float64 model."""
    train, evaluate = (importlib.import_module(f"gaiaseg_tpu_torch.engine.{m}")
                       for m in ("train", "evaluate"))
    saved = [(m, name, getattr(m, name)) for m, name in (
        (train, "augment_batch"), (train, "prepare_eval_batch"),
        (evaluate, "prepare_eval_batch"))]

    def cast(fn):
        return lambda *a, **kw: fn(*a, **dict(kw, dtype=torch.float64))
    try:
        for m, name, fn in saved:
            setattr(m, name, cast(fn))
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _loop(rank, world, work_dir, batch):
    from gaiaseg_tpu_torch.engine import train_segmentor
    from gaiaseg_tpu_torch.models import build_segmentor
    cfg = _loop_cfg(batch)
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"]).double()
    with _float64_batches():
        state, history = train_segmentor(model, cfg, work_dir=work_dir,
                                         device="cpu", max_iters=LOOP_ITERS)
    opt = state.optimizer
    return {"state": model.state_dict(),
            "momentum": {k: opt.state[p]["momentum_buffer"]
                         for k, p in model.named_parameters()},
            "history": history, "files": sorted(os.listdir(work_dir))}


def test_train_segmentor_two_ranks_equal_one_process(tmp_path):
    from gaiaseg_tpu_torch.engine.optim import build_lr_schedule
    ranks = run_ranks(_loop, tmp_path, str(tmp_path / "wd"), 4)
    one = _loop(0, 1, str(tmp_path / "one"), 8)
    a, b = ranks
    for key in one["state"]:
        torch.testing.assert_close(a["state"][key], b["state"][key], rtol=0,
                                   atol=0, msg=key)
        _close(a["state"][key], one["state"][key], LOOP_RTOL, key)
    for key in one["momentum"]:
        torch.testing.assert_close(a["momentum"][key], b["momentum"][key],
                                   rtol=0, atol=0, msg=key)
        _close(a["momentum"][key], one["momentum"][key], LOOP_RTOL, key)
    assert a["files"] == one["files"] == ["history.json",
                                          f"iter_{LOOP_ITERS}.pth",
                                          "latest.pth"]
    schedule = build_lr_schedule(_loop_cfg(8)["lr_config"],
                                 PER_SAMPLE_LR * 8, LOOP_ITERS)
    rows = [(h["iter"], h["lr"]) for h in a["history"]["loss"]]
    assert rows == [(2, schedule(1)), (4, schedule(3))]
    assert rows == [(h["iter"], h["lr"]) for h in one["history"]["loss"]]
    for h, w in zip(a["history"]["loss"], one["history"]["loss"]):
        assert h["loss"] == pytest.approx(w["loss"], rel=1e-6)
    for h, w in zip(a["history"]["val_loss"], one["history"]["val_loss"]):
        assert h["loss"] == pytest.approx(w["loss"], rel=1e-6)
    assert len(a["history"]["val_loss"]) == 2
    evals = [{k: (m["mIoU"], m["aAcc"]) for k, m in
              r["history"]["eval"][0]["metrics"].items()} for r in ranks]
    assert evals[0] == evals[1] and set(evals[0]) == {"MIN", "MAX"}


# --------------------------------------------------------------------- #
def _clis(rank, world, port, port2, work_dir, space):
    from gaiaseg_tpu_torch.tools import test_supernet, train_supernet
    flags = ["--num-processes", str(world), "--process-id", str(rank),
             "--device", "cpu"]
    train_supernet.main([TINY, "--work-dir", work_dir, "--max-iters", "2",
                         "--coordinator", f"127.0.0.1:{port}", *flags])
    return test_supernet.main([TINY, os.path.join(work_dir, "latest.pth"),
                               "--model-space", space, "--work-dir",
                               work_dir, "--coordinator",
                               f"127.0.0.1:{port2}", *flags])


def test_clis_run_two_processes_with_the_jax_flags(tmp_path):
    from gaiaseg_tpu_torch.tools import test_supernet
    from gaiaseg_tpu_torch.utils import Config
    space = tmp_path / "space.json"
    space.write_text(json.dumps(Config.fromfile(TINY)["val_sampler"]
                                ["anchors"]))
    wd = tmp_path / "wd"
    ranks = run_ranks(_clis, tmp_path, _free_port(), str(wd), str(space),
                      join_group=False, timeout=180)
    assert sorted(os.listdir(wd)) == ["history.json", "iter_2.pth",
                                      "latest.pth", "test_supernet"]
    one = test_supernet.main([TINY, str(wd / "latest.pth"), "--model-space",
                              str(space), "--work-dir", str(tmp_path / "one"),
                              "--device", "cpu"])
    assert ranks[0] == ranks[1] == one
    assert len(one) == 2 and all("mIoU" in r["metric"]["metric"]
                                 for r in one)


# --------------------------------------------------------------------- #
def test_no_collective_without_a_process_group(tmp_path, monkeypatch):
    """One process: the loop (val workflow, calibration, checkpoint,
    in-loop eval) and eval call no torch.distributed function."""
    from gaiaseg_tpu_torch.engine import evaluate, train_segmentor
    from gaiaseg_tpu_torch.models import build_segmentor

    def forbidden(*args, **kw):
        raise AssertionError("a collective was called in one process")

    for name in ("all_reduce", "broadcast", "all_gather", "barrier",
                 "new_group", "init_process_group", "get_rank",
                 "get_world_size", "reduce_scatter"):
        monkeypatch.setattr(dist, name, forbidden)
    cfg = _loop_cfg(2)
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"])
    _, history = train_segmentor(model, cfg, work_dir=str(tmp_path),
                                 device="cpu", max_iters=LOOP_ITERS)
    assert history["eval"] and history["val_loss"]
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    res = evaluate(model, SyntheticDataset(length=3, size=(32, 32),
                                           num_classes=5, seed=1, cells=2),
                   encode_arch(model_max_arch(cfg["model"])), batch_size=2,
                   device="cpu")
    assert res["confusion"].sum() == 3 * 32 * 32
