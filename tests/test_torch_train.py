"""Port's train step, optimizer, schedule, samplers and config loader vs JAX.

- 3 SGD steps (momentum 0.9, wd 5e-4, poly LR) over an equal arch sequence
  (MAX, MIN, random) and equal batches from equal weights: parameters,
  momentum buffers and BN running stats match JAX
  ``make_train_step(model, tx, update_stats=True)`` within 1e-4 of each
  tensor's max magnitude (float32, dropout 0).
- The port's copies of the samplers and the config loader give the JAX
  package's arch sequence and config dicts.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.archspace.samplers import \
    build_model_sampler as j_build_model_sampler
from gaiaseg_tpu.engine import optim as joptim
from gaiaseg_tpu.engine.train import TrainState, make_train_step
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.utils.config import Config as JConfig
from gaiaseg_tpu_torch.archspace import build_model_sampler
from gaiaseg_tpu_torch.engine import optim
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.engine.train import train_step
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.utils import Config

from test_torch_segmentor import METAS, model_cfg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "local_examples", "train_supernet",
                        "pspnet_ar50to101v2_gsync.py")
SGD = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=5e-4)
POLY = dict(policy="poly", power=0.9, min_lr=1e-4, by_epoch=False)


def _find_trace(opt_state):
    """The momentum tree inside the optax chain state."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            t = _find_trace(s)
            if t is not None:
                return t
    return None


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want: torch.Tensor, what: str):
    want = want.numpy()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=what)


def test_three_sgd_steps_match_jax():
    rng = np.random.RandomState(5)
    batches = [(rng.randn(4, 32, 32, 3).astype(np.float32),
                rng.randint(0, 7, (4, 32, 32)).astype(np.int32))
               for _ in range(3)]
    metas = [METAS["max"], METAS["min"], METAS["random"]]
    schedule = joptim.build_lr_schedule(POLY, SGD["lr"], 3)

    jcfg = model_cfg(True)
    jmodel = j_build_segmentor(jcfg)
    j_max = j_model_max_arch(jcfg)
    k = jax.random.PRNGKey(0)
    variables = _np(jax.jit(lambda a: jmodel.init(
        {"params": k, "dropout": k}, jnp.asarray(batches[0][0]),
        jnp.asarray(batches[0][1]), a, compute_acc=False,
        method="forward_train"))(j_encode_arch(j_max)))

    # the port starts from the same weights
    model = build_segmentor(model_cfg(False))
    model.load_state_dict(variables_to_state_dict(variables,
                                                  model_cfg(False)))
    model.train()
    optimizer = optim.build_optimizer(model.parameters(), SGD)
    port_max = model_max_arch(model_cfg(False))

    tx = joptim.build_optimizer(SGD)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree_util.tree_map(jnp.asarray,
                                                     variables["params"]),
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(jmodel, tx, update_stats=True)
    for i, ((img, gt), meta) in enumerate(zip(batches, metas)):
        lr = schedule(i)
        state = state.replace(opt_state=joptim.set_learning_rate(
            state.opt_state, lr))
        state, _ = step(state, jnp.asarray(img), jnp.asarray(gt),
                        j_encode_arch(j_max, meta), k)
        optim.set_learning_rate(optimizer, lr)
        train_step(model, optimizer,
                   torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                   torch.from_numpy(gt), encode_arch(port_max, meta))

    stats = _np(state.batch_stats)
    want = variables_to_state_dict({"params": _np(state.params),
                                    "batch_stats": stats}, model_cfg(False))
    got = model.state_dict()
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], key)
    momentum = variables_to_state_dict(
        {"params": _np(_find_trace(state.opt_state)), "batch_stats": stats},
        model_cfg(False))
    for key, p in model.named_parameters():
        _close(optimizer.state[p]["momentum_buffer"], momentum[key],
               f"momentum {key}")


def test_train_sampler_sequence_matches_jax():
    cfg, jcfg = Config.fromfile(FLAGSHIP), JConfig.fromfile(FLAGSHIP)
    port = build_model_sampler(cfg["train_sampler"])
    ref = j_build_model_sampler(jcfg["train_sampler"])
    draws = [port.sample() for _ in range(24)]
    assert draws == [ref.sample() for _ in range(24)]
    assert [d.get("name", "random") for d in draws[:8]] == \
        ["MAX", "MIN", "R101", "R77", "R50", "random", "random", "random"]
    assert list(build_model_sampler(cfg["val_sampler"]).traverse()) == \
        list(j_build_model_sampler(jcfg["val_sampler"]).traverse())


def test_encode_arch_matches_jax():
    cfg = Config.fromfile(FLAGSHIP).to_dict()
    sampler = build_model_sampler(cfg["train_sampler"])
    j_max, port_max = j_model_max_arch(cfg["model"]), \
        model_max_arch(cfg["model"])
    for _ in range(8):
        meta = sampler.sample()
        want = jax.tree_util.tree_map(lambda x: np.asarray(x).tolist(),
                                      j_encode_arch(j_max, meta))
        assert encode_arch(port_max, meta) == want


CONFIGS = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(os.path.join(REPO, "configs", "**", "*.py"),
                           recursive=True))


@pytest.mark.parametrize("path", CONFIGS)
def test_config_loader_matches_jax(path):
    full = os.path.join(REPO, path)
    try:
        want = JConfig.fromfile(full).to_dict()
    except Exception as e:    # the copy must fail the same way
        with pytest.raises(type(e)):
            Config.fromfile(full)
        return
    assert Config.fromfile(full).to_dict() == want


def test_cfg_options_merge_matches_jax():
    opts = {"data.samples_per_gpu": 8, "model.backbone.stem_width": 48,
            "data.train": {"type": "SyntheticDataset", "size": [512, 1024]}}
    cfg, jcfg = Config.fromfile(FLAGSHIP), JConfig.fromfile(FLAGSHIP)
    cfg.merge_from_dict(opts)
    jcfg.merge_from_dict(opts)
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg["data"]["train"]["type"] == "SyntheticDataset"


@pytest.mark.parametrize("lr_config", [
    POLY,
    dict(policy="step", step=[2, 5], gamma=0.5, warmup="linear",
         warmup_iters=3, warmup_ratio=0.1),
    dict(policy="fixed"),
])
def test_lr_schedule_matches_jax(lr_config):
    base = optim.scale_lr(0.01, 8, dict(policy="linear", base_lr=0.00125))
    assert base == joptim.scale_lr(0.01, 8, dict(policy="linear",
                                                 base_lr=0.00125))
    port = optim.build_lr_schedule(lr_config, base, 10)
    ref = joptim.build_lr_schedule(lr_config, base, 10)
    for it in range(12):
        assert port(it) == pytest.approx(float(ref(it)), rel=1e-12)
