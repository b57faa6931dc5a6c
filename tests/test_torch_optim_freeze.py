"""Plain Adam and frozen stages against the JAX optimizer chain.

- ``type='Adam'``: 3 steps on seeded parameters and gradients equal optax's
  ``scale_by_adam()`` chain (JAX ``build_optimizer``) within 1e-6 of each
  tensor's max, with ``weight_decay``, ``betas`` and ``eps`` in the config
  and ignored by both.
- ``frozen_stages=1`` (JAX ``freeze_labels``): 3 SGD steps (momentum 0.9,
  weight decay 5e-4) with a global-norm clip that is active, from JAX's
  init of ``test_torch_segmentor.py``'s model, at MAX, MIN and a random
  arch. The stem and layer1 stay bit-equal to their start; every other
  parameter, BN statistic and momentum within 1e-4 of its tensor's max of
  JAX's masked chain; the clip's norm is the global norm over every
  gradient, the frozen ones included (JAX clips before its mask).
- The same on 2 gloo ranks at batch 2 each against one process at batch 4,
  in float64: the frozen parameters bit-equal to their start on each rank,
  the rest and the clip norms within 1e-10.

The JAX package is imported inside the tests, so that the spawned ranks,
which import this module, load torch alone.
"""
import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch import parallel
from gaiaseg_tpu_torch.engine import optim
from gaiaseg_tpu_torch.engine.train import train_step

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
RTOL = 1e-4
F64_RTOL = 1e-10
SGD = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=5e-4)
CLIP = 0.5      # below the gradients' global norm: the clip scales
FROZEN_PREFIXES = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def test_adam_matches_optax_and_ignores_decay_and_betas():
    import jax.numpy as jnp
    import optax
    from gaiaseg_tpu.engine import optim as joptim
    cfg = dict(type="Adam", lr=0.01, weight_decay=0.05, betas=(0.5, 0.6),
               eps=1e-3)
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = joptim.build_optimizer(cfg)
    state = tx.init(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = optim.build_optimizer(list(tp.values()), cfg)
    assert isinstance(opt, torch.optim.Adam)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8 \
        and group["weight_decay"] == 0.0
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tp.items():
        _close(p.detach().numpy(), jp[k], k, 1e-6)


def _frozen(key):
    return key.startswith(FROZEN_PREFIXES)


def _frozen_cfg(jax_side):
    from test_torch_segmentor import model_cfg
    cfg = model_cfg(jax_side)
    cfg["backbone"] = dict(cfg["backbone"], frozen_stages=1)
    return cfg


def _batches(n=4):
    rng = np.random.RandomState(5)
    return [(rng.randn(n, 32, 32, 3).astype(np.float32),
             rng.randint(0, 7, (n, 32, 32)).astype(np.int32))
            for _ in range(3)]


def _global_norm(model):
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in model.parameters()]))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("above", [True, False])
def test_clip_norm_equals_the_per_leaf_route(dtype, rtol, above):
    """``clip_grad_norm`` in one process (one ``torch._foreach_norm`` over
    the gradients) against the norm of the leaves' norms, each taken with
    its own ``vector_norm``: the same norm and the same clipped gradients,
    with the norm above ``max_norm`` (scaled) and below it (unchanged). A
    parameter without a gradient is left out of both."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(64, 3, 3, 3), (64,), (7, 5), (), (1000,)]
    params = [torch.nn.Parameter(torch.randn(s, generator=gen, dtype=dtype))
              for s in shapes]
    for i, p in enumerate(params[:-1]):
        p.grad = torch.randn(p.shape, generator=gen, dtype=dtype) * (i + 1)
    grads = [p.grad.clone() for p in params[:-1]]
    want = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    max_norm = float(want) * (0.5 if above else 2.0)
    scale = torch.where(want < max_norm, torch.ones_like(want),
                        max_norm / want)
    norm = optim.clip_grad_norm(params, max_norm)
    assert norm.dtype == dtype and params[-1].grad is None
    torch.testing.assert_close(norm, want, rtol=rtol, atol=0)
    for p, g in zip(params, grads):
        torch.testing.assert_close(p.grad, g * scale, rtol=rtol, atol=0)
        if not above:
            assert torch.equal(p.grad, g)


def test_freeze_labels_name_the_stem_and_layers():
    assert optim.freeze_labels({"backbone": {}}) == set()
    assert optim.freeze_labels({"backbone": {"frozen_stages": 0}}) == {
        "conv1", "bn1", "stem"}
    assert optim.freeze_labels({"backbone": {"frozen_stages": 2}}) == {
        "conv1", "bn1", "stem", "layer1", "layer2"}


def test_frozen_stages_match_jax_and_clip_over_every_gradient():
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.engine import optim as joptim
    from gaiaseg_tpu.engine.train import TrainState, make_train_step
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu.models import encode_arch as j_encode_arch
    from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
    from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
    from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
        model_max_arch
    from test_torch_segmentor import METAS
    from test_torch_train import _find_trace, _np

    batches = _batches()
    metas = [METAS["max"], METAS["min"], METAS["random"]]
    jcfg, cfg = _frozen_cfg(True), _frozen_cfg(False)
    jmodel = j_build_segmentor(jcfg)
    j_max = j_model_max_arch(jcfg)
    k = jax.random.PRNGKey(0)
    variables = _np(jax.jit(lambda a: jmodel.init(
        {"params": k, "dropout": k}, jnp.asarray(batches[0][0]),
        jnp.asarray(batches[0][1]), a, compute_acc=False,
        method="forward_train"))(j_encode_arch(j_max)))
    clip = {"grad_clip": {"max_norm": CLIP}}
    mask = joptim.freeze_labels(variables["params"], jcfg)
    tx = joptim.build_optimizer(SGD, clip, freeze_mask=mask)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree_util.tree_map(jnp.asarray,
                                                     variables["params"]),
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(jmodel, tx, update_stats=True)

    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(variables, cfg))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    optimizer = optim.build_optimizer(
        optim.trainable_parameters(model, cfg), SGD)
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    names = dict(model.named_parameters())
    assert {k for k, p in names.items() if id(p) not in held} == \
        {k for k in names if _frozen(k)} != set()
    port_max = model_max_arch(cfg)
    for (img, gt), meta in zip(batches, metas):
        state, _ = step(state, jnp.asarray(img), jnp.asarray(gt),
                        j_encode_arch(j_max, meta), k)
        logs = train_step(model, optimizer,
                          torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                          torch.from_numpy(gt), encode_arch(port_max, meta),
                          max_norm=CLIP)
        # the clip scaled every gradient, the frozen ones (not zero) too
        assert float(logs["grad_norm"]) > CLIP
        assert abs(float(_global_norm(model)) - CLIP) <= 1e-5 * CLIP
        assert any(bool(p.grad.abs().max() > 0)
                   for k, p in names.items() if _frozen(k))
    stats = _np(state.batch_stats)
    want = variables_to_state_dict({"params": _np(state.params),
                                    "batch_stats": stats}, cfg)
    for key, t in model.state_dict().items():
        if _frozen(key) and key in names:
            assert torch.equal(t, start[key]), key
            assert np.array_equal(want[key].numpy(), start[key].numpy()), key
        else:
            _close(t.numpy(), want[key].numpy(), key)
    momentum = variables_to_state_dict(
        {"params": _np(_find_trace(state.opt_state)), "batch_stats": stats},
        cfg)
    for key, p in names.items():
        if not _frozen(key):
            _close(optimizer.state[p]["momentum_buffer"].numpy(),
                   momentum[key].numpy(), f"momentum {key}")


def _frozen_ranks(rank, world, state):
    from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
        model_max_arch
    from test_torch_segmentor import METAS
    cfg = _frozen_cfg(False)
    model = build_segmentor(cfg)
    model.load_state_dict(state)
    model.double().train()
    optimizer = optim.build_optimizer(
        optim.trainable_parameters(model, cfg), SGD)
    norms = []
    for (img, gt), name in zip(_batches(), ("max", "min", "random")):
        n = img.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        logs = train_step(
            model, optimizer,
            torch.from_numpy(img[rows].transpose(0, 3, 1, 2).copy()).double(),
            torch.from_numpy(gt[rows]),
            encode_arch(model_max_arch(cfg), METAS[name]), max_norm=CLIP)
        norms.append(parallel.sum_over_ranks(logs["grad_norm"]) / world)
    return {"state": model.state_dict(), "norms": torch.stack(norms)}


def test_frozen_stages_across_ranks(tmp_path):
    from gaiaseg_tpu_torch.models import build_segmentor
    torch.manual_seed(0)
    state = build_segmentor(_frozen_cfg(False)).double().state_dict()
    ranks = run_ranks(_frozen_ranks, tmp_path, state)
    one = _frozen_ranks(0, 1, state)
    torch.testing.assert_close(ranks[0]["norms"], one["norms"], rtol=1e-10,
                               atol=0)
    assert bool((one["norms"] > CLIP).all())
    for key, want in one["state"].items():
        if _frozen(key) and not key.endswith(("running_mean",
                                              "running_var",
                                              "num_batches_tracked")):
            assert torch.equal(want, state[key]), key
        for r in ranks:
            if _frozen(key):
                assert torch.equal(r["state"][key], want) or \
                    "running" in key, key
            _close(r["state"][key].numpy(), want.numpy(), key, F64_RTOL)
