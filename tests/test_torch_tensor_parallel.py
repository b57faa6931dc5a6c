"""Tensor parallelism over the ``model`` mesh axis against the JAX package.

The port's ``parallel/mesh.py`` (``tp_spec``, ``tp_plan``, ``shard_state``,
``shard_report``) and ``parallel/tensor_parallel.py`` (gather-on-use, the
Megatron pairs of ``ElasticEncoderLayer``):

- JAX's ``tp_spec`` cases (``tests/test_tensor_parallel.py``) on the port's
  copy, each beside JAX's own answer.
- The audit: for each family's tiny config, JAX's ``shard_report`` of its
  ``shard_state`` at ``model_parallel=2`` (``min_size=1``, placed on the
  8-device CPU mesh) and the port's plan name the same parameters, and the
  port's torch dim is JAX's sharded dim after ``engine/convert.py``'s
  layout change (leaves tagged by their id, then by their coordinate along
  the sharded dim, carried through ``variables_to_state_dict``).
- A train step on 2 gloo ranks at K = 2 in float64 against JAX's
  one-device step: the ViT of JAX's test at MAX and at a subnet whose
  heads and FFN features leave rank 1 nothing, and the flagship tiny at
  ``test_tp_step_matches_dp_flagship_resnet_psp``'s arch (loss, parameters
  and BN statistics within 1e-6 of their max); the replicated parameters
  equal on both ranks, bit for bit, and each rank's optimizer state at its
  shard's size.

The ranks are spawned by ``test_torch_parallel.run_ranks`` (free port,
timeout, the group left in a ``finally``). The JAX package is imported
inside the tests, so that the spawned ranks load torch alone.
"""
import copy
import os

import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch import parallel
from gaiaseg_tpu_torch.parallel import tp_plan, tp_spec
from gaiaseg_tpu_torch.parallel.tensor_parallel import gather_full, tp_info
from test_torch_parallel import run_ranks

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_RTOL = 1e-6
SGD = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=5e-4)

# the two models of JAX's tests/test_tensor_parallel.py, without dtypes
VIT = dict(
    type="DynamicEncoderDecoder",
    backbone=dict(type="ElasticTransformer", embed_dim=128, depth=2,
                  num_heads=2, ffn_ratio=2.0, patch_size=8, img_size=32,
                  out_indices=(0, 1)),
    decode_head=dict(type="DynamicFCNHead", in_index=1, channels=32,
                     num_convs=1, concat_input=False, dropout_ratio=0.0,
                     num_classes=4, loss_decode=dict(type="CrossEntropyLoss")),
    test_cfg=dict(mode="whole"))
FLAGSHIP_TINY = dict(
    type="DynamicEncoderDecoder",
    backbone=dict(type="DynamicResNet", stem_width=8,
                  body_width=[8, 16, 24, 32], body_depth=[2, 2, 3, 2],
                  out_indices=(0, 1, 2, 3)),
    decode_head=dict(type="DynamicPSPHead", in_index=3, channels=16,
                     pool_scales=(1, 2), dropout_ratio=0.0, num_classes=6,
                     loss_decode=dict(type="CrossEntropyLoss")),
    auxiliary_head=dict(type="DynamicFCNHead", in_index=2, channels=8,
                        num_convs=1, concat_input=True, dropout_ratio=0.0,
                        num_classes=6,
                        loss_decode=dict(type="CrossEntropyLoss",
                                         loss_weight=0.4)),
    test_cfg=dict(mode="whole"))
# rank 1 of 2 holds head 1 and FFN features 128-255: none is active here
VIT_EMPTY = {"arch.backbone.encoder.num_heads": [1, 1],
             "arch.backbone.encoder.ffn_channels": [64, 128]}
FLAGSHIP_SUB = {"arch.backbone.stem.width": 8,
                "arch.backbone.body.width": [8, 8, 16, 24],
                "arch.backbone.body.depth": [1, 2, 2, 1]}


def jax_cfg(cfg, dtype):
    """``cfg`` with ``dtype`` on the backbone and the heads (JAX's)."""
    out = copy.deepcopy(cfg)
    for part in ("backbone", "decode_head", "auxiliary_head"):
        if part in out:
            out[part]["dtype"] = dtype
    return out


# --------------------------------------------------------------------- #
# JAX's tp_spec cases (tests/test_tensor_parallel.py:34-49, 88-103)
TP_SPEC_CASES = [
    ("backbone/layers_0/attn/qkv/kernel", (128, 384), 2, 1),
    ("backbone/layers_0/attn/proj/kernel", (128, 128), 2, 1),
    ("backbone/layers_0/fc2/kernel", (256, 128), 2, 1),
    ("backbone/stem/conv/kernel", (3, 3, 16, 64), 2, 1),
    ("head/conv_seg/kernel", (1, 1, 32, 5), 2, 1),
    ("bn/scale", (64,), 2, 1),
    ("x/kernel", (8, 8), 2, 1 << 16),
    ("decode_head_m/c1_proj/conv/kernel", (1, 1, 64, 64), 2, 1),
    ("backbone_m/reproject/kernel", (64, 64), 2, 1),
    ("backbone_m/layer0/attn/proj/kernel", (64, 64), 2, 1),
]
TP_SPEC_WANT = [(None, "model"), ("model", None), ("model", None),
                (None, None, None, "model"), (), (), (),
                (None, None, None, "model"), (None, "model"),
                ("model", None)]


@pytest.mark.parametrize("case,want", list(zip(TP_SPEC_CASES, TP_SPEC_WANT)),
                         ids=[c[0].split("/", 1)[1] + f"-{c[3]}"
                              for c in TP_SPEC_CASES])
def test_tp_spec_is_jax_s(case, want):
    from gaiaseg_tpu.parallel.mesh import tp_spec as j_tp_spec
    path, shape, tp, min_size = case
    got = tp_spec(path, shape, tp, min_size=min_size)
    assert got == want
    assert got == tuple(j_tp_spec(path, shape, tp, min_size=min_size))


# --------------------------------------------------------------------- #
def _family_cfgs():
    """(port config, JAX config, init image size) of each family's tiny
    config in the port's tests."""
    import jax.numpy as jnp
    import test_torch_convformer as cf
    import test_torch_convnext as cn
    import test_torch_deeplab as dl
    import test_torch_segformer as sf
    import test_torch_teacher as tt
    f32 = jnp.float32
    return {
        "flagship_tiny": (FLAGSHIP_TINY, jax_cfg(FLAGSHIP_TINY, f32), 32),
        "vit": (VIT, jax_cfg(VIT, f32), 32),
        "deeplabv3plus": (dl.model_cfg("deeplab", False),
                          dl.model_cfg("deeplab", True), 32),
        "convnext": (cn.model_cfg(False), cn.model_cfg(True), 32),
        "conformer": (cf.seg_cfg(False), cf.seg_cfg(True), 32),
        "segformer": (sf.model_cfg(False), sf.model_cfg(True), 64),
        "beit_teacher": (tt.distiller_cfg(tt.BEIT_TEACHER),
                         _jax_distiller_cfg(tt), 64),
    }


def _jax_distiller_cfg(tt):
    import jax.numpy as jnp
    cfg = copy.deepcopy(tt.distiller_cfg(tt.BEIT_TEACHER))
    for part in ("backbone", "decode_head", "auxiliary_head",
                 "teacher_backbone", "teacher_neck", "teacher_decode_head"):
        if part in cfg and isinstance(cfg[part], dict):
            cfg[part]["dtype"] = jnp.float32
    return cfg


@pytest.mark.parametrize("family", ["flagship_tiny", "vit", "deeplabv3plus",
                                    "convnext", "conformer", "segformer",
                                    "beit_teacher"])
def test_shard_report_is_jax_s_leaf_for_leaf(family):
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu.models import encode_arch as j_encode_arch
    from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
    from gaiaseg_tpu.parallel.mesh import _path_str
    from gaiaseg_tpu.parallel.mesh import make_mesh as j_make_mesh
    from gaiaseg_tpu.parallel.mesh import shard_report as j_shard_report
    from gaiaseg_tpu.parallel.mesh import shard_state as j_shard_state

    from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
    from gaiaseg_tpu_torch.models import build_segmentor

    cfg, jcfg, hw = _family_cfgs()[family]
    jmodel = j_build_segmentor(jcfg)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, hw, hw, 3)),
        jnp.zeros((1, hw, hw), jnp.int32),
        j_encode_arch(j_model_max_arch(jcfg)), method="forward_train"))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    shapes["params"])
    report = j_shard_report(j_shard_state(
        params, j_make_mesh(model_parallel=2), min_size=1))
    assert report

    # tag every JAX leaf: (a) its id, (b) its coordinate along the dim JAX
    # shards (-1 where it shards none)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    sharded_ids, ids, coords = set(), [], []
    for i, (path, leaf) in enumerate(leaves):
        key = _path_str(path)
        ids.append(np.full(leaf.shape, i + 1, np.float32))
        coord = np.full(leaf.shape, -1.0, np.float32)
        if key in report:
            sharded_ids.add(i + 1)
            spec = report[key]                 # "PartitionSpec(None, 'model')"
            entries = spec[spec.index("(") + 1:spec.rindex(")")].split(",")
            dim = [j for j, e in enumerate(entries) if "model" in e][0]
            shape = [1] * leaf.ndim
            shape[dim] = leaf.shape[dim]
            coord = np.broadcast_to(np.arange(leaf.shape[dim], dtype=
                                              np.float32).reshape(shape),
                                    leaf.shape).copy()
        coords.append(coord)
    treedef = jax.tree_util.tree_structure(params)
    stats = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes.get("batch_stats", {}))

    def port_sd(values):
        return variables_to_state_dict(
            {"params": jax.tree_util.tree_unflatten(treedef, values),
             "batch_stats": stats}, cfg)
    sd_ids, sd_coords = port_sd(ids), port_sd(coords)

    model = build_segmentor(cfg)
    plan = tp_plan(model, 2, min_size=1)
    names = {n for n, _ in model.named_parameters()}
    assert set(plan) <= names
    jax_side = {n for n in names if set(np.unique(sd_ids[n].numpy())
                                         .astype(int)) & sharded_ids}
    assert set(plan) == jax_side, (sorted(set(plan) - jax_side),
                                   sorted(jax_side - set(plan)))
    for name, (dim, size, route) in plan.items():
        assert size == 2 and route in ("gather", "column", "row")
        c = sd_coords[name].numpy()
        assert c.shape[dim] > 1 and (c >= 0).all(), name
        # the coordinate along JAX's sharded dim moves along torch ``dim``
        # only
        first = c
        for d in range(c.ndim):
            if d != dim:
                first = np.take(first, [0], axis=d)
        assert (np.broadcast_to(first, c.shape) == c).all(), (name, dim)
        assert len(np.unique(first)) > 1, name


# --------------------------------------------------------------------- #
def _tp_step(rank, world, model_cfg, state, meta, k, min_size=1,
             plant_world_group=False, hw=32):
    """One SGD step (batch statistics updated) of ``model_cfg`` in float64
    from ``state`` on this rank's part of the batch of 8, at
    ``model_parallel`` k: the full parameters and BN statistics after it,
    the loss, the replicated gradients' equality over the model ranks
    (before they are synchronised), the optimizer state's and the shards'
    element counts. ``plant_world_group``: the data axis's reductions run
    over every rank instead (a planted fault). ``hw``: the images' size."""
    from gaiaseg_tpu_torch.engine import optim
    from gaiaseg_tpu_torch.engine import train as train_mod
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    from gaiaseg_tpu_torch.parallel import mesh as mesh_mod
    model = build_segmentor(model_cfg)
    model.load_state_dict(state)
    model.double().train()
    mesh = parallel.make_mesh(k)
    parallel.shard_state(model, mesh, min_size=min_size)
    optimizer = optim.build_optimizer(model.parameters(), SGD)
    img, gt = _step_inputs(hw)
    if plant_world_group:
        from gaiaseg_tpu_torch.parallel import distributed
        distributed._data_group = lambda: None
    d, n_data = parallel.data_parallel()
    n = img.shape[0] // n_data
    rows = slice(d * n, (d + 1) * n)
    equal = []
    sync = train_mod.sync_replicated_grads

    def checked(params):
        params = list(params)
        sums = [float(p.grad.double().sum()) for p in params
                if p.grad is not None and tp_info(p) is None]
        equal.append(len({tuple(s) for s in mesh_gather(sums)}) == 1)
        return sync(params)

    def mesh_gather(obj):
        every = parallel.all_gather_objects(obj)
        m0 = d * k
        return every[m0:m0 + k]
    train_mod.sync_replicated_grads = checked
    try:
        logs = train_mod.train_step(
            model, optimizer, torch.from_numpy(img[rows].transpose(0, 3, 1, 2)
                                               .copy()).double(),
            torch.from_numpy(gt[rows]),
            encode_arch(model_max_arch(model_cfg), meta))
    finally:
        train_mod.sync_replicated_grads = sync
    state = mesh_mod.gather_state_dict(model)
    replicated = {name: float(p.detach().sum())
                  for name, p in model.named_parameters()
                  if tp_info(p) is None}
    opt_numel = {name: [v.numel() for v in optimizer.state[p].values()]
                 for name, p in model.named_parameters()}
    return {"state": state, "loss": float(parallel.sum_over_ranks(
                logs["decode.loss_seg"])),
            "replicated": mesh_gather(replicated), "grads_equal": equal,
            "report": parallel.shard_report(model),
            "numel": {name: p.numel() for name, p in
                      model.named_parameters()}, "opt_numel": opt_numel}


def _step_inputs(hw=32):
    rng = np.random.RandomState(21)
    img = rng.randn(8, hw, hw, 3)
    gt = rng.randint(0, 4, (8, hw, hw)).astype(np.int32)
    gt[rng.rand(8, hw, hw) < 0.2] = 255
    return img, gt


def _jax_step(cfg, meta):
    """JAX's one-device SGD step in float64 (x64 on, the float32 casts of
    its modules patched for the call): the initial variables, the
    variables after the step and the decode loss."""
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.engine import optim as joptim
    from gaiaseg_tpu.engine.train import TrainState, make_train_step
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu.models import encode_arch as j_encode_arch
    from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
    from test_torch_convnext import f64_tree, jax_float64
    img, gt = _step_inputs()
    jcfg = jax_cfg(cfg, jnp.float32)
    jmodel = j_build_segmentor(jcfg)
    max_arch = j_model_max_arch(jcfg)
    k = jax.random.PRNGKey(0)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": k, "dropout": k}, jnp.asarray(img, jnp.float32),
        jnp.asarray(gt), j_encode_arch(max_arch), compute_acc=False,
        method="forward_train"))
    from test_torch_deeplab import _as_f64

    def run():
        jm = j_build_segmentor(_as_f64(jcfg))
        tx = joptim.build_optimizer(SGD)
        v = f64_tree(variables)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"],
                           opt_state=tx.init(v["params"]))
        state, logs = make_train_step(jm, tx, update_stats=True)(
            state, jnp.asarray(img), jnp.asarray(gt),
            j_encode_arch(max_arch, meta), k)
        return state.params, state.batch_stats, logs["decode.loss_seg"]
    params, stats, loss = jax_float64(run)
    return variables, {"params": params, "batch_stats": stats}, float(loss)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=F64_RTOL * max(float(np.abs(want).max()),
                                                   1e-30), err_msg=what)


@pytest.mark.parametrize("case", ["vit_max", "vit_empty_shard",
                                  "flagship_tiny"])
def test_two_ranks_at_model_parallel_2_equal_jax_s_step(case, tmp_path):
    from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
    cfg, meta = {"vit_max": (VIT, None), "vit_empty_shard": (VIT, VIT_EMPTY),
                 "flagship_tiny": (FLAGSHIP_TINY, FLAGSHIP_SUB)}[case]
    variables, after, jloss = _jax_step(cfg, meta)
    state = variables_to_state_dict(variables, cfg)
    want = variables_to_state_dict(after, cfg)
    ranks = run_ranks(_tp_step, tmp_path, cfg, state, meta, 2)
    for r in ranks:
        assert r["report"] and r["report"] == ranks[0]["report"]
        assert set(r["state"]) == set(want)
        for key in want:
            _close(r["state"][key], want[key], f"{case} {key}")
        # the replicated parameters and their gradients, bit for bit
        assert r["replicated"][0] == r["replicated"][1]
        assert r["grads_equal"] == [True]
        for name, numel in r["numel"].items():
            info = r["report"].get(name)
            full = int(np.prod(want[name].shape))
            assert numel == (full // 2 if info else full), name
            assert r["opt_numel"][name] == [numel], name
    if case == "vit_max":
        routes = {v[2] for v in ranks[0]["report"].values()}
        assert routes == {"gather", "column", "row"}
    if case == "flagship_tiny":
        assert {v[2] for v in ranks[0]["report"].values()} == {"gather"}
    assert ranks[0]["loss"] == pytest.approx(jloss, rel=F64_RTOL)
