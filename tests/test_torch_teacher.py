"""The distiller's workflow in the port against the JAX package: teacher
checkpoints, ``make_teacher_ckpt``, the train CLI, calibration, resume, the
val workflow, extraction and FLOPs, and 2 gloo ranks.

- ``load_teacher_checkpoint`` on an official-layout teacher segmentor
  ``.pth`` (a ``TBeit`` backbone of a 4x4 window + an FCN head, as
  ``tests/test_distill_e2e.py`` writes it) loads what JAX's loads: every
  teacher entry equal to JAX's loaded tree carried by ``engine/convert.py``
  (within 1e-6 of max; the tables are resampled to the model's 8x8 window),
  the FPN adapters at their init. Each error JAX raises, raises; a port
  teacher file lacking an entry raises.
- ROADMAP C15: where the file carries the FPN adapters, the port loads
  their deconvs (JAX loads none); ``fpn1.1``, a BN in the official layout
  and a LayerNorm in both packages, keeps its init, with a warning.
- ``tools/make_teacher_ckpt.py``: a trained supernet's checkpoint becomes a
  teacher file whose teacher loads bit-equal to the supernet's backbone
  and decode head, BN statistics included; the aux head stays behind.
- ROADMAP C13: JAX's ``.pth`` route passes a DynamicResNet teacher's keys
  through its BEiT converter, which maps none, so the teacher keeps its
  init; the port's loads them.
- ``configs/tests/tiny_distill.py`` trains through the port's train CLI
  with the teacher ``.pth`` for 48 iterations: ``distill_loss_seg`` falls
  as JAX's test asks (some later row below the first), the checkpoint
  holds the loaded teacher; on one fixed batch both distillation losses
  fall (the pairwise loss of a 2x2 map sits near its floor in both
  packages, so the row test is a draw for it).
- Calibration re-estimates the student's statistics and leaves the
  teacher's bit-equal. Resume restores the teacher from the checkpoint
  without reading the teacher file; ``load_from`` carries it.
- The val workflow: JAX's distiller has no eval path, so JAX's val step
  runs its ``forward_train`` with batch statistics, left unchanged. The
  port's val phase does the same on a distiller: its decode loss within
  1e-5 relative of JAX's (float32), and no statistic moves.
- ``extract_subnet`` on a distiller equals JAX's bit for bit (the student
  cut, the teacher carried); ``get_model_complexity_info`` counts the
  student as JAX's does (equal).
- A distiller train step (BEiT teacher, the pairwise window drawn from the
  step's generator) on 2 gloo ranks x 4 equals one process x 8 in float64:
  weights and momenta within 1e-10 of each tensor's max, the losses within
  1e-6 relative (the fused loss's plain version interpolates in float32).

JAX is imported inside the tests, so that the spawned ranks load torch
alone.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch.engine.teacher import load_teacher_checkpoint
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_parallel import run_ranks  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DISTILL = os.path.join(REPO, "configs", "tests", "tiny_distill.py")

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
BEIT_TEACHER = dict(
    teacher_backbone=dict(type="BEiT", embed_dim=32, depth=2, num_heads=2,
                          patch_size=8, out_indices=(0, 1, 1, 1)),
    teacher_decode_head=dict(type="DynamicFCNHead", in_index=1, channels=8,
                             num_convs=1, concat_input=False,
                             dropout_ratio=0.0, num_classes=4))
RESNET_TEACHER = dict(
    teacher_backbone=dict(type="DynamicResNet", stem_width=8,
                          body_width=[8, 8, 16, 16], body_depth=[1, 2, 2, 1],
                          out_indices=(0, 1, 2, 3)),
    teacher_decode_head=dict(type="DynamicPSPHead", in_index=3, channels=8,
                             pool_scales=(1, 2), dropout_ratio=0.0,
                             num_classes=4))
DISTILL = dict(temperature=2.0, distill_weight=1.0, pairwise_weight=0.5)


def distiller_cfg(teacher, img_size=64):
    cfg = copy.deepcopy(dict(type="DynamicDistiller", **STUDENT, **teacher,
                             distill_cfg=DISTILL,
                             test_cfg=dict(mode="whole")))
    if cfg["teacher_backbone"]["type"] == "BEiT":
        cfg["teacher_backbone"]["img_size"] = img_size
    return cfg


def randomize(model, seed):
    """Every tensor of ``model`` seeded (positive variances)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if v.is_floating_point():
                r = torch.randn(v.shape, generator=g) * 0.2
                v.copy_(r.abs() + 0.5 if k.endswith("running_var") else r)
    return model


def teacher_pth(tmp_path, grid=4):
    """An official-layout BEiT + FCN teacher segmentor .pth (the JAX e2e
    test's file)."""
    from test_vit_convert import TBeit, _rand
    tmodel = TBeit(dim=32, heads=2, depth=2, patch=8, grid=grid).eval()
    _rand(tmodel)
    sd = {"backbone." + k: v for k, v in tmodel.state_dict().items()}
    rs = np.random.RandomState(7)

    def t(*shape, pos=False):
        a = rs.randn(*shape).astype(np.float32)
        return torch.tensor(np.abs(a) if pos else a)
    sd.update({
        "decode_head.convs.0.conv.weight": t(8, 32, 3, 3),
        "decode_head.convs.0.bn.weight": t(8),
        "decode_head.convs.0.bn.bias": t(8),
        "decode_head.convs.0.bn.running_mean": t(8),
        "decode_head.convs.0.bn.running_var": t(8, pos=True),
        "decode_head.conv_seg.weight": t(5, 8, 1, 1),
        "decode_head.conv_seg.bias": t(5)})
    path = str(tmp_path / "teacher.pth")
    torch.save({"state_dict": sd}, path)
    return path, sd


def _tiny_distill_cfg():
    from gaiaseg_tpu_torch.models import fill_img_size
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(TINY_DISTILL)
    fill_img_size(cfg)
    return cfg


# --------------------------------------------------------------------- #
def test_official_teacher_pth_loads_as_jax_loads_it(tmp_path):
    import jax
    from gaiaseg_tpu.engine.train import \
        load_teacher_checkpoint as j_load_teacher
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu.models import encode_arch as j_encode_arch
    from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
    from gaiaseg_tpu_torch.engine.convert import teacher_state_dict
    from gaiaseg_tpu_torch.utils import Config

    path, _ = teacher_pth(tmp_path)
    jcfg = Config.fromfile(TINY_DISTILL)["model"]
    jmodel = j_build_segmentor(jcfg)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jax.numpy.zeros((1, 64, 64, 3)),
        jax.numpy.zeros((1, 64, 64), jax.numpy.int32),
        j_encode_arch(j_model_max_arch(jcfg)), False,
        method="forward_train"))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    params, stats = j_load_teacher(path, zeros["params"],
                                   zeros["batch_stats"], jcfg)
    want = teacher_state_dict(jax.tree_util.tree_map(np.asarray, params),
                              jax.tree_util.tree_map(np.asarray, stats),
                              jcfg)

    cfg = _tiny_distill_cfg()
    model = build_segmentor(cfg["model"])
    init = {k: v.clone() for k, v in model.state_dict().items()}
    res = load_teacher_checkpoint(path, model)
    got = model.state_dict()
    assert res["kept_init"] and all(
        k.startswith("t_backbone.fpn") for k in res["kept_init"])
    for k in res["kept_init"]:
        assert torch.equal(got[k], init[k]), k
    assert set(res["loaded"]) == set(want) - set(res["kept_init"])
    for k in res["loaded"]:
        np.testing.assert_allclose(
            got[k].numpy(), want[k].numpy(), rtol=0,
            atol=1e-6 * float(want[k].abs().max()), err_msg=k)
    table = "t_backbone.blocks.1.attn.relative_position_bias_table"
    assert tuple(got[table].shape) == (15 ** 2 + 3, 2)


def test_official_teacher_fpn_deconvs_load_and_norm_warns(tmp_path,
                                                          caplog):
    """ROADMAP C15: a teacher segmentor's trained FPN adapters. The deconvs
    (``fpn1.0``, ``fpn1.3``, ``fpn2.0``) load bit-equal to the file's;
    ``fpn1.1``, a BN in the official layout and a LayerNorm in the port
    (and in JAX), keeps its init, and the load warns."""
    path, sd = teacher_pth(tmp_path)
    g = torch.Generator().manual_seed(5)
    fpn = {}
    for slot in ("fpn1.0", "fpn1.3", "fpn2.0"):
        fpn[f"backbone.{slot}.weight"] = torch.randn(32, 32, 2, 2,
                                                     generator=g)
        fpn[f"backbone.{slot}.bias"] = torch.randn(32, generator=g)
    for name in ("weight", "bias", "running_mean"):
        fpn[f"backbone.fpn1.1.{name}"] = torch.randn(32, generator=g)
    fpn["backbone.fpn1.1.running_var"] = torch.rand(32, generator=g) + 0.5
    fpn["backbone.fpn1.1.num_batches_tracked"] = torch.tensor(7)
    torch.save({"state_dict": dict(sd, **fpn)}, path)
    model = build_segmentor(_tiny_distill_cfg()["model"])
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level("WARNING", logger="gaiaseg_tpu_torch"):
        res = load_teacher_checkpoint(path, model)
    norm = ["t_backbone.fpn1.1.bias", "t_backbone.fpn1.1.weight"]
    assert res["kept_init"] == norm
    got = model.state_dict()
    for k in norm:
        assert torch.equal(got[k], init[k]), k
    for k, v in fpn.items():
        if ".fpn1.1." not in k:
            assert torch.equal(got["t_" + k], v), k
    assert any(r.levelname == "WARNING" and "kept at init" in r.message
               for r in caplog.records)

    # JAX's route maps none of the adapters: a zero template stays 0
    import jax
    from gaiaseg_tpu.engine.train import \
        load_teacher_checkpoint as j_load_teacher
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu.models import encode_arch as j_encode_arch
    from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
    from gaiaseg_tpu_torch.utils import Config
    jcfg = Config.fromfile(TINY_DISTILL)["model"]
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: j_build_segmentor(jcfg).init(
        {"params": k, "dropout": k}, jax.numpy.zeros((1, 64, 64, 3)),
        jax.numpy.zeros((1, 64, 64), jax.numpy.int32),
        j_encode_arch(j_model_max_arch(jcfg)), False,
        method="forward_train"))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    params, _ = j_load_teacher(path, zeros["params"], zeros["batch_stats"],
                               jcfg)
    adapters = {n: v for n, v in params["t_backbone"].items()
                if n.startswith("fpn")}
    assert sorted(adapters) == ["fpn1_deconv1", "fpn1_deconv2", "fpn1_norm",
                                "fpn2_deconv"]
    assert max(np.abs(np.asarray(x)).max()
               for x in jax.tree_util.tree_leaves(adapters)) == 0.0
    assert np.abs(np.asarray(params["t_backbone"]["cls_token"])).max() > 0


def test_teacher_loader_errors(tmp_path):
    path, sd = teacher_pth(tmp_path)
    no_head = distiller_cfg(BEIT_TEACHER)
    no_head.pop("teacher_decode_head")
    with pytest.raises(ValueError, match="no teacher_decode_head"):
        load_teacher_checkpoint(path, build_segmentor(no_head))
    bare = str(tmp_path / "bare.pth")
    torch.save({k: v for k, v in sd.items()
                if not k.startswith("decode_head.")}, bare)
    model = build_segmentor(distiller_cfg(BEIT_TEACHER))
    with pytest.raises(ValueError, match="no decode_head"):
        load_teacher_checkpoint(bare, model)
    load_teacher_checkpoint(bare, build_segmentor(no_head))
    short = str(tmp_path / "short.pth")
    torch.save({"state_dict": {k: v for k, v in model.state_dict().items()
                               if k.startswith("t_backbone.")}}, short)
    with pytest.raises(KeyError, match="lacks"):
        load_teacher_checkpoint(short, model)


def _trained_supernet(tmp_path):
    """A student supernet's checkpoint (seeded weights and statistics),
    written by the port's ``save_checkpoint``."""
    from gaiaseg_tpu_torch.engine import save_checkpoint
    plain = dict(type="DynamicEncoderDecoder", **copy.deepcopy(STUDENT))
    model = randomize(build_segmentor(plain), 3)
    src = str(tmp_path / "trained.pth")
    save_checkpoint(src, model, meta={"iter": 4})
    return src, model


def test_make_teacher_ckpt_loads_bit_equal(tmp_path, capsys):
    from gaiaseg_tpu_torch.tools import make_teacher_ckpt
    src, plain = _trained_supernet(tmp_path)
    dst = str(tmp_path / "teacher.pth")
    out = make_teacher_ckpt.main([src, dst])
    assert "teacher checkpoint written" in capsys.readouterr().out
    assert {k.split(".")[0] for k in out} == {"t_backbone", "t_decode_head"}
    model = build_segmentor(distiller_cfg(RESNET_TEACHER))
    student = {k: v.clone() for k, v in model.state_dict().items()
               if not k.startswith("t_")}
    res = load_teacher_checkpoint(dst, model)
    assert not res["kept_init"]
    got = model.state_dict()
    for k, v in plain.state_dict().items():
        if k.startswith(("backbone.", "decode_head.")):
            assert torch.equal(got["t_" + k], v), k
    for k, v in student.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError, match="no student entries"):
        make_teacher_ckpt.convert(dst, str(tmp_path / "again.pth"))


def test_jax_pth_route_leaves_a_resnet_teacher_at_init(tmp_path):
    """ROADMAP C13."""
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.engine.train import \
        load_teacher_checkpoint as j_load_teacher
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu.models import encode_arch as j_encode_arch
    from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
    src, plain = _trained_supernet(tmp_path)
    jcfg = distiller_cfg(RESNET_TEACHER)
    jmodel = j_build_segmentor(jcfg)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64), jnp.int32),
        j_encode_arch(j_model_max_arch(jcfg)), False,
        method="forward_train"))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    params, _ = j_load_teacher(src, zeros["params"], zeros["batch_stats"],
                               jcfg)
    moved = [np.abs(np.asarray(x)).max() for x in
             jax.tree_util.tree_leaves(params["t_backbone"])]
    assert max(moved) == 0.0          # nothing of the backbone was mapped
    assert max(np.abs(np.asarray(x)).max() for x in
               jax.tree_util.tree_leaves(params["t_decode_head"])) > 0.1
    model = build_segmentor(jcfg)
    load_teacher_checkpoint(src, model)
    assert torch.equal(model.t_backbone.conv1.weight,
                       plain.backbone.conv1.weight)


def test_tiny_distill_trains_through_the_cli(tmp_path):
    """JAX's test asks of both losses that some later row is below the
    first. At tiny_distill's 64x64 crop the student's top map is 2x2, and
    the pairwise loss sits near its floor (the teacher's row entropy) in
    both packages: over 48 steps at log interval 1 JAX's 8-step means read
    0.6656 -> 0.6666 and the port's 0.667 -> 0.671, so that row test is a
    draw. Here ``distill_loss_seg`` is held to it, the pairwise loss to be
    present and finite; ``test_distill_losses_fall_on_a_fixed_batch``
    shows both fall where the draw is out of the way."""
    from gaiaseg_tpu_torch.tools import train_supernet
    path, _ = teacher_pth(tmp_path, grid=8)
    work = str(tmp_path / "run")
    hist = train_supernet.main([TINY_DISTILL, "--device", "cpu",
                                "--work-dir", work, "--cfg-options",
                                f"teacher_checkpoint={path}"])
    rows = json.load(open(os.path.join(work, "history.json")))["loss"]
    assert rows == json.loads(json.dumps(hist["loss"]))
    assert len(rows) == 6 and rows[-1]["iter"] == 48
    distill = [r["distill_loss_seg"] for r in rows]
    assert min(distill[1:]) < distill[0], distill
    assert all(np.isfinite([r["pairwise_loss_seg"] for r in rows]))
    torch.manual_seed(0)              # the CLI's seed: the FPN's init
    model = build_segmentor(_tiny_distill_cfg()["model"])
    load_teacher_checkpoint(path, model)
    saved = torch.load(os.path.join(work, "iter_48.pth"),
                       weights_only=False)["state_dict"]
    for k, v in model.state_dict().items():
        if k.startswith("t_"):
            assert torch.equal(saved[k], v), k


def test_distill_losses_fall_on_a_fixed_batch():
    """30 SGD steps of the distiller (BEiT teacher, seeded) on one batch:
    both distillation losses fall, the pairwise one by a little at each
    reading (no dropout, no window: nothing drawn)."""
    from gaiaseg_tpu_torch.engine import build_optimizer, trainable_parameters
    from gaiaseg_tpu_torch.engine.train import train_step
    torch.manual_seed(0)
    cfg = distiller_cfg(BEIT_TEACHER)
    model = build_segmentor(cfg).train()
    randomize(model.t_backbone, 1)
    randomize(model.t_decode_head, 2)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(4, 3, 64, 64).astype(np.float32))
    gt = torch.from_numpy(rng.randint(0, 4, (4, 64, 64)).astype(np.int32))
    opt = build_optimizer(trainable_parameters(model, cfg),
                          dict(type="SGD", lr=0.05, momentum=0.9))
    arch = encode_arch(model_max_arch(cfg))
    seen = [train_step(model, opt, img, gt, arch) for _ in range(30)]
    pair = [float(s["pairwise_loss_seg"]) for s in seen]
    dist = [float(s["distill_loss_seg"]) for s in seen]
    assert pair[0] > pair[10] > pair[20] > pair[29], pair
    assert dist[0] > dist[10] > dist[20] > dist[29], dist


def _records(n, hw, seed):
    rng = np.random.RandomState(seed)
    return [{"img": rng.randint(0, 255, (hw, hw, 3)).astype(np.uint8),
             "gt": rng.randint(0, 4, (hw, hw)).astype(np.uint8)}
            for _ in range(n)]


def test_calibration_keeps_the_teacher_statistics():
    from gaiaseg_tpu_torch.engine import calibrate_bn
    cfg = distiller_cfg(RESNET_TEACHER)
    model = randomize(build_segmentor(cfg), 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calibrate_bn(model, _records(4, 64, 0), encode_arch(model_max_arch(cfg)),
                 num_batches=2, batch_size=2)
    after = model.state_dict()
    stats = [k for k in after if k.endswith("running_mean")]
    assert any(k.startswith("t_") for k in stats)
    for k in stats:
        assert torch.equal(after[k], before[k]) == k.startswith("t_"), k
    assert all(torch.equal(after[k], before[k]) for k in after
               if not k.endswith(("running_mean", "running_var",
                                  "num_batches_tracked")))


def _loop_cfg(tmp_path, iters):
    cfg = _tiny_distill_cfg()
    cfg.merge_from_dict({"runner.max_iters": iters,
                         "checkpoint_config.interval": 2,
                         "log_config.interval": 1,
                         "data.train.length": 4})
    return cfg


def test_resume_and_load_from_carry_the_teacher(tmp_path, monkeypatch):
    from gaiaseg_tpu_torch.engine import train as train_mod
    path, _ = teacher_pth(tmp_path, grid=8)
    cfg = _loop_cfg(tmp_path, 2)
    cfg["teacher_checkpoint"] = path
    work = str(tmp_path / "wd")
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"])
    train_mod.train_segmentor(model, cfg, work_dir=work, device="cpu")
    teacher = {k: v.clone() for k, v in model.state_dict().items()
               if k.startswith("t_")}
    calls = []
    real = train_mod.load_teacher_checkpoint
    monkeypatch.setattr(train_mod, "load_teacher_checkpoint",
                        lambda *a: calls.append(a) or real(*a))
    cfg["runner"]["max_iters"] = 4
    torch.manual_seed(1)
    resumed = build_segmentor(cfg["model"])
    train_mod.train_segmentor(resumed, cfg, work_dir=work, device="cpu",
                              resume_from=os.path.join(work, "iter_2.pth"))
    assert calls == []
    for k, v in teacher.items():
        assert torch.equal(resumed.state_dict()[k], v), k
    cfg["teacher_checkpoint"] = None
    torch.manual_seed(2)
    fresh = build_segmentor(cfg["model"])
    train_mod.train_segmentor(fresh, cfg, work_dir=None, device="cpu",
                              max_iters=1,
                              load_from=os.path.join(work, "iter_2.pth"))
    for k, v in teacher.items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_val_workflow_on_a_distiller_is_jax_s(tmp_path):
    """JAX's val step calls the distiller's ``forward_train`` without a
    ``train`` argument (it has none): train-mode BN, ``mutable=[]``."""
    import inspect
    import jax
    import jax.numpy as jnp
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu.models import encode_arch as j_encode_arch
    from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
    from gaiaseg_tpu_torch.data import parse_test_pipeline
    from gaiaseg_tpu_torch.data.transforms import prepare_eval_batch
    from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
    from gaiaseg_tpu_torch.engine.train import _ValPhase
    from test_torch_distill import model_cfg, seeded_variables

    cfg = distiller_cfg(BEIT_TEACHER)
    test_pipe = parse_test_pipeline(_tiny_distill_cfg()["data"]["val"]
                                    ["pipeline"])
    records = _records(2, 64, 4)
    img = prepare_eval_batch(
        torch.from_numpy(np.stack([r["img"] for r in records])),
        test_pipe.mean, test_pipe.std, dtype=torch.float32)
    gt = np.stack([r["gt"] for r in records]).astype(np.int32)
    img_nhwc = img.permute(0, 2, 3, 1).numpy()
    jcfg = model_cfg("beit", True)
    jmodel = j_build_segmentor(jcfg)
    assert "train" not in inspect.signature(jmodel.forward_train).parameters
    variables = seeded_variables(jmodel, jcfg, img_nhwc, gt, jax_init=False)
    k = jax.random.PRNGKey(0)
    (_, jlogs), mut = jax.jit(lambda v: jmodel.apply(
        v, jnp.asarray(img_nhwc), jnp.asarray(gt),
        j_encode_arch(j_model_max_arch(jcfg)), False,
        method=jmodel.forward_train, mutable=[], rngs={"dropout": k}))(
            variables)
    assert mut == {}
    want = float(jlogs["decode.loss_seg"])

    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(variables, cfg),
                          strict=True)
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    phase = _ValPhase(model, records, 2, test_pipe, None,
                      model_max_arch(cfg), torch.device("cpu"), 1)
    got = phase.run()
    assert got == pytest.approx(want, rel=1e-5)
    assert model.training and not model.t_backbone.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():            # eval mode reads another loss here
        eval_loss = float(model.eval().forward_train(
            img, torch.from_numpy(gt), encode_arch(model_max_arch(cfg)))[1]
            ["decode.loss_seg"])
    assert abs(eval_loss - want) > 1e-3 * want


def test_extract_and_flops_of_a_distiller_match_jax():
    import jax
    from gaiaseg_tpu.archspace.complexity import \
        get_model_complexity_info as j_complexity
    from gaiaseg_tpu.engine.extract import extract_subnet as j_extract
    from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
    from gaiaseg_tpu_torch.archspace import get_model_complexity_info
    from gaiaseg_tpu_torch.engine import extract_subnet
    from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
    from gaiaseg_tpu_torch.models.arch_util import canonical_arch
    from test_torch_distill import META, model_cfg, seeded_variables
    jcfg = model_cfg("beit", True)
    rng = np.random.RandomState(0)
    img = rng.randn(1, 64, 64, 3).astype(np.float32)
    gt = np.zeros((1, 64, 64), np.int32)
    variables = seeded_variables(j_build_segmentor(jcfg), jcfg, img, gt,
                                 jax_init=False)
    cfg = distiller_cfg(BEIT_TEACHER)
    sd = variables_to_state_dict(variables, cfg)
    j_sub_cfg, j_vars, j_arch = j_extract(jcfg, variables, META,
                                          img_size=(64, 64))
    sub_cfg, sub_sd, arch = extract_subnet(cfg, sd, META)
    assert arch == j_arch and sub_cfg["type"] == "DynamicDistiller"
    want = variables_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          j_vars), sub_cfg)
    assert set(sub_sd) == set(want)
    for key, t in want.items():
        assert torch.equal(sub_sd[key], t), key
    sub = build_segmentor(sub_cfg).eval()
    sub.load_state_dict(sub_sd, strict=True)
    sup = build_segmentor(cfg).eval()
    sup.load_state_dict(sd, strict=True)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        assert torch.equal(sub.whole_inference(x, encode_arch(
            model_max_arch(sub_cfg))), sup.whole_inference(
                x, encode_arch(model_max_arch(cfg), META)))
    for meta in (None, META):
        a = canonical_arch(model_max_arch(cfg), meta)
        assert get_model_complexity_info(cfg, a, (3, 512, 1024)) == \
            j_complexity(jcfg, a, (3, 512, 1024)), meta


# --------------------------------------------------------------------- #
SGD = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=5e-4)


def _step_inputs():
    rng = np.random.RandomState(21)
    img = rng.randn(8, 128, 128, 3)
    gt = rng.randint(0, 4, (8, 128, 128)).astype(np.int32)
    gt[rng.rand(8, 128, 128) < 0.2] = 255
    return img, gt


def _distill_step(rank, world, model_cfg, state):
    from gaiaseg_tpu_torch import parallel
    from gaiaseg_tpu_torch.engine import build_optimizer, trainable_parameters
    from gaiaseg_tpu_torch.engine.train import train_step
    model = build_segmentor(model_cfg)
    model.load_state_dict(state)
    model.double().train()
    optimizer = build_optimizer(trainable_parameters(model, model_cfg), SGD)
    img, gt = _step_inputs()
    n = img.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    logs = train_step(model, optimizer,
                      torch.from_numpy(img[rows].transpose(0, 3, 1, 2)
                                       .copy()),
                      torch.from_numpy(gt[rows]),
                      encode_arch(model_max_arch(model_cfg)),
                      torch.Generator().manual_seed(3), max_norm=5.0)
    return {"state": model.state_dict(),
            "momentum": {k: optimizer.state[p]["momentum_buffer"]
                         for k, p in model.named_parameters()
                         if p in optimizer.state},
            "logs": {k: parallel.sum_over_ranks(v) for k, v in logs.items()
                     if k != "grad_norm"}}


def test_distill_step_two_ranks_equal_one_process(tmp_path):
    cfg = distiller_cfg(BEIT_TEACHER, img_size=128)
    state = randomize(build_segmentor(cfg), 5).state_dict()
    ranks = run_ranks(_distill_step, tmp_path, cfg, state)
    one = _distill_step(0, 1, cfg, state)
    assert float(one["logs"]["pairwise_loss_seg"]) > 0
    for k, v in one["logs"].items():
        for r in ranks:
            assert float(r["logs"][k]) == pytest.approx(float(v), rel=1e-6,
                                                        abs=0), k
    for key, want in list(one["state"].items()) + [
            (f"momentum {k}", v) for k, v in one["momentum"].items()]:
        for r in ranks:
            got = r["momentum"][key[9:]] if key.startswith("momentum ") \
                else r["state"][key]
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=0,
                atol=1e-10 * max(float(want.abs().max()), 1e-30),
                err_msg=key)
    assert not any(k.startswith("t_") for k in one["momentum"])
