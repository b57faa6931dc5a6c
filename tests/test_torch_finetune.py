"""The port's fast-finetune slice against the JAX package.

- The slice as a whole (after ``test_torch_train.py``
  ``test_three_sgd_steps_match_jax``): three fine-tune steps of one anchor
  from the same supernet ``.pth`` through JAX's ``train_segmentor`` (which
  reads the port's file with its own ``load_torch_segmentor``) and the
  port's, with the ft2e optimizer (``schedule_ft2e.py``: SGD, momentum 0.9,
  weight decay 1e-4, clip 20, step LR) and its per-sample ``lr_scaler``.
  Two changes make three steps tell: the per-sample base LR is 5e-3 (ft2e's
  1.875e-4 moves a weight by less than the tolerance) and the LR steps at
  iteration 2 (ft2e's 1500 is past the run). Weights and BN statistics end
  within 1e-4 of each tensor's max (float32, dropout 0). The images are
  ``(x - 128) / 64`` of uint8 pixels, which bf16 (the JAX loop's image
  dtype) holds exactly, so both loops see the same numbers.
- ``tools/finetune_supernet.py`` (``--device cpu``): the subnets it trains
  are JAX's ``ModelSpace`` + rules on the same space; the second subnet of
  a sweep ends bit-equal to that subnet fine-tuned alone, from a checkpoint
  without the aux head (so a model kept from the first subnet would keep
  its trained aux head); the rows carry the metric tag; a rerun skips the
  finished subnets.
- Fault C2: a ``CrossEntropyLoss`` whose ``class_weight``, ``use_sigmoid``
  or ``reduction`` is set after construction takes the unfused loss.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from gaiaseg_tpu.archspace import ModelSpace as JModelSpace
from gaiaseg_tpu.archspace import build_sample_rule as j_build_rule
from gaiaseg_tpu.engine import optim as joptim
from gaiaseg_tpu.engine import train as jtrain
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu_torch.engine import save_checkpoint
from gaiaseg_tpu_torch.engine import train as ptrain
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.models.segmentors import encoder_decoder
from gaiaseg_tpu_torch.tools import count_flops, finetune_supernet
from gaiaseg_tpu_torch.utils import Config

from test_torch_segmentor import METAS, model_cfg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")
FT2E = os.path.join(REPO, "configs", "_dynamic_", "schedules",
                    "schedule_ft2e.py")
JAX_DEVICES = len(jax.devices())     # the JAX loop's batch spans them all
EXACT_NORM = dict(mean=[128.0] * 3, std=[64.0] * 3)


def _ft2e_cfg(jax_side: bool, ckpt: str):
    ft = Config.fromfile(FT2E).to_dict()
    pipeline = [dict(type="RandomCrop", crop_size=(32, 32)),
                dict(type="Normalize", **EXACT_NORM)]
    cfg = dict(
        model=model_cfg(jax_side), log_config=dict(interval=1),
        optimizer=ft["optimizer"], optimizer_config=ft["optimizer_config"],
        lr_config=dict(ft["lr_config"], step=[2]),
        lr_scaler=dict(ft["lr_scaler"], base_lr=5e-3),
        runner=dict(type="IterBasedRunner", max_iters=3),
        checkpoint_config=dict(interval=1000),
        load_from=ckpt,
        # one global batch of 8: JAX's samples_per_gpu is per device
        data=dict(samples_per_gpu=1 if jax_side else JAX_DEVICES,
                  train=dict(type="SyntheticDataset", length=16,
                             size=(32, 32), num_classes=7, cells=4,
                             pipeline=pipeline)))
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_three_finetune_steps_match_jax(tmp_path):
    ckpt = str(tmp_path / "supernet.pth")
    torch.manual_seed(0)
    save_checkpoint(ckpt, build_segmentor(model_cfg(False)),
                    meta={"iter": 0})
    anchor = dict(type="anchor", anchors=[dict(METAS["random"],
                                               name="sub")])
    from gaiaseg_tpu.archspace import build_model_sampler as j_sampler
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    jcfg = _ft2e_cfg(True, ckpt)
    jstate, jhist = jtrain.train_segmentor(
        j_build_segmentor(jcfg["model"]), jcfg, work_dir=str(tmp_path / "j"),
        train_sampler=j_sampler(anchor), load_from=ckpt)
    cfg = _ft2e_cfg(False, ckpt)
    torch.manual_seed(1)                 # other weights until the load
    model = build_segmentor(cfg["model"])
    start = {k: v.clone() for k, v in torch.load(
        ckpt, weights_only=False)["state_dict"].items()}
    state, hist = ptrain.train_segmentor(
        model, cfg, device="cpu", train_sampler=build_model_sampler(anchor),
        load_from=ckpt)
    assert state.step == int(jstate.step) == 3
    base = 5e-3 * JAX_DEVICES
    assert joptim.scale_lr(jcfg["optimizer"]["lr"], JAX_DEVICES,
                           jcfg["lr_scaler"]) == base
    jlr = joptim.build_lr_schedule(jcfg["lr_config"], base, 3)
    want_lrs = [float(jlr(i)) for i in range(3)]
    assert want_lrs == pytest.approx([base, base, 0.2 * base])
    assert [r["lr"] for r in hist["loss"]] == pytest.approx(want_lrs,
                                                            rel=1e-6)
    assert len(jhist["loss"]) == 3
    assert [r["arch"] for r in hist["loss"]] == ["sub"] * 3
    want = variables_to_state_dict({"params": _np(jstate.params),
                                    "batch_stats": _np(jstate.batch_stats)},
                                   cfg["model"])
    got = model.state_dict()
    assert set(got) == set(want)
    moved = 0.0
    for key, w in want.items():
        scale = float(w.abs().max())
        assert float((got[key] - w).abs().max()) <= 1e-4 * scale, key
        if scale > 0:
            moved = max(moved, float((w - start[key]).abs().max()) / scale)
    assert moved > 1e-2          # the three steps moved the weights


# ------------------------------------------------------------------------ #
RULES = dict(type="sequential", rules=[
    dict(func_str="lambda x: 0.9e6 <= x['overhead.flops'] <= 1.1e6"),
    dict(type="sample", operation="random", value=3, mode="number"),
])


@pytest.fixture(scope="module")
def space(tmp_path_factory):
    """The tiny config's FLOPs space (514 subnets) and a supernet ``.pth``
    without the aux head."""
    wd = tmp_path_factory.mktemp("space")
    count_flops.main([TINY, "--work-dir", str(wd)], log=lambda s: None)
    cfg = Config.fromfile(TINY)
    torch.manual_seed(0)
    sd = build_segmentor(cfg["model"]).state_dict()
    ckpt = str(wd / "no_aux.pth")
    torch.save({"meta": {"iter": 1}, "state_dict": {
        k: v for k, v in sd.items()
        if not k.startswith("auxiliary_head.")}}, ckpt)
    return dict(path=str(wd / "flops.json"), ckpt=ckpt)


def _finetune(space, work_dir, *extra):
    return finetune_supernet.main(
        [TINY, space["ckpt"], "--model-space", space["path"],
         "--work-dir", str(work_dir), "--device", "cpu", "--max-iters", "2",
         "--cfg-options", "log_config.interval=1",
         f"model_sampling_rules={json.dumps(RULES)}", *extra])


def _metas(rows):
    return [{k: v for k, v in r.items() if k != "metric"} for r in rows]


def test_finetune_selects_jax_subnets_and_restarts(space, tmp_path,
                                                    monkeypatch):
    rows = _finetune(space, tmp_path, "--metric-tag", "ft")
    want = JModelSpace.load(space["path"]).apply_rule(
        j_build_rule(RULES)).pack()
    assert len(want) == 3 and _metas(rows) == want
    assert all(np.isfinite(r["metric"]["ft"]["mIoU"]) for r in rows)
    with open(tmp_path / "fastft_metrics.json") as f:
        assert json.load(f) == rows
    for i in range(3):
        hist = json.load(open(tmp_path / f"subnet_{i}" / "history.json"))
        assert [r["arch"] for r in hist["loss"]] == [f"subnet_{i}"] * 2
    # a rerun finds every subnet done: nothing trained or scored again
    import gaiaseg_tpu_torch.engine as engine
    calls = []
    for name in ("train_segmentor", "evaluate"):
        monkeypatch.setattr(engine, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    assert _finetune(space, tmp_path, "--metric-tag", "ft") == rows
    assert not calls


def test_second_subnet_is_unaffected_by_the_first(space, tmp_path):
    rows = _finetune(space, tmp_path / "sweep")
    alone_space = dict(space, path=str(tmp_path / "one.json"))
    with open(alone_space["path"], "w") as f:
        json.dump([_metas(rows)[1]], f)
    finetune_supernet.main(
        [TINY, space["ckpt"], "--model-space", alone_space["path"],
         "--work-dir", str(tmp_path / "alone"), "--device", "cpu",
         "--max-iters", "2", "--cfg-options", "log_config.interval=1",
         "model_sampling_rules=null"])
    swept = torch.load(tmp_path / "sweep" / "subnet_1" / "iter_2.pth",
                       weights_only=False)["state_dict"]
    alone = torch.load(tmp_path / "alone" / "subnet_0" / "iter_2.pth",
                       weights_only=False)["state_dict"]
    first = torch.load(tmp_path / "sweep" / "subnet_0" / "iter_2.pth",
                       weights_only=False)["state_dict"]
    assert set(swept) == set(alone)
    assert all(torch.equal(swept[k], alone[k]) for k in swept)
    key = "auxiliary_head.convs.0.conv.weight"
    assert not torch.equal(first[key], alone[key])


# ------------------------------------------------------------------------ #
@pytest.mark.parametrize("attr,value,fused", [
    (None, None, 2), ("class_weight", [1.0] * 7, 1), ("use_sigmoid", True, 1),
    ("reduction", "sum", 1)])
def test_loss_gate_checks_every_option(monkeypatch, attr, value, fused):
    """Decode logits 4x4 and aux 8x8 at a 32x32 label: both losses pass
    the fused gate until an option the fused kernel does not compute is
    set on the decode loss."""
    calls = []
    real = encoder_decoder.fused_resize_ce

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(encoder_decoder, "fused_resize_ce", spy)
    torch.manual_seed(0)
    model = build_segmentor(model_cfg(False))
    if attr is not None:
        setattr(model.loss_decode, attr, value)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 32, 32).astype(np.float32))
    gt = torch.from_numpy(rng.randint(0, 7, (2, 32, 32)).astype(np.int32))
    total, _ = model.forward_train(img, gt, encode_arch(model_max_arch(
        model_cfg(False))))
    assert len(calls) == fused and torch.isfinite(total)
