"""Tensor parallelism around the step: a 2 data x 2 model mesh, the
checkpoints and the train CLI.

- A step on 4 gloo ranks as 2 data x 2 model equals one process's at the
  same global batch (float64, within 1e-6 of each tensor's max: BN, the
  loss mean and the gradient all-reduce span the data axis only); the
  same step with the data axis's reductions planted on the world group
  counts each sample twice and must not.
- Every other family's tiny config (DeepLabV3+, ConvNeXt, Conformer,
  SegFormer, the BEiT-teacher distiller) takes a MAX step on 2 ranks at
  K = 2 (every sharded weight gathered on use; Conformer's FFN in
  Megatron pairs) as one process does, in float64.
- Checkpoints: a file saved under tensor parallelism holds full shapes and
  loads into one process bit-equal (weights, BN statistics, momentum); a
  one-process file resumes under tensor parallelism bit-equal, and the next
  step equals one process's.
- A teacher file loads into a sharded distiller's teacher as it loads into
  one process's.
- ``train_supernet --model-parallel 2 --profile 2`` on 2 processes of
  ``configs/tests/tiny_synthetic.py`` (JAX's ``1 << 16`` gate lowered to 1
  in the ranks, so its convs shard) logs one process's losses at the same global batch (two
  steps: the tiny net's gradient norm leaves the clip's range by the
  fourth, where float32 roundings grow), calibrates and evaluates the
  anchors as one process does, writes a trace a rank and a full-shape
  checkpoint; a world that K does not divide raises.
"""
import os

import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch import parallel
from test_torch_parallel import TINY, _free_port, run_ranks
from test_torch_tensor_parallel import (FLAGSHIP_SUB, FLAGSHIP_TINY, SGD,
                                        VIT, _step_inputs, _tp_step)

torch.set_num_threads(1)
F64_RTOL = 1e-6


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()) \
        / max(float(want.double().abs().max()), 1e-30)


@pytest.mark.parametrize("plant", [False, True], ids=["data_axis",
                                                      "planted_world_group"])
def test_two_by_two_mesh_equals_one_process(plant, tmp_path):
    from gaiaseg_tpu_torch.models import build_segmentor
    torch.manual_seed(0)
    state = build_segmentor(FLAGSHIP_TINY).double().state_dict()
    one = _tp_step(0, 1, FLAGSHIP_TINY, state, FLAGSHIP_SUB, 1)
    ranks = run_ranks(_tp_step, tmp_path, FLAGSHIP_TINY, state, FLAGSHIP_SUB,
                      2, 1, plant, world=4)
    worst = max(_rel(r["state"][k], v) for r in ranks
                for k, v in one["state"].items()
                if v.dtype.is_floating_point)
    loss_rel = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    if plant:
        assert worst > 1e-3 and loss_rel > 1e-3, (worst, loss_rel)
        return
    assert worst <= F64_RTOL and loss_rel <= F64_RTOL, (worst, loss_rel)
    for r in ranks:     # the same shards on both data indices
        assert r["report"] == ranks[0]["report"] and r["report"]
        assert r["grads_equal"] == [True]


@pytest.mark.parametrize("family", ["deeplabv3plus", "convnext",
                                    "conformer", "segformer",
                                    "beit_teacher"])
def test_every_family_steps_at_model_parallel_2_as_one_process(family,
                                                               tmp_path):
    from gaiaseg_tpu_torch.models import build_segmentor
    from test_torch_tensor_parallel import _family_cfgs
    cfg, _, hw = _family_cfgs()[family]
    torch.manual_seed(0)
    state = build_segmentor(cfg).double().state_dict()
    one = _tp_step(0, 1, cfg, state, None, 1, hw=hw)
    ranks = run_ranks(_tp_step, tmp_path, cfg, state, None, 2, 1, False, hw)
    for r in ranks:
        assert len(r["report"]) > 10 and r["grads_equal"] == [True]
        assert r["loss"] == pytest.approx(one["loss"], rel=F64_RTOL)
        for k, v in one["state"].items():
            if v.dtype.is_floating_point:
                assert _rel(r["state"][k], v) <= F64_RTOL, k
    routes = {v[2] for v in ranks[0]["report"].values()}
    assert routes == ({"gather", "column", "row"} if family == "conformer"
                      else {"gather"})


# --------------------------------------------------------------------- #
def _one_step(model, optimizer, arch):
    from gaiaseg_tpu_torch.engine.train import train_step
    img, gt = _step_inputs()
    d, n_data = parallel.data_parallel()
    n = img.shape[0] // n_data
    rows = slice(d * n, (d + 1) * n)
    train_step(model, optimizer,
               torch.from_numpy(img[rows].transpose(0, 3, 1, 2).copy())
               .double(), torch.from_numpy(gt[rows]), arch)


def _model_and_optimizer(state, k):
    from gaiaseg_tpu_torch.engine import optim
    from gaiaseg_tpu_torch.models import build_segmentor
    model = build_segmentor(VIT)
    model.load_state_dict(state)
    model.double().train()
    parallel.shard_state(model, parallel.make_mesh(k), min_size=1)
    return model, optim.build_optimizer(model.parameters(), SGD)


def _full_state(model, optimizer):
    from gaiaseg_tpu_torch.parallel import mesh
    opt = mesh.gather_optimizer_state(optimizer)
    names = [n for n, _ in model.named_parameters()]
    return {k: v.clone() for k, v in mesh.gather_state_dict(model).items()}, {
        names[i]: st["momentum_buffer"].clone()
        for i, st in opt["state"].items()}


def _ckpt_ranks(rank, world, tmp, state, one_path):
    from gaiaseg_tpu_torch.engine import load_checkpoint, save_checkpoint
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    arch = encode_arch(model_max_arch(VIT))
    model, opt = _model_and_optimizer(state, 2)
    _one_step(model, opt, arch)
    saved = _full_state(model, opt)
    save_checkpoint(os.path.join(tmp, "tp.pth"), model, opt,
                    meta={"iter": 1}, write=rank == 0)
    parallel.barrier()
    # the one-process file, resumed here, then one more step
    model, opt = _model_and_optimizer(state, 2)
    meta = load_checkpoint(one_path, model, opt)
    resumed = _full_state(model, opt)
    _one_step(model, opt, arch)
    return {"saved": saved, "resumed": resumed, "meta": meta,
            "stepped": _full_state(model, opt),
            "shard_shapes": {n: tuple(p.shape) for n, p in
                             model.named_parameters()}}


def test_checkpoints_load_across_model_parallel_sizes(tmp_path):
    from gaiaseg_tpu_torch.engine import load_checkpoint, save_checkpoint
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    torch.manual_seed(0)
    state = build_segmentor(VIT).double().state_dict()
    arch = encode_arch(model_max_arch(VIT))
    model, opt = _model_and_optimizer(state, 1)
    _one_step(model, opt, arch)
    one_path = str(tmp_path / "one.pth")
    save_checkpoint(one_path, model, opt, meta={"iter": 1})
    ranks = run_ranks(_ckpt_ranks, tmp_path, str(tmp_path), state, one_path)

    # the TP file: full shapes, one process loads it bit-equal
    ckpt = torch.load(tmp_path / "tp.pth", weights_only=False)
    assert {k: tuple(v.shape) for k, v in ckpt["state_dict"].items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    fresh, fresh_opt = _model_and_optimizer(state, 1)
    assert load_checkpoint(str(tmp_path / "tp.pth"), fresh,
                           fresh_opt) == {"iter": 1}
    got_state, got_mom = _full_state(fresh, fresh_opt)
    for r in ranks:
        for k, v in r["saved"][0].items():
            assert torch.equal(got_state[k], v), k
        for k, v in r["saved"][1].items():
            assert torch.equal(got_mom[k], v), f"momentum {k}"
    # the one-process file under TP: bit-equal, then the next step
    want_state, want_mom = _full_state(model, opt)
    _one_step(model, opt, arch)
    stepped_state, stepped_mom = _full_state(model, opt)
    sharded = [n for n, s in ranks[0]["shard_shapes"].items()
               if s != tuple(state[n].shape)]
    assert sharded
    for r in ranks:
        assert r["meta"] == {"iter": 1}
        for k, v in want_state.items():
            assert torch.equal(r["resumed"][0][k], v), k
        for k, v in want_mom.items():
            assert torch.equal(r["resumed"][1][k], v), f"momentum {k}"
        for k, v in stepped_state.items():
            assert _rel(r["stepped"][0][k], v) <= F64_RTOL, k
        for k, v in stepped_mom.items():
            assert _rel(r["stepped"][1][k], v) <= F64_RTOL, f"momentum {k}"


def _teacher_ranks(rank, world, cfg, path):
    from gaiaseg_tpu_torch.engine.teacher import load_teacher_checkpoint
    from gaiaseg_tpu_torch.models import build_segmentor
    from gaiaseg_tpu_torch.parallel import mesh
    torch.manual_seed(1)
    model = build_segmentor(cfg)
    parallel.shard_state(model, parallel.make_mesh(2), min_size=1)
    loaded = load_teacher_checkpoint(path, model)
    return {"loaded": loaded, "state": mesh.gather_state_dict(model),
            "report": parallel.shard_report(model)}


def test_teacher_file_loads_into_a_sharded_distiller(tmp_path):
    from gaiaseg_tpu_torch.models import build_segmentor
    from test_torch_tensor_parallel import _family_cfgs
    cfg = _family_cfgs()["beit_teacher"][0]
    torch.manual_seed(0)
    teacher = {k: v for k, v in build_segmentor(cfg).state_dict().items()
               if k.startswith("t_")}
    path = str(tmp_path / "teacher.pth")
    torch.save({"state_dict": teacher}, path)
    ranks = run_ranks(_teacher_ranks, tmp_path, cfg, path)
    assert any(k.startswith("t_") for k in ranks[0]["report"])
    for r in ranks:
        assert r["loaded"]["loaded"] == sorted(teacher)
        for k, v in teacher.items():
            assert torch.equal(r["state"][k], v), k


# --------------------------------------------------------------------- #
def _cli(rank, world, port, work_dir):
    from gaiaseg_tpu_torch.engine import train
    from gaiaseg_tpu_torch.tools import train_supernet
    train.DEFAULT_MIN_SIZE = 1      # the tiny convs are below JAX's gate
    shard, reports = train.shard_state, []

    def recorded(model, mesh, min_size):
        shard(model, mesh, min_size)
        reports.append(parallel.shard_report(model))
        return model
    train.shard_state = recorded
    hist = train_supernet.main([
        TINY, "--work-dir", work_dir, "--max-iters", "2", "--device", "cpu",
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
        "--process-id", str(rank), "--model-parallel", "2", "--profile",
        "2", "--cfg-options", *CLI_OPTIONS])
    return dict(hist, sharded=len(reports[0]))


CLI_OPTIONS = ("log_config.interval=1", "evaluation.interval=2",
               "checkpoint_config.interval=2")


def test_train_cli_at_model_parallel_2_logs_one_process_s_losses(tmp_path):
    from gaiaseg_tpu_torch.tools import train_supernet
    wd = tmp_path / "tp"
    ranks = run_ranks(_cli, tmp_path, str(wd), join_group=False,
                      timeout=180)
    one = train_supernet.main([
        TINY, "--work-dir", str(tmp_path / "one"), "--max-iters", "2",
        "--device", "cpu", "--cfg-options", "data.samples_per_gpu=2",
        *CLI_OPTIONS])
    rows = [(h["iter"], h["arch"], h["lr"]) for h in one["loss"]]
    assert rows == [(h["iter"], h["arch"], h["lr"])
                    for h in ranks[0]["loss"]] and len(rows) == 2
    for r in ranks:
        for h, w in zip(r["loss"], one["loss"]):
            assert h["loss"] == pytest.approx(w["loss"], rel=1e-5)
        evals = r["eval"][0]["metrics"]
        assert set(evals) == {"MIN", "MAX"}
        for name, m in one["eval"][0]["metrics"].items():
            assert evals[name]["mIoU"] == pytest.approx(m["mIoU"], abs=1e-6)
    assert sorted(os.listdir(wd / "trace")) == ["rank0.json", "rank1.json"]
    assert ranks[0]["sharded"] == ranks[1]["sharded"] > 10
    ckpt = torch.load(wd / "iter_2.pth", weights_only=False)
    ref = torch.load(tmp_path / "one" / "iter_2.pth", weights_only=False)
    assert {k: v.shape for k, v in ckpt["state_dict"].items()} == \
        {k: v.shape for k, v in ref["state_dict"].items()}


def test_model_parallel_must_divide_the_world_and_needs_a_group(tmp_path):
    from gaiaseg_tpu_torch.tools import train_supernet
    with pytest.raises(ValueError, match="does not divide"):
        train_supernet.main([TINY, "--device", "cpu", "--max-iters", "1",
                             "--model-parallel", "2", "--work-dir",
                             str(tmp_path / "wd")])
    mesh = parallel.make_mesh(1)
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        parallel.make_mesh(0)
