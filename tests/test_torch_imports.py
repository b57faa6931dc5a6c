"""The port stands alone: no jax, no gaiaseg_tpu, and no quiet CPU fallback.

- Importing every module of gaiaseg_tpu_torch (and chip_smoke.py) in a fresh
  interpreter loads neither ``jax`` nor any ``gaiaseg_tpu`` module.
- Entry points asked for ``cuda`` on a machine without a card raise.
- chip_smoke.py exits non-zero, printing no result, without a card or
  without the rest of the repository beside it.
"""
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "local_examples", "train_supernet",
                        "pspnet_ar50to101v2_gsync.py")

torch.set_num_threads(1)

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import gaiaseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gaiaseg_tpu_torch.__path__,
                                               "gaiaseg_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "gaiaseg_tpu"
             or m.startswith("gaiaseg_tpu.") or m == "flax" or m == "optax")
print(",".join(names), bad)
"""

# modules of the elastic-ViT slice, which the walk must reach
VIT_MODULES = {
    "gaiaseg_tpu_torch.ops.cuda.flash_attention",
    "gaiaseg_tpu_torch.models.backbones.elastic_transformer",
    "gaiaseg_tpu_torch.models.necks",
    "gaiaseg_tpu_torch.models.necks.multilevel_neck",
    "gaiaseg_tpu_torch.models.decode_heads.uper_head",
}


# modules of the data-pipeline slice
DATA_MODULES = {
    "gaiaseg_tpu_torch.data.datasets", "gaiaseg_tpu_torch.data.device_cache",
    "gaiaseg_tpu_torch.data.loader", "gaiaseg_tpu_torch.data.metrics",
    "gaiaseg_tpu_torch.data.packed", "gaiaseg_tpu_torch.data.pipeline_cfg",
    "gaiaseg_tpu_torch.data.staging", "gaiaseg_tpu_torch.data.transforms",
    "gaiaseg_tpu_torch.native", "gaiaseg_tpu_torch.native.build",
    "gaiaseg_tpu_torch.tools.pack_dataset",
}


# modules of the slice around the train step and of eval
LOOP_MODULES = {
    "gaiaseg_tpu_torch.engine.calibrate", "gaiaseg_tpu_torch.engine.checkpoint",
    "gaiaseg_tpu_torch.engine.inference", "gaiaseg_tpu_torch.apis",
    "gaiaseg_tpu_torch.archspace.model_space",
    "gaiaseg_tpu_torch.archspace.rules", "gaiaseg_tpu_torch.utils.sweep",
    "gaiaseg_tpu_torch.tools.test_supernet",
}


# modules of the subnet-tools slice
SUBNET_MODULES = {
    "gaiaseg_tpu_torch.archspace.complexity",
    "gaiaseg_tpu_torch.engine.extract",
    "gaiaseg_tpu_torch.engine.label_surgery",
    "gaiaseg_tpu_torch.tools.count_flops",
    "gaiaseg_tpu_torch.tools.extract_subnet",
    "gaiaseg_tpu_torch.tools.finetune_supernet",
}


# modules of the data-parallel slice
PARALLEL_MODULES = {
    "gaiaseg_tpu_torch.parallel", "gaiaseg_tpu_torch.parallel.distributed",
    "gaiaseg_tpu_torch.parallel.mesh",
    "gaiaseg_tpu_torch.parallel.tensor_parallel",
}


# modules of the DeepLabV3+ / v1c slice
DEEPLAB_MODULES = {
    "gaiaseg_tpu_torch.models.decode_heads.aspp_head",
    "gaiaseg_tpu_torch.models.losses.cross_entropy",
    "gaiaseg_tpu_torch.engine.optim",
}


# modules of the distillation slice
DISTILL_MODULES = {
    "gaiaseg_tpu_torch.models.backbones.beit",
    "gaiaseg_tpu_torch.models.segmentors.dynamic_distiller",
    "gaiaseg_tpu_torch.models.losses.dice_focal",
    "gaiaseg_tpu_torch.engine.ckpt_surgery",
    "gaiaseg_tpu_torch.engine.teacher",
    "gaiaseg_tpu_torch.tools.make_teacher_ckpt",
}


# modules of the ConvNeXt / Conformer / relative-position slice
BACKBONE_MODULES = {
    "gaiaseg_tpu_torch.models.backbones.dynamic_convnext",
    "gaiaseg_tpu_torch.models.backbones.elastic_convformer",
    "gaiaseg_tpu_torch.ops.dropout",
    "gaiaseg_tpu_torch.ops.dynamic_layers",
    "gaiaseg_tpu_torch.engine.convert",
}


# modules of the SegFormer / losses / small-CLIs slice
SEGFORMER_MODULES = {
    "gaiaseg_tpu_torch.models.backbones.elastic_mixvit",
    "gaiaseg_tpu_torch.models.decode_heads.segformer_head",
    "gaiaseg_tpu_torch.models.losses.eql",
    "gaiaseg_tpu_torch.tools.image_demo",
    "gaiaseg_tpu_torch.tools.mean_std",
}


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(repo=REPO)],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.split(" ", 1)
    names = set(names.split(","))
    want = VIT_MODULES | DATA_MODULES | LOOP_MODULES | SUBNET_MODULES \
        | PARALLEL_MODULES | DEEPLAB_MODULES | DISTILL_MODULES \
        | BACKBONE_MODULES | SEGFORMER_MODULES
    assert len(names) >= 30 and want <= names, want - names
    assert bad.strip() == "[]", bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_train_cli():
    from gaiaseg_tpu_torch.tools import train_supernet
    train_supernet.main([FLAGSHIP, "--max-iters", "1"])


def _entry_train_segmentor():
    from gaiaseg_tpu_torch.engine import train_segmentor
    train_segmentor(torch.nn.Linear(1, 1), {"model": {}}, device="cuda")


def _entry_evaluate():
    from gaiaseg_tpu_torch.engine import evaluate
    evaluate(None, [], {}, device="cuda")


def _entry_test_supernet_cli():
    from gaiaseg_tpu_torch.tools import test_supernet
    test_supernet.main([FLAGSHIP, "missing.pth", "--work-dir", "unused"])


def _entry_init_segmentor():
    from gaiaseg_tpu_torch.engine import init_segmentor
    init_segmentor(FLAGSHIP, device="cuda")


def _entry_population():
    from gaiaseg_tpu_torch.engine import evaluate_population
    evaluate_population(None, [], [], device="cuda")


def _entry_extract_cli():
    from gaiaseg_tpu_torch.tools import extract_subnet
    extract_subnet.main([FLAGSHIP, "missing.pth", "--work-dir", "unused"])


def _entry_finetune_cli():
    from gaiaseg_tpu_torch.tools import finetune_supernet
    finetune_supernet.main([FLAGSHIP, "missing.pth", "--work-dir", "unused"])


def _entry_image_demo_cli():
    from gaiaseg_tpu_torch.tools import image_demo
    image_demo.main([FLAGSHIP, "missing.pth", "missing.png"])


def _entry_mean_std_cli():
    from gaiaseg_tpu_torch.tools import mean_std
    mean_std.main([FLAGSHIP])


@pytest.mark.parametrize("entry", [_entry_train_cli, _entry_train_segmentor,
                                   _entry_evaluate, _entry_test_supernet_cli,
                                   _entry_init_segmentor, _entry_population,
                                   _entry_extract_cli, _entry_finetune_cli,
                                   _entry_image_demo_cli,
                                   _entry_mean_std_cli])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


def test_train_raises_without_cuda_before_it_touches_the_dataset(
        no_cuda, monkeypatch):
    """The flagship's Cityscapes root is missing here; the CLI and the loop
    must fail on the card first, without building a dataset."""
    from gaiaseg_tpu_torch.data import datasets
    from gaiaseg_tpu_torch.engine import train
    from gaiaseg_tpu_torch.tools import train_supernet
    from gaiaseg_tpu_torch.utils import Config

    def touched(*args, **kw):
        raise AssertionError("the dataset was built before the device")

    monkeypatch.setattr(datasets.DATASETS, "build", touched)
    monkeypatch.setattr(train, "build_dataset", touched)
    with pytest.raises(RuntimeError, match="cuda"):
        train_supernet.main([FLAGSHIP, "--max-iters", "1"])
    cfg = Config.fromfile(FLAGSHIP).to_dict()
    with pytest.raises(RuntimeError, match="cuda"):
        train.train_segmentor(torch.nn.Linear(1, 1), cfg, device="cuda")


def test_count_flops_runs_without_a_device(no_cuda, tmp_path):
    """The sweep is analytic: no tensor, no device, no ``--device``."""
    from gaiaseg_tpu_torch.tools import count_flops
    tiny = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")
    n, _ = count_flops.main([tiny, "--work-dir", str(tmp_path)],
                            log=lambda s: None)
    assert n == 514 and (tmp_path / "flops.json").is_file()
    with pytest.raises(SystemExit):
        count_flops.parse_args([tiny, "--work-dir", "x", "--device", "cpu"])


def _run_smoke(cwd, env_extra):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env_extra})


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
