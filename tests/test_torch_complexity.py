"""The port's analytic FLOPs/params and its FLOPs sweep against JAX's.

- ``get_model_complexity_info``: equal (``==``, no tolerance) FLOPs and
  params, with and without ``only_backbone_flops``, on every one of the 514
  subnets of ``configs/tests/tiny_synthetic.py``, on a seeded sample of
  2,000 of the 597,051 subnets of the flagship FLOPs sampler, and at the
  ViT config's MAX and MIN.
- The analytic ``params`` equals ``sum(p.numel())`` of the port's model
  built at the arch (on the ``meta`` device), at the flagship's extraction
  anchors and sampled subnets.
- ``tools/count_flops.py``: the port's and JAX's, on the tiny config in 2
  shards, write equal ``flops.json`` files, row for row.
"""
import importlib.util
import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch

from gaiaseg_tpu.archspace.complexity import \
    get_model_complexity_info as j_complexity
from gaiaseg_tpu.models.arch_util import canonical_arch as j_canonical_arch
from gaiaseg_tpu_torch.archspace import (build_model_sampler,
                                         get_model_complexity_info)
from gaiaseg_tpu_torch.engine import subnet_model_cfg
from gaiaseg_tpu_torch.models import build_segmentor
from gaiaseg_tpu_torch.models.arch_util import canonical_arch, \
    model_max_arch
from gaiaseg_tpu_torch.tools import count_flops
from gaiaseg_tpu_torch.utils import Config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")
FLOPS = os.path.join(REPO, "configs", "local_examples", "count_flops",
                     "psp_ar50to101v2_flops.py")
VIT = os.path.join(REPO, "configs", "_dynamic_", "models",
                   "upernet_elastic_vit.py")
EXTRACT = os.path.join(REPO, "configs", "local_examples", "extract_subnet")
FLAGSHIP_SPACE = 597051
SAMPLE = 2000


def _shape(meta, default):
    shape = meta.get("data.input_shape", default)
    return (3, shape, shape * 2) if isinstance(shape, int) else tuple(shape)


def _assert_equal_counts(model_cfg, metas, default_shape):
    max_arch = model_max_arch(model_cfg)
    for meta in metas:
        arch = canonical_arch(max_arch, meta)
        assert arch == j_canonical_arch(max_arch, meta)
        shape = _shape(meta, default_shape)
        for only in (False, True):
            got = get_model_complexity_info(model_cfg, arch, shape, only)
            want = j_complexity(model_cfg, arch, shape, only)
            assert got == want, (meta, only)


def test_tiny_space_counts_equal_jax():
    cfg = Config.fromfile(TINY)
    sampler = build_model_sampler(cfg["train_sampler"])
    metas = list(sampler.traverse())
    assert len(metas) == 514
    _assert_equal_counts(cfg["model"], metas, (3, 32, 32))


def _flagship_members(flat):
    """Members ``flat`` (indices) of the flagship sampler's traversal, read
    from the Cartesian product of its sub-samplers, as
    ``CompositeSampler.traverse`` enumerates it."""
    sampler = build_model_sampler(Config.fromfile(FLOPS)["train_sampler"])
    parts = [list(s.traverse()) for s in sampler.samplers]
    sizes = [len(p) for p in parts]
    assert int(np.prod(sizes)) == FLAGSHIP_SPACE
    metas = []
    for idx in zip(*np.unravel_index(flat, sizes)):
        meta = {}
        for part, i in zip(parts, idx):
            meta.update(part[i])
        metas.append(meta)
    return metas


def _flagship_sample(n, seed=0):
    """``n`` distinct subnets of the flagship space, seeded, in traversal
    order."""
    return _flagship_members(np.sort(np.random.RandomState(seed).choice(
        FLAGSHIP_SPACE, n, replace=False)))


def test_flagship_sample_counts_equal_jax():
    cfg = Config.fromfile(FLOPS)
    head = list(itertools.islice(
        build_model_sampler(cfg["train_sampler"]).traverse(), 400))
    assert _flagship_members(np.arange(400)) == head
    metas = _flagship_sample(SAMPLE)
    assert len({json.dumps(m, sort_keys=True) for m in metas}) == SAMPLE
    _assert_equal_counts(cfg["model"], metas,
                         tuple(cfg["data_cfg"]["input_shape"]))


def test_vit_counts_equal_jax():
    cfg = Config.fromfile(VIT)
    metas = list(build_model_sampler(cfg["val_sampler"]).traverse())
    assert [m["name"] for m in metas] == ["MIN", "MAX"]
    _assert_equal_counts(cfg["model"], metas, (3, 512, 512))


@pytest.mark.parametrize("config", [
    os.path.join(EXTRACT, "psp_ar50to101_extract.py"),
    os.path.join(EXTRACT, "psp_specific_extract.py"), FLOPS])
def test_analytic_params_count_the_built_subnet(config):
    """The extraction anchors (R50, R101; RSPECIFIC) and 4 sampled
    subnets of the FLOPs space. No allocation: the subnet is built on the
    ``meta`` device."""
    cfg = Config.fromfile(config)
    metas = _flagship_sample(4, seed=1) if config == FLOPS else \
        list(build_model_sampler(cfg["train_sampler"]).traverse())
    max_arch = model_max_arch(cfg["model"])
    for meta in metas:
        arch = canonical_arch(max_arch, meta)
        with torch.device("meta"):
            sub = build_segmentor(subnet_model_cfg(cfg["model"], arch))
        want = get_model_complexity_info(cfg["model"], arch, (3, 512, 1024))
        assert sum(p.numel() for p in sub.parameters()) == want["params"]
        if meta.get("name") == "R50":      # 48,956,262 (23,508,032 backbone)
            assert want["params"] == 48956262 and sum(
                p.numel() for p in sub.backbone.parameters()) == 23508032


def _jax_count_flops(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_count_flops", os.path.join(REPO, "tools", "count_flops.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["count_flops.py"] + argv)
    mod.main()


def test_count_flops_cli_equals_jax(tmp_path, monkeypatch):
    lines = []
    for tool, out in (("port", tmp_path / "port"), ("jax", tmp_path / "jax")):
        for shard in (1, 0):       # shard 0 merges what is there
            argv = [TINY, "--work-dir", str(out), "--shard-id", str(shard),
                    "--num-shards", "2"]
            if tool == "port":
                n, seconds = count_flops.main(argv, log=lines.append)
                assert n == 257 and seconds >= 0
            else:
                _jax_count_flops(argv, monkeypatch)
    for shard in (0, 1):
        assert (tmp_path / "port" / f"flops.json.{shard}").read_text() == \
            (tmp_path / "jax" / f"flops.json.{shard}").read_text()
    port = json.loads((tmp_path / "port" / "flops.json").read_text())
    assert port == json.loads((tmp_path / "jax" / "flops.json").read_text())
    assert len(port) == 514 and all(
        set(r) == {"name", "arch", "data", "overhead"} or
        set(r) == {"arch", "data", "overhead"} for r in port)
    assert any("subnets/s" in line for line in lines)
