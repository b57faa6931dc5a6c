"""The frozen yardsticks against what they stand for, on the CPU: the MAC
counter against ``torch.utils.flop_counter.FlopCounterMode`` over the
port's plain forward pass, and the loss kernels' bound against
``chip_smoke.py``'s at the flagship's loss shapes."""
from __future__ import annotations

import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.loops.common import program_config  # noqa: E402
from benchmark.lib.macs import model_macs  # noqa: E402
from benchmark.lib.peaks import resize_ce_bound_s  # noqa: E402
from benchmark.reference import schedule  # noqa: E402
from benchmark.tests import cases  # noqa: E402


def _port(name):
    from gaiaseg_tpu_torch.models import build_segmentor
    small = cases.load(name)["small"]
    cfg = program_config(small)
    return cfg, build_segmentor(cfg["model"]).eval(), tuple(small["hw"])


@pytest.mark.parametrize("name", cases.names())
@pytest.mark.parametrize("which", ["MAX", "MIN", "random"])
def test_mac_counter_matches_flop_counter(name, which):
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    cfg, model, hw = _port(name)
    model_cfg = cfg.to_dict()["model"]
    metas = schedule.sampler_metas(cfg["train_sampler"], 8)
    meta = {"MAX": metas[0], "MIN": metas[1], "random": metas[-1]}[which]
    meta = dict(meta, **cases.load(name)["mac_depth_cut"])
    x = torch.randn((1, 3) + hw)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.encode_decode(x, encode_arch(model_max_arch(model_cfg), meta))
    ours = model_macs(model_cfg, schedule.arch_of(
        schedule.max_arch(model_cfg), meta), hw, train=False)
    assert counter.get_total_flops() == 2 * ours


@pytest.mark.parametrize("head", [((8, 19, 16, 32), (8, 512, 1024)),
                                  ((8, 19, 32, 64), (8, 512, 1024)),
                                  ((16, 150, 128, 128), (16, 512, 512)),
                                  ((16, 150, 32, 32), (16, 512, 512))])
@pytest.mark.parametrize("fwd", [True, False])
def test_loss_bound_matches_chip_smoke(head, fwd):
    import chip_smoke
    logit, label = head
    gen = torch.Generator().manual_seed(0)
    lab = torch.randint(0, logit[1], label, generator=gen, dtype=torch.int32)
    lab[:, ::7] = 255
    n, c, h, _ = logit
    mid = torch.zeros((n, h, c, label[2]))
    ref = chip_smoke._bound(mid, lab, fwd)
    ours = resize_ce_bound_s(logit, label, int((lab != 255).sum()), fwd)
    assert ours * 1e3 == pytest.approx(max(ref["bytes_ms"], ref["ops_ms"]),
                                       rel=1e-12)
