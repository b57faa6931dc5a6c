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

SMALL = {  # the published layouts at widths a CPU counts quickly
    "psp": {"repo_configs": ["configs/local_examples/train_supernet/"
                             "pspnet_ar50to101v2_gsync.py"],
            "overrides": {"model.backbone.body_depth": [2, 2, 3, 2]},
            "hw": (64, 128)},
    "vit": {"repo_configs": ["configs/_dynamic_/models/upernet_elastic_vit.py",
                             "configs/_dynamic_/datasets/ade20k.py"],
            "overrides": {"model.backbone.depth": 4,
                          "model.backbone.out_indices": [0, 1, 2, 3],
                          "model.decode_head.num_classes": 150,
                          "model.auxiliary_head.num_classes": 150},
            "hw": (128, 128)},
}


def _port(name):
    from gaiaseg_tpu_torch.models import build_segmentor
    c = SMALL[name]
    cfg = program_config(c)
    if name == "vit":
        cfg["model"]["backbone"]["img_size"] = c["hw"][0]
    return cfg, build_segmentor(cfg["model"]).eval(), c["hw"]


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("which", ["MAX", "MIN", "random"])
def test_mac_counter_matches_flop_counter(name, which):
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    cfg, model, hw = _port(name)
    model_cfg = cfg.to_dict()["model"]
    metas = schedule.sampler_metas(cfg["train_sampler"], 8)
    meta = {"MAX": metas[0], "MIN": metas[1], "random": metas[-1]}[which]
    if name == "psp":   # within the reduced depths
        meta = dict(meta, **{"arch.backbone.body.depth": [2, 1, 3, 1]})
    else:
        meta = dict(meta, **{"arch.backbone.encoder.depth": 3})
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
