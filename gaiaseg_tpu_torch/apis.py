"""The reference's ``gaiaseg.apis`` names (a port of ``gaiaseg_tpu/apis.py``):
users of GAIA-seg keep their import sites."""
from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from .engine import (evaluate, inference_segmentor, init_segmentor,
                     show_result, train_segmentor)
from .engine.evaluate import cross_arch_evaluate, evaluate_population

__all__ = [
    "train_segmentor", "set_random_seed", "init_segmentor",
    "inference_segmentor", "show_result", "show_result_pyplot",
    "single_gpu_test", "multi_gpu_test", "evaluate", "cross_arch_evaluate",
    "evaluate_population",
]


def set_random_seed(seed: int, deterministic: bool = False) -> None:
    """Seed Python's, numpy's and torch's generators (reference
    apis/train.py:30-45); ``deterministic`` also asks cuDNN for
    deterministic algorithms and turns its benchmark mode off."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def single_gpu_test(model, dataset, arch, **kw):
    """The eval loop of one process (reference apis/test.py:13-65): the
    metrics dict of ``evaluate``, whose predictions never leave the card."""
    return evaluate(model, dataset, arch, **kw)


def multi_gpu_test(model, dataset, arch, **kw):
    """The reference's sharded eval (apis/test.py:68-186); on one card it is
    ``evaluate``."""
    return evaluate(model, dataset, arch, **kw)


def show_result_pyplot(img, seg_map, palette=None, opacity=0.5,
                       out_file: Optional[str] = None):
    return show_result(img, seg_map, palette, opacity, out_file)
