"""What the loops share: the run's config, the archs whose conv shapes
cover what the config's sampler can draw, device syncs and set-up marks."""
from __future__ import annotations

import itertools
import os
import sys
import time
from typing import Any, Dict, Iterator, List

import torch

from ..lib.spec import ROOT


class Marks:
    """Set-up's phases, printed to standard error as they end."""

    def __init__(self, t_start: float):
        self.t = t_start

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        print(f"set-up: {what} in {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_dtype(device: torch.device) -> torch.dtype:
    """The activations' dtype, in which the program draws its dropout:
    bf16 under the card's autocast, float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def program_config(config: Dict[str, Any]):
    """The configuration as the CLI would load it: the repository's config
    files in order (each deep-merged over the ones before), then the
    benchmark configuration's dot-key ``overrides``."""
    from gaiaseg_tpu_torch.utils import Config
    from gaiaseg_tpu_torch.utils.config import _merge_a_into_b
    merged: Dict[str, Any] = {}
    for path in config["repo_configs"]:
        merged = _merge_a_into_b(Config.fromfile(os.path.join(ROOT, path))
                                 .to_dict(), merged)
    cfg = Config(merged, filename=os.path.join(ROOT,
                                               config["repo_configs"][0]))
    cfg.merge_from_dict(dict(config.get("overrides") or {}))
    return cfg


def _range_nodes(cfg: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    if cfg.get("type") == "range":
        yield cfg
    for key in ("model_samplers",):
        for sub in cfg.get(key) or []:
            yield from _range_nodes(sub)
    if cfg.get("model_sampler"):
        yield from _range_nodes(cfg["model_sampler"])


def _grid(start, end, step) -> List[int]:
    vals = list(range(int(start), int(end) + 1, int(step)))
    return vals if vals[-1] == end else vals + [int(end)]


def warm_archs(sampler_cfg: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Metas over every width the sampler's ranges can draw (each list of
    per-stage widths in every allowed combination), at the ranges' least
    depths: a conv's shape depends on the widths of its input and output,
    not on the depth."""
    choices = {}
    for node in _range_nodes(sampler_cfg):
        key, start, end, step = (node["key"], node["start"], node["end"],
                                 node["step"])
        if not key.endswith("width"):
            choices[key] = [start]
        elif isinstance(start, (list, tuple)):
            grids = [_grid(*t) for t in zip(start, end, step)]
            combos = itertools.product(*[range(len(g)) for g in grids])
            if node.get("ascending"):
                combos = (c for c in combos if list(c) == sorted(c))
            choices[key] = [[g[i] for g, i in zip(grids, c)] for c in combos]
        else:
            choices[key] = _grid(start, end, step)
    keys = sorted(choices)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*[choices[k] for k in keys])]
