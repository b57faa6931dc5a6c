"""What a run draws, worked out again from the seed and the config: the
sandwich sampler's archs, the loader's record order, each batch's
augmentation draws, and the learning rate of each iteration.

Plain Python, NumPy and PyTorch; nothing of the program is imported. The
semantics are those the configs state (mmseg's sandwich rule, an infinite
shuffled sampler, mmcv's poly schedule and linear warmup); the stream
layouts are the port's documented ones: every range sampler of the
config draws from its own ``numpy.random.RandomState(0)``, epoch ``e`` is
shuffled by ``RandomState(seed + e)``, and a batch's augmentation is one
``torch.rand(B, 2T + 12)`` from a CPU generator seeded by the seed.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from . import parts as model_parts

MAX_TRIALS = 10


def _grid(start: int, end: int, step: int) -> List[int]:
    vals = list(range(int(start), int(end) + 1, int(step)))
    if vals[-1] != end:
        vals.append(int(end))
    return vals


class Sampler:
    """One node of a sampler config (anchor, range, composite, repeat,
    concat). Every node draws from its own ``RandomState``: seeded 0, as
    the config's train sampler, or, given ``seed``, ``seed + k`` for the
    k-th node in the order of the config."""

    def __init__(self, cfg: Dict[str, Any], seed: Optional[int] = None,
                 _count: Optional[List[int]] = None):
        count = [0] if _count is None else _count
        self.kind = cfg["type"]
        self.rng = np.random.RandomState(
            0 if seed is None else (seed + count[0]) % (1 << 32))
        count[0] += 1
        if self.kind == "anchor":
            self.anchors = [copy.deepcopy(a) for a in cfg["anchors"]]
            self.cursor = 0
            self.len = len(self.anchors)
        elif self.kind == "range":
            self.key, self.ascending = cfg["key"], cfg.get("ascending", False)
            s, e, st = cfg["start"], cfg["end"], cfg["step"]
            self.is_list = isinstance(s, (list, tuple))
            self.grids = [_grid(*t) for t in zip(s, e, st)] if self.is_list \
                else [_grid(s, e, st)]
            self.len = 1
        elif self.kind == "composite":
            self.parts = [Sampler(c, seed, count)
                          for c in cfg["model_samplers"]]
            self.len = 1
        elif self.kind == "repeat":
            self.inner = Sampler(cfg["model_sampler"], seed, count)
            self.len = int(cfg["times"]) * self.inner.len
        elif self.kind == "concat":
            self.parts = [Sampler(c, seed, count)
                          for c in cfg["model_samplers"]]
            self.cursor = 0
            self.len = sum(p.len for p in self.parts)
        else:
            raise ValueError(f"sampler type {self.kind!r}")

    def sample(self) -> Dict[str, Any]:
        if self.kind == "anchor":
            a = self.anchors[self.cursor]
            self.cursor = (self.cursor + 1) % self.len
            return copy.deepcopy(a)
        if self.kind == "range":
            idx = [self.rng.randint(len(g)) for g in self.grids]
            if self.ascending and self.is_list:
                idx = sorted(idx)
            vals = [g[i] for g, i in zip(self.grids, idx)]
            return {self.key: vals if self.is_list else vals[0]}
        if self.kind == "composite":
            out: Dict[str, Any] = {}
            for p in self.parts:
                out.update(p.sample())
            return out
        if self.kind == "repeat":
            return self.inner.sample()
        index = self.cursor
        self.cursor = (self.cursor + 1) % self.len
        for p in self.parts:
            if index < p.len:
                return p.sample()
            index -= p.len
        raise IndexError(index)


def sampler_metas(sampler_cfg: Dict[str, Any], n: int) -> List[Dict]:
    """The first ``n`` draws of the config's train sampler."""
    s = Sampler(sampler_cfg)
    return [s.sample() for _ in range(n)]


def arch_of(max_arch: Dict[str, Any], meta: Dict[str, Any]) -> Dict:
    """A flat ``'arch.backbone.x.y'`` meta over the MAX arch template."""
    arch = copy.deepcopy(max_arch)
    for key, value in meta.items():
        parts = key.split(".")
        if parts[0] != "arch":
            continue
        node = arch
        for p in parts[1:-1]:
            node = node[p]
        node[parts[-1]] = copy.deepcopy(value)
    return arch


def max_arch(model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    bb = model_cfg["backbone"]
    return {"backbone": model_parts.get(bb["type"], "backbone").max_arch(bb)}


def record_order(n_records: int, batch: int, seed: int) -> Iterator[list]:
    """Batches of record indices: an infinite stream of epochs, epoch ``e``
    shuffled by ``RandomState(seed + e)``."""
    buf: list = []
    epoch = 0
    while True:
        idx = np.arange(n_records)
        np.random.RandomState(seed + epoch).shuffle(idx)
        buf.extend(idx.tolist())
        epoch += 1
        while len(buf) >= batch:
            yield buf[:batch]
            del buf[:batch]


def augment_draws(generator: torch.Generator, batch: int,
                  ratio_range, flip_prob: float) -> Dict[str, torch.Tensor]:
    """One batch's augmentation numbers: the scale, T crop trials, the flip
    coin, then six photometric coins and four photometric values."""
    t = MAX_TRIALS
    u = torch.rand(batch, 2 * t + 12, generator=generator,
                   dtype=torch.float32)
    coin = u[:, 2 * t + 2:2 * t + 8] < 0.5

    def span(col, lo, hi):
        return lo + (hi - lo) * u[:, col]
    return {"scale": span(0, *ratio_range),
            "trials": u[:, 1:1 + 2 * t].reshape(batch, t, 2),
            "flip": u[:, 2 * t + 1] < flip_prob,
            "bright_on": coin[:, 0], "contrast_pre_on": coin[:, 1],
            "contrast_post_on": coin[:, 2], "contrast_first": coin[:, 3],
            "sat_on": coin[:, 4], "hue_on": coin[:, 5],
            "bright": span(2 * t + 8, -32.0, 32.0),
            "alpha": span(2 * t + 9, 0.5, 1.5),
            "sat": span(2 * t + 10, 0.5, 1.5),
            "hue": span(2 * t + 11, -18.0, 18.0)}


def scaled_lr(cfg: Dict[str, Any], global_batch: int) -> float:
    lr = float(cfg["optimizer"].get("lr", 0.01))
    scaler = cfg.get("lr_scaler")
    if scaler:
        lr = float(scaler.get("base_lr", lr)) * global_batch
    return lr


def lr_at(cfg: Dict[str, Any], it: int, global_batch: int) -> float:
    """mmcv's poly schedule over ``runner.max_iters``, after its linear
    warmup when the config has one."""
    base = scaled_lr(cfg, global_batch)
    lrc = cfg["lr_config"]
    total = int(cfg["runner"]["max_iters"])
    if lrc.get("warmup") == "linear" and it < int(lrc["warmup_iters"]):
        ratio = float(lrc.get("warmup_ratio", 0.1))
        return base * (ratio + (1 - ratio) * it / int(lrc["warmup_iters"]))
    power, min_lr = float(lrc.get("power", 0.9)), float(lrc.get("min_lr", 0))
    frac = min(max(1.0 - it / total, 0.0), 1.0)
    return min_lr + (base - min_lr) * frac ** power
