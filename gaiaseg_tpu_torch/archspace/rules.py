"""Declarative model-space query rules (sequential/parallel/sample/merge).

A copy of ``gaiaseg_tpu/archspace/rules.py``, registered in the port's own
``RULES`` registry so that ``type=`` strings resolve here.

Behavioral contract reconstructed from the reference rule configs
(reference configs/_dynamic_/rules/ar50to101v2_rules.py: lambda-string
filters, parallel scale/depth groups, random sample-10-per-group, merge;
ar50to101v2_ft1x_rules.py: top-k by metric) and use sites
(reference tools/test_supernet.py:201, finetune_supernet.py:253).

A rule pipeline transforms a list of row-dict *groups*; ``apply_rule`` on a
ModelSpace starts from one group holding every subnet meta (flattened keys
like ``overhead.flops``), and returns the surviving metas.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

from ..utils.registry import RULES

Row = Dict[str, Any]
Groups = List[List[Row]]


def build_sample_rule(cfg: Dict[str, Any]) -> "BaseRule":
    cfg = copy.deepcopy(dict(cfg))
    if "type" not in cfg:
        cfg["type"] = "func"
    return RULES.build(cfg)


class BaseRule:
    def apply_groups(self, groups: Groups) -> Groups:
        raise NotImplementedError

    def apply(self, rows: Sequence[Row]) -> List[Row]:
        """Apply to a flat list of metas; merges any remaining groups."""
        groups = self.apply_groups([list(rows)])
        out: List[Row] = []
        for g in groups:
            out.extend(g)
        return out

    def __call__(self, rows: Sequence[Row]) -> List[Row]:
        return self.apply(rows)


@RULES.register_module(name=["func", "FuncRule"])
class FuncRule(BaseRule):
    """Row filter compiled from a lambda string, e.g.
    ``"lambda x: x['overhead.flops'] <= 140*1e9"``
    (reference rules/ar50to101v2_rules.py:6)."""

    def __init__(self, func_str: str):
        self.func_str = func_str
        self._fn: Callable[[Row], bool] = eval(func_str, {"np": np})  # noqa: S307
        if not callable(self._fn):
            raise TypeError(f"func_str did not evaluate to a callable: {func_str!r}")

    def apply_groups(self, groups: Groups) -> Groups:
        return [[r for r in g if self._fn(r)] for g in groups]


@RULES.register_module(name=["sequential", "SequentialRule"])
class SequentialRule(BaseRule):
    def __init__(self, rules: Sequence[Dict[str, Any]]):
        self.rules = [build_sample_rule(c) for c in rules]

    def apply_groups(self, groups: Groups) -> Groups:
        for r in self.rules:
            groups = r.apply_groups(groups)
        return groups


@RULES.register_module(name=["parallel", "ParallelRule"])
class ParallelRule(BaseRule):
    """Fans each incoming group out into one group per sub-rule
    (reference rules/ar50to101v2_rules.py:8-28: scale × depth buckets)."""

    def __init__(self, rules: Sequence[Dict[str, Any]]):
        self.rules = [build_sample_rule(c) for c in rules]

    def apply_groups(self, groups: Groups) -> Groups:
        out: Groups = []
        for g in groups:
            for r in self.rules:
                out.extend(r.apply_groups([list(g)]))
        return out


@RULES.register_module(name=["sample", "SampleRule"])
class SampleRule(BaseRule):
    """Per-group subsampling: ``operation='random'`` uniform without
    replacement, or ``operation='top'`` by ``key`` descending; ``value``
    counts rows when ``mode='number'`` or a fraction when ``mode='ratio'``
    (reference rules/ar50to101v2_rules.py:30-35, ft1x_rules.py:7-14)."""

    def __init__(self, operation: str, value: float, mode: str = "number",
                 key: str = None, seed: int = 0):
        assert operation in ("random", "top"), operation
        assert mode in ("number", "ratio"), mode
        self.operation = operation
        self.value = value
        self.mode = mode
        self.key = key
        self._rng = np.random.RandomState(seed)

    def _count(self, n: int) -> int:
        if self.mode == "number":
            return min(int(self.value), n)
        return max(1, int(round(self.value * n))) if n else 0

    def apply_groups(self, groups: Groups) -> Groups:
        out: Groups = []
        for g in groups:
            k = self._count(len(g))
            if not g or k == 0:
                out.append([])
            elif self.operation == "random":
                idx = self._rng.choice(len(g), size=k, replace=False)
                out.append([g[i] for i in sorted(idx)])
            else:
                ranked = sorted(g, key=lambda r: r.get(self.key, float("-inf")),
                                reverse=True)
                out.append(ranked[:k])
        return out


@RULES.register_module(name=["merge", "MergeRule"])
class MergeRule(BaseRule):
    def apply_groups(self, groups: Groups) -> Groups:
        merged: List[Row] = []
        for g in groups:
            merged.extend(g)
        return [merged]
