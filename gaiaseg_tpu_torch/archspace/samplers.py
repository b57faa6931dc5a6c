"""Model samplers: anchor / range / candidate / composite / repeat / concat.

Behavioral contract reconstructed from reference config shapes
(reference configs/_dynamic_/model_samplers/ar50to101v2.py:55-116,
ar50to101v2_flops.py:58-78) and use sites (SURVEY.md §2.9
``build_model_sampler``): samplers yield flat dot-keyed metas
(``{'arch.backbone.body.depth': [...], 'name': 'R50'}``), support per-iter
cycling draws (the "sandwich rule": a concat of 5 anchors + 3 random draws
cycles one meta per train iteration) and a ``traverse`` mode enumerating the
whole space (reference tools/extract_subnet.py:105-106, count_flops.py:119).

A copy of ``gaiaseg_tpu/archspace/samplers.py``. Host-side control plane
only — sampling never touches the device. The draws stay on numpy's
``RandomState`` (not a ``torch.Generator``) so that one seed gives the port
and the JAX package the same arch sequence.
"""
from __future__ import annotations

import copy
import itertools
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from ..utils.registry import SAMPLERS


def build_model_sampler(cfg: Dict[str, Any]) -> "BaseSampler":
    cfg = copy.deepcopy(dict(cfg))
    return SAMPLERS.build(cfg)


class BaseSampler:
    """Cycling sampler. ``sample()`` returns the next meta in the cycle;
    ``traverse()`` deterministically enumerates the space."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)
        self._mode = "sample"

    def set_mode(self, mode: str) -> None:
        assert mode in ("sample", "traverse"), mode
        self._mode = mode

    @property
    def mode(self) -> str:
        return self._mode

    def reseed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    @property
    def cycle_len(self) -> int:
        """Number of draws before the sampler wraps around one full cycle."""
        return 1

    def sample(self) -> Dict[str, Any]:
        raise NotImplementedError

    def traverse(self) -> Iterator[Dict[str, Any]]:
        raise NotImplementedError

    def anchor_name(self, index: int) -> str:
        return f"subnet_{index}"

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self._mode == "traverse":
            return self.traverse()
        def _gen():
            while True:
                yield self.sample()
        return _gen()


@SAMPLERS.register_module(name=["anchor", "AnchorSampler"])
class AnchorSampler(BaseSampler):
    """Cycles through a fixed list of named archs
    (reference ar50to101v2.py:103-116 val_sampler)."""

    def __init__(self, anchors: Sequence[Dict[str, Any]], seed: int = 0):
        super().__init__(seed)
        self.anchors = [dict(a) for a in anchors]
        self._cursor = 0

    @property
    def cycle_len(self) -> int:
        return len(self.anchors)

    def anchor_name(self, index: int) -> str:
        return self.anchors[index % len(self.anchors)].get(
            "name", f"anchor_{index}")

    def sample(self) -> Dict[str, Any]:
        meta = copy.deepcopy(self.anchors[self._cursor])
        self._cursor = (self._cursor + 1) % len(self.anchors)
        return meta

    def traverse(self) -> Iterator[Dict[str, Any]]:
        for a in self.anchors:
            yield copy.deepcopy(a)


def _grid(start, end, step) -> List[Any]:
    """Inclusive arithmetic grid start..end by step (scalar)."""
    vals = list(range(int(start), int(end) + 1, int(step)))
    if vals[-1] != end and end not in vals:
        vals.append(int(end))
    return vals


@SAMPLERS.register_module(name=["range", "RangeSampler"])
class RangeSampler(BaseSampler):
    """Samples one value (scalar or per-stage list) from an arithmetic grid
    (reference ar50to101v2.py:2-20).

    ``ascending=True`` (list-valued keys only): the per-stage grid indices of
    one random draw are sorted non-decreasing, so later stages widen at least
    as much relatively — traverse still enumerates the full Cartesian grid
    (SURVEY.md counts the space as 3^4, i.e. unconstrained enumeration).
    """

    def __init__(self, key: str, start, end, step, ascending: bool = False,
                 seed: int = 0):
        super().__init__(seed)
        self.key = key
        self.ascending = ascending
        if isinstance(start, (list, tuple)):
            self.grids = [_grid(s, e, st) for s, e, st in zip(start, end, step)]
            self.is_list = True
        else:
            self.grids = [_grid(start, end, step)]
            self.is_list = False

    def sample(self) -> Dict[str, Any]:
        idx = [self._rng.randint(len(g)) for g in self.grids]
        if self.ascending and self.is_list:
            idx = sorted(idx)
        vals = [g[min(i, len(g) - 1)] for g, i in zip(self.grids, idx)]
        return {self.key: vals if self.is_list else vals[0]}

    def traverse(self) -> Iterator[Dict[str, Any]]:
        for combo in itertools.product(*self.grids):
            yield {self.key: list(combo) if self.is_list else combo[0]}


@SAMPLERS.register_module(name=["candidate", "CandidateSampler"])
class CandidateSampler(BaseSampler):
    """Uniform choice over explicit candidates
    (reference ar50to101v2_flops.py:1-4 ``data.input_shape`` candidates)."""

    def __init__(self, key: str, candidates: Sequence[Any], seed: int = 0):
        super().__init__(seed)
        self.key = key
        self.candidates = list(candidates)

    def sample(self) -> Dict[str, Any]:
        return {self.key: copy.deepcopy(
            self.candidates[self._rng.randint(len(self.candidates))])}

    def traverse(self) -> Iterator[Dict[str, Any]]:
        for c in self.candidates:
            yield {self.key: copy.deepcopy(c)}


@SAMPLERS.register_module(name=["composite", "CompositeSampler"])
class CompositeSampler(BaseSampler):
    """Merges one draw from each sub-sampler into a single meta; traverse is
    the Cartesian product of the sub-spaces (reference ar50to101v2.py:83-98)."""

    def __init__(self, model_samplers: Sequence[Dict[str, Any]], seed: int = 0):
        super().__init__(seed)
        self.samplers = [build_model_sampler(c) for c in model_samplers]

    def sample(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {}
        for s in self.samplers:
            meta.update(s.sample())
        return meta

    def traverse(self) -> Iterator[Dict[str, Any]]:
        iters = [list(s.traverse()) for s in self.samplers]
        for combo in itertools.product(*iters):
            meta: Dict[str, Any] = {}
            for part in combo:
                meta.update(copy.deepcopy(part))
            yield meta


@SAMPLERS.register_module(name=["repeat", "RepeatSampler"])
class RepeatSampler(BaseSampler):
    """Contributes ``times`` consecutive draws of the inner sampler per cycle
    (reference ar50to101v2.py:79-99: repeat×3 of a composite random sampler)."""

    def __init__(self, times: int, model_sampler: Dict[str, Any], seed: int = 0):
        super().__init__(seed)
        self.times = int(times)
        self.sampler = build_model_sampler(model_sampler)

    @property
    def cycle_len(self) -> int:
        return self.times * self.sampler.cycle_len

    def sample(self) -> Dict[str, Any]:
        return self.sampler.sample()

    def traverse(self) -> Iterator[Dict[str, Any]]:
        return self.sampler.traverse()


@SAMPLERS.register_module(name=["concat", "ConcatSampler"])
class ConcatSampler(BaseSampler):
    """Concatenates sub-samplers into one cycle: the sandwich rule
    ``concat(anchor[MAX,MIN,R101,R77,R50], repeat×3(random))`` yields
    8 metas per cycle, one per train iteration
    (reference ar50to101v2.py:55-101; SURVEY.md §3.1)."""

    def __init__(self, model_samplers: Sequence[Dict[str, Any]], seed: int = 0):
        super().__init__(seed)
        self.samplers = [build_model_sampler(c) for c in model_samplers]
        self._cursor = 0

    @property
    def cycle_len(self) -> int:
        return sum(s.cycle_len for s in self.samplers)

    def anchor_name(self, index: int) -> str:
        index = index % self.cycle_len
        for s in self.samplers:
            if index < s.cycle_len:
                return s.anchor_name(index)
            index -= s.cycle_len
        raise IndexError(index)

    def sample(self) -> Dict[str, Any]:
        index = self._cursor
        self._cursor = (self._cursor + 1) % self.cycle_len
        for s in self.samplers:
            if index < s.cycle_len:
                return s.sample()
            index -= s.cycle_len
        raise IndexError(index)

    def traverse(self) -> Iterator[Dict[str, Any]]:
        for s in self.samplers:
            yield from s.traverse()
