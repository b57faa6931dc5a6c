"""ModelSpace: the store of profiled/evaluated subnet metas.

A copy of ``gaiaseg_tpu/archspace/model_space.py``.

Behavioral contract reconstructed from reference use sites (SURVEY.md §2.9
``ModelSpaceManager``): ``.load(path_or_list)`` (JSON file of a list of
nested metas, or an in-memory list), ``.apply_rule(rule)``, ``.pack()``
returning a list of nested metas, ``.dump(json_path)``; rows carry
``{arch, data, overhead: {flops, params}, metric: {tag: value}}``
(reference tools/count_flops.py:153-158, test_supernet.py:317-327).

Internally rows are kept as *flat* dot-keyed dicts so rule lambdas index
``x['overhead.flops']`` directly; ``pack``/``dump`` re-nest them.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict, List, Sequence, Union

from .meta import fold_dict, unfold_dict
from .rules import BaseRule


class ModelSpace:
    def __init__(self, rows: Sequence[Dict[str, Any]] = ()):
        # rows stored flat (dot-keyed)
        self._rows: List[Dict[str, Any]] = [self._flatten(r) for r in rows]

    @staticmethod
    def _flatten(meta: Dict[str, Any]) -> Dict[str, Any]:
        # fold everything nested; already-flat keys pass through unchanged
        return fold_dict(unfold_dict(meta))

    @classmethod
    def load(cls, src: Union[str, Sequence[Dict[str, Any]]]) -> "ModelSpace":
        if isinstance(src, str):
            with open(src) as f:
                text = f.read().strip()
            try:
                data = json.loads(text)
            except json.JSONDecodeError:
                # append-only JSON-lines sweeps (count_flops writes one JSON
                # object per line per rank; SURVEY.md §5 restartable-sweep)
                data = [json.loads(line) for line in text.splitlines() if line.strip()]
            if isinstance(data, dict):
                data = [data]
            return cls(data)
        return cls(list(src))

    def __len__(self) -> int:
        return len(self._rows)

    def __iter__(self):
        return iter(self._rows)

    @property
    def columns(self) -> List[str]:
        cols: List[str] = []
        for r in self._rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        return cols

    def to_dataframe(self):
        import pandas as pd
        return pd.DataFrame(self._rows)

    def apply_rule(self, rule: BaseRule) -> "ModelSpace":
        return ModelSpace(rule.apply(self._rows))

    def pack(self) -> List[Dict[str, Any]]:
        """Nested metas ready for ``arch_spec_from_meta`` / manipulate_arch."""
        return [unfold_dict(r) for r in self._rows]

    def flat_rows(self) -> List[Dict[str, Any]]:
        return [dict(r) for r in self._rows]

    def annotate(self, index: int, key: str, value: Any) -> None:
        """Tag e.g. ``metric.mIoU`` onto row ``index``."""
        self._rows[index][key] = value

    def dump(self, path: str) -> None:
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.pack(), f, indent=2, default=float)


# Alias matching the reference symbol name (gaiavision ModelSpaceManager)
ModelSpaceManager = ModelSpace
