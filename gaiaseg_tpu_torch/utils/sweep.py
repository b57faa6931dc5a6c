"""Restartable sweep log: per-item JSON lines + skip-if-done on restart.

A copy of ``gaiaseg_tpu/utils/sweep.py``.

SURVEY.md §5 restartable-sweep property (the reference barriers per subnet
and keeps per-rank partials, reference tools/finetune_supernet.py:358,
tools/count_flops.py:119-122): a sweep that dies at subnet 40/50 must not
lose the first 39. Each completed item is appended (and flushed) as ONE
JSON line keyed by the subnet meta's stable hash; rerunning the tool skips
completed keys and the final merged dump includes both old and new rows.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict, Iterator, Optional, Tuple

from ..archspace.meta import meta_hash


def sweep_key(meta: Dict[str, Any]) -> str:
    """Stable per-subnet key: md5 of the meta WITHOUT its mutable metric
    annotations (so a re-run over an already-annotated space still matches
    rows recorded before annotation)."""
    clean = {k: v for k, v in meta.items() if k != "metric"}
    return meta_hash(clean, length=12)


class SweepLog:
    """Append-only JSON-lines result log with restart skip.

    >>> log = SweepLog(path)
    >>> for meta in metas:
    ...     if log.done(meta): continue      # finished in a prior run
    ...     log.record(meta, result)         # one flushed line per item
    >>> rows = log.annotated(metas, tag)     # metas + recorded metrics
    """

    def __init__(self, path: str):
        self.path = path
        self._results: Dict[str, Any] = {}
        if osp.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        self._results[rec["key"]] = rec["value"]
                    except (ValueError, KeyError):
                        continue  # torn tail line from a crash mid-write
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        # a crash can leave a torn line with no trailing newline; start a
        # fresh line so the next record isn't glued onto the torn one
        if self._f.tell() > 0:
            with open(path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                if rf.read(1) != b"\n":
                    self._f.write("\n")

    def __len__(self) -> int:
        return len(self._results)

    def done(self, meta: Dict[str, Any]) -> bool:
        return sweep_key(meta) in self._results

    def get(self, meta: Dict[str, Any]) -> Optional[Any]:
        return self._results.get(sweep_key(meta))

    def record(self, meta: Dict[str, Any], value: Any) -> None:
        key = sweep_key(meta)
        self._results[key] = value
        self._f.write(json.dumps({"key": key, "value": value},
                                 default=float) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def annotated(self, metas, tag: str) -> list:
        """Attach each recorded value as ``meta['metric'][tag]``; items
        with no recorded value are dropped (still pending)."""
        rows = []
        for m in metas:
            v = self.get(m)
            if v is None:
                continue
            m.setdefault("metric", {})[tag] = v
            rows.append(m)
        return rows
