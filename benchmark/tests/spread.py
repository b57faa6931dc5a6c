#!/usr/bin/env python3
"""The spread of a cell's end-to-end metrics over two sets of runs, and the
bounds they suggest.

    python3 benchmark/tests/spread.py setA.jsonl setB.jsonl

Each file holds the result lines of one set (the last line a run prints),
one a line. A spread is the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) as a share of the median;
the suggested bound is five times the wider of the two sets' spreads, at
least 1%.
"""
from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def spread(values: List[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def read_set(path: str) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            for name, m in json.loads(line)["metrics"].items():
                out.setdefault(name, []).append(float(m["value"]))
    return out


def main(paths: List[str]) -> None:
    sets = [read_set(p) for p in paths]
    for name in sorted(sets[0]):
        rows = [s[name] for s in sets if name in s]
        spreads = [spread(v) for v in rows if len(v) >= 2]
        medians = [statistics.median(v) for v in rows]
        widest = max(spreads) if spreads else float("nan")
        print(json.dumps({"metric": name, "medians": medians,
                          "spreads": spreads, "widest": widest,
                          "bound": max(0.01, 5 * widest),
                          "runs": [len(v) for v in rows]}))


if __name__ == "__main__":
    main(sys.argv[1:])
