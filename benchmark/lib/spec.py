"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``benchmark/configs/<name>.json``
- a traffic mix: ``benchmark/traffic/<name>.json`` (its ``kind`` names the
  loop ``benchmark/loops/<kind>.py``)
- a cell's own settings: ``benchmark/workloads/<name>.json``, the limits
  of its correctness check (``limits``) and the end-to-end metric its
  loop's rate is reported as (``rate_metric``)
- a per-layer metric: ``benchmark/metrics/<name>.py``, whose ``read(r)``
  takes the traced run's readings and returns a number, or None when the
  run recorded nothing for it (the metric is then left out of the line).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(path: Optional[str] = None) -> Dict[str, Any]:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> Dict[str, Any]:
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def load_config(name: str) -> Dict[str, Any]:
    return dict(_json("configs", name), name=name)


def load_traffic(name: str) -> Dict[str, Any]:
    return dict(_json("traffic", name), name=name)


def load_workload(name: str) -> Dict[str, Any]:
    return _json("workloads", name)


def loop(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}")


def metric_reader(name: str):
    """The module of ``benchmark/metrics/<name>.py`` (names hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict[str, Any], spec: Dict[str, Any],
             cell_name: str) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = next(m for m in spec["end_to_end"] if m["name"] == moves)
    return _applies(e2e, spec, cell_name)


def cell_metrics(spec: Dict[str, Any], section: str,
                 cell_name: str) -> List[Dict[str, Any]]:
    return [m for m in spec[section] if _applies(m, spec, cell_name)]


def end_to_end_metrics(spec, cell_name: str, values: Dict[str, float]):
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell_metrics(spec, "end_to_end", cell_name)}


def per_layer_metrics(spec, cell_name: str, readings: Dict[str, Any]):
    out = {}
    for m in cell_metrics(spec, "per_layer", cell_name):
        value = metric_reader(m["name"]).read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
