"""The harness on the CPU: every file ``BENCHMARK.json`` names loads by
name and keeps the shapes ``BENCHMARK.json`` must keep, nothing the benchmark runs loads
JAX or the JAX package, and a run without a card fails without falling
back to the CPU."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import spec as bench_spec  # noqa: E402
from benchmark.lib.result import forbidden_modules  # noqa: E402

SPEC = bench_spec.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_load_by_name(cell):
    w = bench_spec.cell(SPEC, cell)
    config = bench_spec.load_config(w["config"])
    traffic = bench_spec.load_traffic(w["traffic"])
    workload = bench_spec.load_workload(cell)
    assert bench_spec.loop(traffic["kind"]).run
    assert config["repo_configs"]
    assert w["chips"] == 1
    e2e = bench_spec.cell_metrics(SPEC, "end_to_end", cell)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert workload["rate_metric"] in [m["name"] for m in e2e]
    assert workload["limits"] and all(v > 0 for v in
                                      workload["limits"].values())
    assert bench_spec.cell_metrics(SPEC, "per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_readers_load_by_name(metric):
    reader = bench_spec.metric_reader(metric)
    assert reader.read({}) is None        # nothing recorded: nothing read


def test_spec_keeps_its_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        data = json.load(open(os.path.join(ROOT, c["file"])))
        for key in c["reduced"]:
            assert key in data and key in data["published"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)
    moves = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in moves for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def _benchmark_modules():
    out = []
    for base, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        rel = os.path.relpath(base, ROOT)
        if "tests" in rel.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py") and f != "__init__.py" and "." not in f[:-3]:
                out.append((rel.replace(os.sep, ".") + "." + f[:-3]))
    return sorted(out)


def test_nothing_the_benchmark_runs_loads_jax():
    code = ("import sys, importlib; sys.path.insert(0, %r)\n"
            "for m in %r: importlib.import_module(m)\n"
            "from benchmark.lib import spec\n"
            "for m in spec.load_spec()['per_layer']: "
            "spec.metric_reader(m['name'])\n"
            "import gaiaseg_tpu_torch.engine, gaiaseg_tpu_torch.models\n"
            "print(' '.join(sorted(sys.modules)))"
            % (ROOT, _benchmark_modules()))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert forbidden_modules(out.split()) == []


def test_forbidden_names_compare_whole_top_level_names():
    assert forbidden_modules(["gaiaseg_tpu_torch.engine", "numpy"]) == []
    assert forbidden_modules(["gaiaseg_tpu.engine"]) == ["gaiaseg_tpu"]
    assert forbidden_modules(["jax._src", "flax.linen", "jaxlib"]) == [
        "flax", "jax", "jaxlib"]


def test_the_reference_imports_nothing_of_the_port():
    """Every file of ``reference/``, its parts (``reference/parts/``)
    among them."""
    ref_dir = os.path.join(ROOT, "benchmark", "reference")
    seen = []
    for base, _, files in os.walk(ref_dir):
        for f in files:
            if f.endswith(".py"):
                seen.append(os.path.relpath(os.path.join(base, f), ref_dir))
                src = open(os.path.join(base, f)).read()
                assert "gaiaseg_tpu" not in src, f
                assert not re.search(r"^\s*(import|from)\s+(jax|flax)", src,
                                     re.M), f
    assert os.path.join("parts", "dynamic_resnet.py") in seen
    assert os.path.join("parts", "__init__.py") in seen


def test_a_run_without_a_card_fails_and_prints_no_result():
    cell = SPEC["workloads"][0]["name"]
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", str(2 ** 31 + 3), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
