"""The harness as data: ``BENCHMARK.json`` against the benchmark's contract,
every piece found by name, new cells and metrics found without an edit, and
the modules a run loads.

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from tiny import BENCH, ROOT  # noqa: F401 (puts the benchmark on sys.path)

from benchlib import cells  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return cells.read_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_benchmark_json_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024
    n = len(bench["workloads"])
    # a full check fits its time: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell more
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    assert n <= 24 and sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, n // 4)


def test_configs_files_and_reductions(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        own = cells.read_json(os.path.join(ROOT, c["file"]))
        assert own["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_every_cell_reports_what_the_contract_asks(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = cells.load_cell(w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
        assert cell.limits, w["name"]


def test_metrics_keys_units_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cell_names = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", cell_names)) <= cell_names
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m


def _copy_bench(tmp_path):
    """BENCHMARK.json and the benchmark's folder, as a checkout holds them."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def test_a_new_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = _copy_bench(tmp_path)
    bdir = root / "benchmark"
    (bdir / "configs" / "wide.json").write_text(
        (bdir / "configs" / "msvd.json").read_text())
    (bdir / "traffic" / "serve-burst.json").write_text(json.dumps(
        {**json.loads((bdir / "traffic" / "serve-poisson.json").read_text()), "burst": 4}))
    (bdir / "workloads" / "wide-burst.json").write_text(json.dumps(
        {"config": "wide", "traffic": "serve-burst", "chips": 1, "why": "a test",
         "params": {"rate_per_s": 10.0}, "limits": {"unanswered": 0}}))
    (bdir / "metrics" / "serve.new_counter.py").write_text(
        "def read(ctx, out):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "wide",
                             "file": "benchmark/configs/wide.json"})
    bench["workloads"].append({"name": "wide-burst", "config": "wide",
                               "traffic": "serve-burst", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "serve.new_counter", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "Device",
                               "moves": "serve_captions_per_s", "workloads": ["wide-burst"]})
    bench["end_to_end"][0]["workloads"].append("wide-burst")
    cell = cells.load_cell("wide-burst", str(bdir), str(root), bench)
    assert cell.traffic["burst"] == 4 and cell.traffic["rate_per_s"] == 10.0
    assert cell.traffic["driver"] == "serve"
    assert [m["name"] for m in cell.per_layer] == ["serve.new_counter"]
    assert "serve_captions_per_s" in [m["name"] for m in cell.end_to_end]
    assert cells.driver(cell, str(bdir)).__name__ == "bench_driver_serve"
    assert cells.metric_reader("serve.new_counter", str(bdir)).read(None, None) == 42.0


def test_every_seed_gets_the_same_gaps_and_sizes_in_another_order():
    import numpy as np

    from benchlib.loadgen import schedule

    seconds = 30.0
    (a, sa), (b, sb) = (schedule(s, 100.0, seconds, [6, 14]) for s in (7, 2 ** 31 + 11))
    assert len(a) == len(b) == 3000
    gaps = [np.diff(np.concatenate([[0.0], o, [seconds]])) for o in (a, b)]
    assert np.allclose(np.sort(gaps[0]), np.sort(gaps[1]), rtol=0, atol=1e-9)
    assert not np.allclose(gaps[0], gaps[1])
    assert sorted(sa) == sorted(sb) and list(sa) != list(sb)


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "vct_tpu_torch_probe.x", object())
    assert "vct_tpu" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "vct_tpu.ops", object())
    assert run.forbidden_loaded() == ["vct_tpu"]


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    """Every module of the benchmark imported in a fresh process (the
    program too, as a driver imports it): no JAX, no JAX package; the
    reference and the shared library alone load nothing of the program."""
    code = f"""
import sys, os, glob, importlib.util
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import reference.model, reference.checks, benchlib.counts, benchlib.readings
assert not any(m.split('.')[0] == 'vct_tpu_torch' for m in sys.modules), 'reference loads the program'
from benchlib import cells
for path in glob.glob(os.path.join({BENCH!r}, 'drivers', '*.py')) + glob.glob(os.path.join({BENCH!r}, 'metrics', '*.py')):
    cells.load_module(path, 'probe_' + os.path.basename(path).replace('.', '_'))
import vct_tpu_torch.serve, vct_tpu_torch.train.loop, vct_tpu_torch.decode
import run
print(run.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_sources_import_nothing_of_the_program_or_the_tests():
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(BENCH, "reference", name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("vct_tpu_torch", "vct_tpu", "tests", "jax"), \
                    (name, mod)


def test_run_prints_no_result_without_the_program(tmp_path):
    root = _copy_bench(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "msvd-serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_prints_no_result_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "msvd-serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3 and out.stdout.strip() == ""
