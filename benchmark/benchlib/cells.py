"""Finding the pieces of a cell by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics.
Each cell's own file is ``benchmark/workloads/<cell>.json`` (its
configuration, traffic mix, chips, why, limits and any traffic parameter of
its own); the configuration is ``benchmark/configs/<config>.json``; the
traffic mix is ``benchmark/traffic/<traffic>.json`` (its parameters and the
driver that generates it, ``benchmark/drivers/<driver>.py``); a per-layer
metric is ``benchmark/metrics/<metric>.py``. Adding any of them is adding a
file and an entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]  # the cell's own file
    config: Dict[str, Any]  # the configuration file, as run
    traffic: Dict[str, Any]  # the mix's parameters, the cell's own on top
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))

    @property
    def limits(self) -> Dict[str, float]:
        return dict(self.workload.get("limits", {}))


def applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_dir: str = BENCH_DIR, root: str = ROOT,
              benchmark: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and the metrics it
    reports, as ``BENCHMARK.json`` and the cell's files give them."""
    bench = benchmark if benchmark is not None else read_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = read_json(os.path.join(bench_dir, "workloads", name + ".json"))
    for key in ("config", "traffic", "chips"):
        if workload.get(key) != entry.get(key):
            raise ValueError(f"{name}: {key} is {workload.get(key)!r} in its file and "
                             f"{entry.get(key)!r} in BENCHMARK.json")
    config = read_json(os.path.join(bench_dir, "configs", workload["config"] + ".json"))
    traffic = read_json(os.path.join(bench_dir, "traffic", workload["traffic"] + ".json"))
    traffic = {**traffic, **workload.get("params", {})}
    return Cell(name, workload, config, traffic,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def driver(cell: Cell, bench_dir: str = BENCH_DIR) -> ModuleType:
    name = cell.traffic["driver"]
    return load_module(os.path.join(bench_dir, "drivers", name + ".py"), f"bench_driver_{name}")


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return load_module(os.path.join(bench_dir, "metrics", name + ".py"),
                       "bench_metric_" + name.replace(".", "_"))
