"""A cell of `BENCHMARK.json`, resolved by name to its files: the
configuration's (``configs/<config>.json``), the traffic mix's
(``traffic/<traffic>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``). Adding a cell, a configuration, a mix or a
metric is adding files and entries; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Mapping

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_DIR = "vcbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: str = ROOT


def _applies(metric: Mapping, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    return Cell(name, w["chips"], w["config"], config, w["traffic"], traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], root)


def metric_reader(name: str, root: str = ROOT):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"vcbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
