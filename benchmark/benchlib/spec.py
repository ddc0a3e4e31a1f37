"""What a run reads by name: the cell in BENCHMARK.json, its
configuration, its traffic mix, its limits, and the readers of its
metrics. Nothing here names a cell, a configuration or a metric: a new
one is a new file and a new entry.

- configs/<config>.json       sizes and settings of a configuration
- traffic/<traffic>.json      a traffic mix's parameters, read by the
                              driver the file names (benchlib/drivers.py)
- limits/<cell>.json          each number the check compares, its limit
- end_to_end/<metric>.py      read(run) -> number or None
- layer_metrics/<metric>.py   read(trace) -> number or None; SPANS names
                              the program's callables it times
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries of BENCHMARK.json
    per_layer: list = field(default_factory=list)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files, and the
    metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, "benchmark")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic", entry["traffic"] + ".json"))
    limits = _json(os.path.join(bench_dir, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name, entry["chips"], config, traffic, limits, e2e, layer)
