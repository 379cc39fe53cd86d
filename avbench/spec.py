"""Finding what a cell needs by the names in BENCHMARK.json: the cell's
own file (`cells/<workload>.json`), its configuration's file, its
traffic generator (`traffic/<generator>.py`) and the reader of each
per-layer metric (`layers/<metric>.py`). Later cells add files; none is
edited."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def cell(name: str, cells_dir: str = os.path.join(HERE, "cells")) -> Dict:
    return load_json(os.path.join(cells_dir, name + ".json"))


def config(bench: Dict, name: str, root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, config_entry(bench, name)["file"]))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str):
    return _module(os.path.join(HERE, "traffic", kind + ".py"),
                   "avbench.traffic." + kind.replace(".", "_"))


def reader(metric: str):
    return _module(os.path.join(HERE, "layers", metric + ".py"),
                   "avbench.layers." + metric.replace(".", "_"))


def metrics_of(bench: Dict, kind: str, workload_name: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` metrics a workload reports: those
    that list it, and those that list no workloads."""
    return [m for m in bench[kind]
            if workload_name in m.get("workloads", [workload_name])]
