"""Find a cell's configuration, traffic mix, limits and metric readers by name.

Nothing here knows a cell: ``BENCHMARK.json`` names them, and each name
leads to a file of its own under the benchmark's folder.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = "graphbench"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _by_name(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def reported(metrics, cell: str, e2e_names=None):
    """The metrics of ``metrics`` that ``cell`` reports: those whose
    ``workloads`` list it, or, without that key, every end-to-end metric and
    every per-layer metric whose ``moves`` the cell reports."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e_names is None or m.get("moves") in e2e_names:
            out.append(m)
    return out


@dataclass
class Cell:
    name: str
    root: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def reader(self, metric: str):
        """The ``read(readings)`` function of a per-layer metric."""
        return load_reader(self.root, metric)


def traffic_path(root: str, name: str) -> str:
    return os.path.join(root, BENCH_DIR, "traffic", f"{name}.json")


def limits_path(root: str, cell: str) -> str:
    return os.path.join(root, BENCH_DIR, "limits", f"{cell}.json")


def reader_path(root: str, metric: str) -> str:
    return os.path.join(root, BENCH_DIR, "metrics", f"{metric}.py")


def load_reader(root: str, metric: str):
    path = reader_path(root, metric)
    spec = importlib.util.spec_from_file_location(
        f"graphbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(root: str, cell: str) -> Cell:
    """Everything ``cell`` needs, from ``BENCHMARK.json`` and the files its
    names lead to."""
    bench = load_benchmark(root)
    wl = _by_name(bench["workloads"], cell, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "config")
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(traffic_path(root, wl["traffic"]))
    lim_file = limits_path(root, cell)
    limits = load_json(lim_file) if os.path.exists(lim_file) else {}
    e2e = reported(bench["end_to_end"], cell)
    names = {m["name"] for m in e2e}
    return Cell(name=cell, root=root, config=config, traffic=traffic,
                limits=limits, chips=int(wl["chips"]), end_to_end=e2e,
                per_layer=reported(bench["per_layer"], cell, names))
