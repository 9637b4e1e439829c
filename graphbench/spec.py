"""Find a cell's files by name.

Nothing here knows a cell: ``BENCHMARK.json`` names them, and each name
leads to a file of its own under the benchmark's folder:

  * ``configs/<config>.json``, ``traffic/<mix>.json``, ``limits/<cell>.json``;
  * ``generators/<generator>.py``, ``weights/<weights>.py`` -- the
    ``generator`` and ``weights`` a configuration names;
  * ``streams/<stream>.py`` -- the ``updates.stream`` a traffic mix names;
  * ``metrics/<metric>.py`` -- one reader per per-layer metric.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = "graphbench"

#: the checkout this module was imported from: where a lookup without a root
#: finds its files
HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def module_path(root: str, folder: str, name: str) -> str:
    """The file ``<folder>/<name>.py`` of the benchmark's folder; raises
    where there is none."""
    path = os.path.join(root, BENCH_DIR, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder} file for {name!r}: {path}")
    return path


@functools.cache
def load_module(root: str, folder: str, name: str):
    """The module ``<folder>/<name>.py``, loaded from its file once a
    process: the update stream is looked up again inside the window."""
    path = module_path(root, folder, name)
    spec = importlib.util.spec_from_file_location(
        f"graphbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: str, metric: str):
    return load_module(root, "metrics", metric).read


def resolve(root: str, cell: str) -> Cell:
    """Everything ``cell`` needs, from ``BENCHMARK.json`` and the files its
    names lead to."""
    bench = load_benchmark(root)
    wl = _by_name(bench["workloads"], cell, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "config")
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(traffic_path(root, wl["traffic"]))
    # the draws' files, so that a cell naming a missing one fails here
    module_path(root, "generators", config["generator"])
    module_path(root, "weights", config["weights"])
    module_path(root, "streams", traffic["updates"]["stream"])
    lim_file = limits_path(root, cell)
    limits = load_json(lim_file) if os.path.exists(lim_file) else {}
    e2e = reported(bench["end_to_end"], cell)
    names = {m["name"] for m in e2e}
    return Cell(name=cell, root=root, config=config, traffic=traffic,
                limits=limits, chips=int(wl["chips"]), end_to_end=e2e,
                per_layer=reported(bench["per_layer"], cell, names))
