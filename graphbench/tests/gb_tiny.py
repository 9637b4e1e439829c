"""A copy of the benchmark's files at a size a CPU test run can hold: every
configuration at scale 7; the traffic and the limits as they are."""
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

SCALE = 7
SEED = 2**31 + 77          # more than 32 signed bits hold


def make_root(tmp_path, scale: int = SCALE) -> str:
    root = str(tmp_path / "bench")
    shutil.copytree(os.path.join(ROOT, "graphbench"),
                    os.path.join(root, "graphbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(scale=scale)
        with open(path, "w") as f:
            json.dump(cfg, f)
    return root


def cell_of_kind(root: str, kind: str) -> str:
    """The first cell of BENCHMARK.json whose traffic has this ``kind``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for wl in bench["workloads"]:
        with open(os.path.join(root, "graphbench", "traffic",
                               wl["traffic"] + ".json")) as f:
            if json.load(f)["kind"] == kind:
                return wl["name"]
    raise KeyError(kind)
