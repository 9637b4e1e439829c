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


#: a directed deployment of another shape, added as files and entries only:
#: its generator, weight draw and update stream are new files too
DIRECTED_CELL = "rmat_directed7.arc_churn"

DIRECTED_FILES = {
    "generators/rmat_directed.py": '''\
"""A minimal directed R-MAT: per level one draw picks the quadrant (a, b,
c, d), labels as drawn."""
import numpy as np


def draw(config, rng, weight):
    scale = int(config["scale"])
    a, b, c = config["a"], config["b"], config["c"]
    n, m = 1 << scale, int(config["edge_factor"]) << scale
    i = np.zeros(m, np.int64)
    j = np.zeros(m, np.int64)
    for level in range(scale):
        r = rng.random(m)
        i += (r >= a + b).astype(np.int64) << level
        j += (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(
            np.int64) << level
    return n, i, j, weight(rng, m)
''',
    "weights/int_1_8.py": '''\
"""Integer weights uniform in [1, 8]."""


def draw(rng, size):
    return rng.integers(1, 9, size)
''',
    "streams/arc_churn.py": '''\
"""Arc and vertex churn over every vertex: PutE u -> v, RemE, RemV and
PutV in the shares the mix gives, endpoints uniform."""
from graphbench.traffic import PUTE, PUTV, REME, REMV


def batches(rng, n, n_batches, p, weight, base):
    out = []
    for _ in range(n_batches):
        ops = []
        for _ in range(int(p["ops_per_batch"])):
            u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
            r = rng.random()
            if r < p["pute_share"]:
                ops.append((PUTE, u, v, float(weight(rng, 1)[0])))
            elif r < p["pute_share"] + p["reme_share"]:
                ops.append((REME, u, v))
            elif r < p["pute_share"] + p["reme_share"] + p["remv_share"]:
                ops.append((REMV, u))
            else:
                ops.append((PUTV, u))
        out.append(ops)
    return out
''',
}

DIRECTED_CONFIG = {
    "name": "rmat_directed7", "data_seed": 7003,
    "generator": "rmat_directed", "scale": SCALE,
    "a": 0.55, "b": 0.1, "c": 0.1, "d": 0.25, "edge_factor": 8,
    "directed": True, "self_loops": "dropped", "weights": "int_1_8",
    "edge_slack": 2.0, "service": {"ring_depth": 8, "batch_size": 32},
}

DIRECTED_MIX = {
    "kind": "refresh_loop", "warmup_steps": 1,
    "updates": {"stream": "arc_churn", "ops_per_batch": 24,
                "pute_share": 0.5, "reme_share": 0.3, "remv_share": 0.1},
    "trace_at": 0.4, "trace_steps": 3, "check": {"steps": 2},
}


def add_directed_cell(root: str) -> str:
    """Add ``DIRECTED_CELL`` to the tiny root as new files and entries."""
    bench_dir = os.path.join(root, "graphbench")
    for rel, text in DIRECTED_FILES.items():
        with open(os.path.join(bench_dir, rel), "w") as f:
            f.write(text)
    cfg_file = "graphbench/configs/rmat_directed7.json"
    with open(os.path.join(root, cfg_file), "w") as f:
        json.dump(DIRECTED_CONFIG, f)
    with open(os.path.join(bench_dir, "traffic", "arc_churn.json"), "w") as f:
        json.dump(DIRECTED_MIX, f)
    with open(os.path.join(bench_dir, "limits",
                           "graph500_s14.bc_refresh.json")) as f:
        limits = json.load(f)
    with open(os.path.join(bench_dir, "limits", DIRECTED_CELL + ".json"),
              "w") as f:
        json.dump(limits, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "rmat_directed7", "source": "test",
                             "file": cfg_file, "reduced": [], "why": "t"})
    bench["workloads"].append({"name": DIRECTED_CELL,
                               "config": "rmat_directed7",
                               "traffic": "arc_churn", "chips": 1,
                               "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "graph500_s14.bc_refresh" in m.get("workloads", ()):
            m["workloads"].append(DIRECTED_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return DIRECTED_CELL
