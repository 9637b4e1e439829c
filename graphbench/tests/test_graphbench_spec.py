"""Configurations, generators, weight draws, traffic mixes, update streams,
limits and metric readers are found by the names in BENCHMARK.json; a cell
added as files and entries, a directed deployment of another shape among
them, needs no edit of any file the benchmark has."""
import json
import os

import numpy as np
import pytest

import gb_tiny
from graphbench import drivers, graphs, spec, traffic


def _bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("tiny", [False, True])
def test_every_cell_resolves_with_its_files(tmp_path, tiny):
    root = gb_tiny.make_root(tmp_path) if tiny else gb_tiny.ROOT
    bench = _bench(root)
    for wl in bench["workloads"]:
        cell = spec.resolve(root, wl["name"])
        assert cell.chips == wl["chips"]
        assert cell.traffic["kind"] in drivers.DRIVERS
        assert cell.limits, wl["name"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
            assert m["moves"] in names


def _files(root):
    """Every file under the root's ``graphbench/``, by path, as bytes."""
    out = {}
    for dirpath, dirs, names in os.walk(os.path.join(root, "graphbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[path] = f.read()
    return out


def _unchanged(before, root):
    after = _files(root)
    return {p: after.get(p) for p in before} == before


def test_a_cell_added_as_files_is_found_without_an_edit(tmp_path):
    root = gb_tiny.make_root(tmp_path)
    before = _files(root)
    bench = _bench(root)
    cfg = json.load(open(os.path.join(root, bench["configs"][0]["file"])))
    cfg["a"], cfg["d"] = 0.45, 0.35
    new_cfg = "graphbench/configs/kron7_other.json"
    json.dump(cfg, open(os.path.join(root, new_cfg), "w"))
    mix = json.load(open(os.path.join(root, "graphbench", "traffic",
                                      "bc_refresh.json")))
    mix["updates"]["ops_per_batch"] = 11
    json.dump(mix, open(os.path.join(root, "graphbench", "traffic",
                                     "bc_new.json"), "w"))
    json.dump({"stale_refresh": 0}, open(os.path.join(
        root, "graphbench", "limits", "kron7_other.bc_new.json"), "w"))
    with open(os.path.join(root, "graphbench", "metrics",
                           "new_metric.py"), "w") as f:
        f.write("def read(r):\n    return 42.0\n")
    bench["configs"].append({"name": "kron7_other", "source": "test",
                             "file": new_cfg, "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "kron7_other.bc_new",
                               "config": "kron7_other",
                               "traffic": "bc_new", "chips": 1,
                               "why": "t"})
    bench["per_layer"].append({"name": "new_metric", "unit": "%",
                               "better": "higher",
                               "source": "program_counter", "layer": "t",
                               "moves": "bc_refresh_ms",
                               "workloads": ["kron7_other.bc_new"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "bc_refresh_ms":
            m["workloads"].append("kron7_other.bc_new")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell = spec.resolve(root, "kron7_other.bc_new")
    assert cell.config["a"] == 0.45
    assert cell.traffic["updates"]["ops_per_batch"] == 11
    assert cell.limits == {"stale_refresh": 0}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "bc_refresh_ms"}
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert cell.reader("new_metric")(None) == 42.0
    assert _unchanged(before, root)


def test_a_directed_deployment_added_as_files_is_found_without_an_edit(
        tmp_path):
    root = gb_tiny.make_root(tmp_path)
    before = _files(root)
    name = gb_tiny.add_directed_cell(root)
    assert _unchanged(before, root)

    cell = spec.resolve(root, name)
    assert cell.config["directed"] is True
    assert cell.traffic["updates"]["stream"] == "arc_churn"
    assert cell.limits and cell.per_layer
    rngs = traffic.streams(gb_tiny.SEED, cell.config["data_seed"])
    n, src, dst, w = graphs.draw(cell.config, rngs.graph, root)
    # the new generator's arcs, once each, with the new integer weights
    assert n == 1 << gb_tiny.SCALE and (src != dst).all()
    arcs = set(zip(src.tolist(), dst.tolist()))
    assert any((v, u) not in arcs for u, v in arcs)
    assert np.array_equal(w, np.round(w)) and 1 <= w.min() and w.max() <= 8
    # the new stream's ops, vertex churn among them
    weight = graphs.weight_draw(cell.config, root)
    batches = traffic.update_batches(rngs.updates, n, 8,
                                     cell.traffic["updates"], weight,
                                     root=root)
    kinds = {op[0] for b in batches for op in b}
    assert kinds == {traffic.PUTV, traffic.REMV, traffic.PUTE, traffic.REME}


@pytest.mark.parametrize("folder,name", [("generators", "rmat_directed"),
                                         ("weights", "int_1_8"),
                                         ("streams", "arc_churn")])
def test_a_cell_naming_a_missing_file_fails_to_resolve(tmp_path, folder,
                                                       name):
    root = gb_tiny.make_root(tmp_path)
    cell = gb_tiny.add_directed_cell(root)
    os.remove(os.path.join(root, "graphbench", folder, name + ".py"))
    with pytest.raises(FileNotFoundError, match=repr(name)):
        spec.resolve(root, cell)


def test_reported_without_workloads_follows_moves():
    e2e = [{"name": "setup_s"}, {"name": "x", "workloads": ["c1"]}]
    assert [m["name"] for m in spec.reported(e2e, "c2")] == ["setup_s"]
    per = [{"name": "p", "moves": "x"}, {"name": "q", "moves": "setup_s"}]
    assert [m["name"] for m in spec.reported(per, "c2", {"setup_s"})] == [
        "q"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve(gb_tiny.ROOT, "no_such.cell")
