"""The graph and traffic generators are deterministic per seed, every seed
offers the same work in another order, the Kronecker graph has the shape
the Graph500 specification gives it (each edge both ways, or each arc once
where the configuration says ``directed``), the benchmark's draws are the
bytes they were when the generator, weight draw and update stream became
files found by name, and the update stream keeps to its parameters and
draws weights as the deployment does."""
import hashlib
import json
import os

import numpy as np
import pytest

import gb_tiny
from graphbench import graphs, traffic


def _config(name, scale=8):
    with open(os.path.join(gb_tiny.ROOT, "graphbench", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(scale=scale)
    return cfg


def _mix(name):
    with open(os.path.join(gb_tiny.ROOT, "graphbench", "traffic",
                           name + ".json")) as f:
        return json.load(f)


def _draw_all(seed, data_seed, cfg_name="graph500_s14", mix="bc_refresh"):
    rngs = traffic.streams(seed, data_seed)
    cfg = _config(cfg_name)
    n, src, dst, w = graphs.draw(cfg, rngs.graph)
    p = _mix(mix)["updates"]
    base = traffic.hot_base(rngs.hot, n, p)
    batches = traffic.update_batches(rngs.updates, n, 8, p,
                                     graphs.weight_draw(cfg), base,
                                     rngs.order)
    return (src, dst, w), batches


@pytest.mark.parametrize("seed", [gb_tiny.SEED, 2**33 + 5])
def test_every_seed_offers_the_same_work_in_another_order(seed):
    a = _draw_all(seed, 5)
    b = _draw_all(seed, 5)
    c = _draw_all(seed + 1, 5)
    d = _draw_all(seed, 6)
    for x, y, z in zip(a[0], b[0], c[0]):
        assert np.array_equal(x, y) and np.array_equal(x, z)
    assert a[1] == b[1]
    # another seed: the same batches in another order
    assert a[1] != c[1] and sorted(a[1]) == sorted(c[1])
    # another deployment's data: another graph
    assert not np.array_equal(a[0][0], d[0][0])


def test_kronecker_is_undirected_without_self_loops():
    cfg = _config("graph500_s14")
    n, src, dst, w = graphs.draw(cfg, np.random.default_rng(9))
    m = len(src) // 2
    assert len(src) == 2 * m and m <= cfg["edge_factor"] * n
    assert np.array_equal(src[:m], dst[m:]) and np.array_equal(dst[:m],
                                                                src[m:])
    assert np.array_equal(w[:m], w[m:])
    assert (src != dst).all()
    # the specification's weights: real, uniform in [0, 1)
    assert w.dtype == np.float32 and w.min() >= 0.0 and w.max() < 1.0
    assert len(np.unique(w)) > m // 2
    # labels permuted: degrees are skewed
    deg = np.bincount(src, minlength=n)
    assert deg.max() > 8 * deg.mean()


@pytest.mark.parametrize("seed", [1, gb_tiny.SEED])
def test_graph500_s14_draws_are_pinned(seed):
    """The cell's graph, hot set and first 64 batches, at its own scale, as
    the draws gave them before they were found by name."""
    cfg = _config("graph500_s14", scale=14)
    rngs = traffic.streams(seed, 14002)
    n, src, dst, w = graphs.draw(cfg, rngs.graph)
    assert n == 16384 and len(src) == 523704
    assert (src.dtype, dst.dtype, w.dtype) == (np.int32, np.int32,
                                               np.float32)
    digest = hashlib.sha256()
    for a in (src, dst, w):
        digest.update(a.tobytes())
    assert digest.hexdigest() == (
        "f9497a72fca6b1f4e547c8ccdc9422a1091567002ca92a671ee54e2158febe83")
    p = _mix("bc_refresh")["updates"]
    base = traffic.hot_base(rngs.hot, n, p)
    assert base == 460
    batches = traffic.update_batches(rngs.updates, n, 64, p,
                                     graphs.weight_draw(cfg), base)
    assert hashlib.sha256(json.dumps(batches).encode()).hexdigest() == (
        "a70e3512577b861a177dba3f227ff3047e118c008fe019095f904c179a568b04")


def test_kronecker_directed_keeps_each_arc_once():
    cfg = _config("graph500_s14", scale=7)
    n, src, dst, w = graphs.draw(cfg, np.random.default_rng(9))
    cfg["directed"] = True
    n_d, src_d, dst_d, w_d = graphs.draw(cfg, np.random.default_rng(9))
    assert n_d == n and 2 * len(src_d) == len(src)
    m = len(src_d)
    # the arcs as drawn: the first half of the undirected draw
    assert np.array_equal(src_d, src[:m]) and np.array_equal(dst_d, dst[:m])
    assert np.array_equal(w_d, w[:m])
    assert (src_d != dst_d).all()
    arcs = set(zip(src_d.tolist(), dst_d.tolist()))
    assert any((v, u) not in arcs for u, v in arcs)


@pytest.mark.parametrize("key,value", [
    ("directed", "yes"), ("directed", 1), ("self_loops", "sometimes"),
    ("self_loops", "kept"),
    ("generator", "no_such_generator"), ("weights", "no_such_weights")])
def test_an_unknown_shape_is_refused_by_name(key, value):
    cfg = _config("graph500_s14", scale=4)
    cfg[key] = value
    with pytest.raises((ValueError, FileNotFoundError), match=repr(value)):
        graphs.draw(cfg, np.random.default_rng(0))


def test_an_unknown_stream_is_refused_by_name():
    p = dict(_mix("bc_refresh")["updates"], stream="no_such_stream")
    with pytest.raises(FileNotFoundError, match="'no_such_stream'"):
        traffic.update_batches(np.random.default_rng(0), 64, 1, p,
                               graphs.weight_draw(_config("graph500_s14")))


def test_update_stream_keeps_to_its_parameters():
    rng = np.random.default_rng(4)
    cfg = _config("graph500_s14")
    p = _mix("bc_refresh")["updates"]
    base = traffic.hot_base(rng, 1000, p)
    batches = traffic.update_batches(rng, 1000, 50, p,
                                     graphs.weight_draw(cfg), base)
    assert all(len(b) == p["ops_per_batch"] for b in batches)
    ops = [op for b in batches for op in b]
    us = [op[1] for op in ops]
    size = int(1000 * p["hot_frac"])
    assert base <= min(us) and max(us) < base + size
    assert {op[0] for op in ops} == {traffic.PUTE, traffic.REME}
    share = sum(op[0] == traffic.PUTE for op in ops) / len(ops)
    assert abs(share - p["pute_share"]) < 0.05
    # inserted edges weigh as the deployment's edges do
    ws = np.array([op[3] for op in ops if op[0] == traffic.PUTE])
    assert ws.min() >= 0.0 and ws.max() < 1.0
    assert np.array_equal(ws, ws.astype(np.float32))
    assert len(np.unique(ws)) > 0.9 * len(ws)
