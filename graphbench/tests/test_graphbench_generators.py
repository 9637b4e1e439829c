"""The graph and traffic generators are deterministic per seed, every seed
offers the same work in another order, the Kronecker graph has the shape
the Graph500 specification gives it, and the update stream keeps to its
parameters and draws weights as the deployment does."""
import json
import os

import numpy as np
import pytest

import gb_tiny
from graphbench import graphs, traffic


def _config(name):
    with open(os.path.join(gb_tiny.ROOT, "graphbench", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(scale=8)
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
