"""The plain reference against the port on the CPU, at a tiny size: the same
update batches give the same live graph, and BFS, SSSP, single-source BC
and every vertex's betweenness agree."""
import numpy as np
import pytest
import torch

import gb_tiny  # noqa: F401  (puts the repository on the path)
from graphbench import traffic
from graphbench.reference import bc_all
from graphbench.reference import queries as refq
from graphbench.reference.graph import Graph

N = 64


def _initial(seed):
    rng = np.random.default_rng(seed)
    m = 300
    src = rng.integers(0, N, m).astype(np.int32)
    dst = rng.integers(0, N, m).astype(np.int32)
    w = rng.integers(1, 7, m).astype(np.float32)
    src[:5], dst[:5] = 3, 3                 # self-loops are stored
    src[5:8], dst[5:8] = 1, 2               # duplicates keep the last
    return src, dst, w


def _batches(seed, n_batches=12):
    rng = np.random.default_rng(seed + 100)
    out = []
    for _ in range(n_batches):
        ops = []
        for _ in range(10):
            u, v = int(rng.integers(0, N + 2)), int(rng.integers(0, N))
            k = int(rng.integers(0, 4))
            if k == 0:
                ops.append((traffic.PUTV, u))
            elif k == 1:
                ops.append((traffic.REMV, u))
            elif k == 2:
                ops.append((traffic.PUTE, u, v, float(rng.integers(1, 9))))
            else:
                ops.append((traffic.REME, u, v))
        out.append(ops)
    return out


def _port_live(state):
    from repro_torch.core import queries

    e = queries.live_edges(state)
    return ({(int(a), int(b)): float(x) for a, b, x in zip(
        e.src.tolist(), e.dst.tolist(), e.w.tolist())},
            state.alive.numpy().copy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_updates_and_queries_match_the_port(seed):
    from repro_torch.core import apply_ops, from_edge_list, queries

    src, dst, w = _initial(seed)
    state = from_edge_list(N, 4 * len(src), src, dst, w, device="cpu")
    g = Graph(N, src, dst, w)
    for ops in _batches(seed):
        state, _ = apply_ops(state, ops, batch_size=32)
        g.apply(ops)
        edges, alive = _port_live(state)
        assert edges == g.weight
        assert np.array_equal(alive, g.alive)
        e = g.arrays()
        for s in (0, 1, 3, 17, N - 1, N + 1):
            ok, dist = refq.bfs(e, s)
            r = queries.bfs(state, s)
            assert ok == bool(r.ok)
            assert np.array_equal(dist, r.dist.numpy())
            ok, dist = refq.sssp(e, s)
            r = queries.sssp(state, s)
            assert ok == bool(r.ok)
            assert np.array_equal(dist, r.dist.numpy().astype(np.float64))
            ok, level, sigma, delta = refq.bc(e, s)
            r = queries.bc_dependencies(state, s)
            assert ok == bool(r.ok)
            assert np.array_equal(level, r.level.numpy())
            np.testing.assert_allclose(sigma, r.sigma.numpy(), rtol=1e-6)
            np.testing.assert_allclose(delta, r.delta.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_every_vertex_betweenness_matches_the_service():
    from repro_torch.core import from_edge_list
    from repro_torch.engine import GraphService

    src, dst, w = _initial(7)
    svc = GraphService(from_edge_list(N, 4 * len(src), src, dst, w,
                                      device="cpu"))
    g = Graph(N, src, dst, w)
    for ops in _batches(7, 4):
        svc.submit_many(ops)
        svc.flush()
        g.apply(ops)
        got, _ = svc.bc_scores()
        want = bc_all.bc_scores(g.arrays(), block=24).numpy()
        assert np.array_equal(np.isnan(want), torch.isnan(got).numpy())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
