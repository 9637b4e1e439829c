"""The hub-first vertex order of ``GraphService.bc_scores``
(``queries.bc_vertex_order``), on the CPU: the order itself, and a refresh
run under it against a cold ``bc_batched_dense`` in vertex order -- levels,
sigma and ``ok`` bit-equal, scores within ``TOL`` -- cold, delta across a
commit that moves a vertex to another degree bucket, and on a graph with no
edgeless vertex."""
import numpy as np
import pytest
import torch

from repro_torch.core import queries
from repro_torch.core.graph_state import from_edge_list
from repro_torch.core.updates import PUTE, REME
from repro_torch.data import load_rmat_graph
from repro_torch.engine import GraphService
from repro_torch.kernels import count_mm

TOL = dict(rtol=1e-5, atol=1e-5)


def _rmat(n=128, e=400):
    """Directed R-MAT: dead slots, live sinks, heavy-tailed out-degrees."""
    return load_rmat_graph(n, e, seed=1, weighted=False, device="cpu")


def _no_edgeless(n=96, extra=160):
    """Every vertex alive with an out-edge: a ring plus random chords."""
    rng = np.random.default_rng(7)
    src = np.concatenate([np.arange(n), rng.integers(0, n, extra)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, extra)])
    keep = src != dst
    return from_edge_list(n, 2 * len(src), src[keep], dst[keep],
                          device="cpu")


GRAPHS = {"rmat": _rmat, "no_edgeless": _no_edgeless}


def _degrees(state):
    am, _, alive = queries.dense_views(state)
    return torch.where(alive, (am & alive[None, :]).sum(dim=1), 0), am, alive


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_order_is_a_stable_hub_first_permutation(graph):
    state = GRAPHS[graph]()
    deg, am, alive = _degrees(state)
    order = queries.bc_vertex_order(am, alive)
    V = state.vcap
    assert torch.equal(torch.sort(order).values, torch.arange(V))
    assert torch.equal(order, queries.bc_vertex_order(am.clone(),
                                                      alive.clone()))
    d = deg[order]
    bucket = torch.where(d > 0, torch.floor(torch.log2(d.double().clamp(
        min=1))).long(), -1)
    assert (bucket[:-1] >= bucket[1:]).all()            # non-increasing
    edged = int((deg > 0).sum())
    assert (d[:edged] > 0).all() and (d[edged:] == 0).all()
    # ties by vertex id, within every bucket
    for b in bucket.unique().tolist():
        ids = order[bucket == b]
        assert (ids[:-1] < ids[1:]).all()
    if graph == "rmat":
        assert (~alive).any() and ((deg == 0) & alive).any()
        assert not alive[order[edged:]].all()           # dead ones last too
    else:
        assert edged == V


def test_block_occupancy_marks_every_block_with_an_entry():
    # the refresh's grid is at the count kernel's k-step
    assert queries.ORDER_TILE == count_mm.BK
    mask = torch.zeros((100, 70), dtype=torch.bool)
    mask[0, 0] = mask[99, 69] = mask[64, 5] = True
    occ = queries.block_occupancy(mask, 64)
    assert occ.dtype == torch.int32
    assert occ.tolist() == [[1, 0], [1, 1]]


def _cold(state):
    am, _, alive = queries.dense_views(state)
    return queries.bc_batched_dense(
        am, torch.arange(state.vcap, dtype=torch.int32), alive)


def _assert_matches_cold(svc, scores):
    state = svc.ring.latest.state
    delta, sigma, level, ok = _cold(state)
    slot = svc._bc_scores
    assert torch.equal(slot["level"], level)
    assert torch.equal(slot["sigma"], sigma)
    assert torch.equal(slot["ok"], ok)
    want = torch.where(ok[:, None], delta, 0.0).sum(dim=0)
    want = torch.where(state.alive, want, float("nan"))
    np.testing.assert_allclose(scores.numpy(), want.numpy(), equal_nan=True,
                               **TOL)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("src_chunk", [None, 40])
def test_cold_refresh_under_the_order_matches_vertex_order(graph, src_chunk):
    svc = GraphService(GRAPHS[graph](), batch_size=8)
    scores, _ = svc.bc_scores(src_chunk=src_chunk)
    assert svc.bc_scores_stats["full"] == 1
    _assert_matches_cold(svc, scores)


def _bucket_crossing(state):
    """An op that moves a live vertex across a power of two of out-degree:
    ``PUTE v u`` from a vertex of out-degree 3 to a live vertex it does
    not reach yet (3 -> 4), reached by some other vertex."""
    deg, am, alive = _degrees(state)
    reached = am.any(dim=0)
    for v in torch.nonzero((deg == 3) & reached).flatten().tolist():
        free = torch.nonzero(alive & ~am[v]).flatten().tolist()
        free = [u for u in free if u != v]
        if free:
            return v, free[0]
    raise AssertionError("no vertex of out-degree 3 in the test graph")


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("src_chunk", [None, 40])
def test_delta_across_a_bucket_boundary_is_bit_identical(graph, src_chunk):
    svc = GraphService(GRAPHS[graph](), batch_size=8)
    svc.bc_scores(src_chunk=src_chunk)
    _, am0, alive0 = _degrees(svc.ring.latest.state)
    before = queries.bc_vertex_order(am0, alive0)
    v, u = _bucket_crossing(svc.ring.latest.state)
    for ops in ([(PUTE, v, u, 1.0)], [(REME, v, u)]):
        svc.submit_many(ops)
        svc.flush()
        state = svc.ring.latest.state
        _, am, alive = _degrees(state)
        after = queries.bc_vertex_order(am, alive)
        n_delta = svc.bc_scores_stats["delta"]
        scores, version = svc.bc_scores(src_chunk=src_chunk)
        assert version == svc.version
        assert svc.bc_scores_stats["delta"] == n_delta + 1
        _assert_matches_cold(svc, scores)
        if ops[0][0] == PUTE:
            assert not torch.equal(before, after)   # v moved up a bucket
        else:
            assert torch.equal(before, after)       # and back
