"""Port parity: the sharded tile-grid engine (``repro_torch.shard``) against
the reference (``repro.shard``) on the same numpy inputs.

The port runs on ``GraphMesh(["cpu"] * 4)`` (and ``["cpu"]`` for the
1-shard cases); the reference runs in process on its one CPU device,
whose sharded results equal its single-device path.  One test runs the
reference on four placeholder devices through ``conftest.run_multidevice``
(a JAX subprocess) and compares it with the port's four CPU shards.

Tolerances: BFS ``dist``/``parent``, SSSP ``dist``/``parent``/
``negcycle``/``ok``, BC ``level``/``sigma``/``ok``, the views, ``val_ecnt``
and ``agree`` are compared bit for bit; BC ``delta`` and ``scores`` to
``rtol = atol = 1e-5`` (f32 summation order across ranks, the reference's
own tolerance, ``repro/shard/service.py:88-92``).  Every wait in the
threaded tests has a timeout.
"""
import inspect
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as jc
import repro.core.queries as jq
import repro.shard as js
from repro.core.updates import dirty_vertices as j_dirty
from repro.data import load_rmat_graph
import repro_torch.core as tc
import repro_torch.core.queries as tq
import repro_torch.shard as ts
from repro_torch.core.updates import dirty_vertices as t_dirty
from repro_torch.engine import GraphService
from repro_torch.engine.incremental import results_equal
from repro_torch.obs import Telemetry
from repro_torch.resil import FaultPlan, ResiliencePolicy, fault_scope
from repro_torch.serve import AsyncGraphService

from conftest import run_multidevice

TOL = dict(rtol=1e-5, atol=1e-5)
TILE = 16
WAIT = 120  # seconds any one wait here may take
SRCS = [0, 1, 7, 33, 12, 63, 5, 2, 200, 255]  # dead (7, 33) sources too
CLOSE = ("delta", "scores")


def _np(x):
    return np.asarray(x)


def _to_torch(jstate):
    return tc.state_from_numpy(*map(_np, jstate), device="cpu")


def _mesh(n):
    return ts.GraphMesh(["cpu"] * n)


def _graph(n=256, edges=2000, seed=3):
    """An R-MAT graph with tombstones and dead vertices, in both packages."""
    g = load_rmat_graph(n, edges, seed=seed)
    ops = [(jc.REME, int(g.esrc[5]), int(g.edst[5])),
           (jc.REME, int(g.esrc[40]), int(g.edst[40])),
           (jc.REMV, 7), (jc.REMV, 33)]
    g, _ = jc.apply_ops(g, ops)
    return g, _to_torch(g)


def _churn(jg, tg, ops):
    jg2, _ = jc.apply_ops(jg, ops)
    tg2, _ = tc.apply_ops(tg, ops)
    for a, b in zip(jg2, tg2):
        assert np.array_equal(_np(a), b.numpy())
    return jg2, tg2, j_dirty(jg, jg2), t_dirty(tg, tg2)


def _churn_ops(g):
    """Churn whose poison crosses band boundaries (bands of 64 vertices on
    four shards), with a mid-band death."""
    return [(jc.PUTE, 0, 140, 2.0), (jc.REME, 1, int(g.edst[20])),
            (jc.PUTE, 20, 155, 1.0), (jc.REMV, 12), (jc.PUTE, 147, 18, 3.0),
            (jc.PUTE, 230, 3, 1.0)]


def _assert_same(jres, tres, ctx=None):
    assert type(jres)._fields == type(tres)._fields, ctx
    for name, a, b in zip(type(jres)._fields, jres, tres):
        a, b = _np(a), b.numpy()
        assert a.shape == b.shape, (ctx, name, a.shape, b.shape)
        if name in CLOSE:
            np.testing.assert_allclose(b, a, err_msg=str((ctx, name)), **TOL)
        else:
            assert np.array_equal(a, b), (ctx, name)


def _assert_view(jview, tview):
    jv, tv = js.gather_view(jview), ts.gather_view(tview)
    assert np.array_equal(_np(jv.w), tv.w.numpy())
    assert np.array_equal(_np(jv.occ), tv.occ.numpy())


# ------------------------------- the package -------------------------------

def test_exports_match_the_reference():
    names = [n for n in dir(js) if not n.startswith("_")
             and not inspect.ismodule(getattr(js, n))]
    assert len(names) >= 23
    assert [n for n in names if not hasattr(ts, n)] == []


def test_bc_mode_and_kind_validation():
    _, g = _graph(n=64, edges=300)
    view = ts.build_sharded_view(g, _mesh(1), tile=TILE)
    with pytest.raises(ValueError) as ei:
        ts.bc_batched(view, g, [0], bc_mode="bogus")
    assert "gather" in str(ei.value) and "ring" in str(ei.value)
    with pytest.raises(ValueError) as ei:
        ts.ShardedGraphService(g, _mesh(1), tile=TILE, bc_mode="bogus")
    assert "ring" in str(ei.value)
    with pytest.raises(ValueError):
        ts.query_fn(_mesh(1), "pagerank", TILE)


# ------------------------------ the group ---------------------------------

def test_group_collectives_are_rank_ordered():
    mesh = _mesh(4)

    def body(g, x):
        r = g.axis_index()
        assert g.size() == 4
        s = g.psum(x)
        m = g.pmax(x)
        gathered = g.all_gather(x[None])
        perm = [(j, (j + 1) % 4) for j in range(4)]
        got = g.ppermute((x, x * 2), perm)
        none = g.ppermute(x, [(0, 1)])
        return s, m, gathered, got[0], got[1], none, g.pmax(r), g.psum(1)

    xs = [torch.full((3,), float(r + 1)) for r in range(4)]
    group = ts.ThreadGroup(mesh)
    outs = group.run(body, [(x,) for x in xs])
    for r, (s, m, gath, got0, got1, none, pm, ps) in enumerate(outs):
        assert torch.equal(s, torch.full((3,), 10.0))
        assert torch.equal(m, torch.full((3,), 4.0))
        assert torch.equal(gath, torch.stack(xs))
        assert torch.equal(got0, xs[(r - 1) % 4])
        assert torch.equal(got1, 2 * xs[(r - 1) % 4])
        assert torch.equal(none, xs[0] if r == 1 else torch.zeros(3))
        assert pm == 3 and ps == 4
    # one rank's result bytes per op name: the HLO counts of the reference
    assert group.bytes == {"all-reduce": 2 * 12 + 2 * 4,
                           "all-gather": 4 * 12,
                           "collective-permute": 2 * 12 + 12}
    assert group.calls["collective-permute"] == 2


def test_group_float_sums_do_not_depend_on_timing():
    """Every rank sums in rank order: equal results on every rank and on
    every run, whichever thread reaches the barrier first."""
    rng = np.random.default_rng(0)
    xs = [torch.tensor(rng.standard_normal(257).astype(np.float32))
          for _ in range(4)]
    expect = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    for _ in range(5):
        outs = ts.ThreadGroup(_mesh(4)).run(
            lambda g, x: g.psum(x), [(x,) for x in xs])
        for o in outs:
            assert torch.equal(o, expect)


def test_group_failure_reaches_every_rank():
    def body(g):
        if g.axis_index() == 2:
            raise KeyError("rank 2 fails")
        return g.psum(torch.ones(2))

    with pytest.raises(KeyError, match="rank 2"):
        ts.ThreadGroup(_mesh(4)).run(body, [()] * 4)
    mesh = ts.GraphMesh(["cpu"] * 2, timeout=0.5)

    def stuck(g):
        if g.axis_index() == 0:
            return g.psum(1)  # rank 1 never joins
        return 0

    with pytest.raises(TimeoutError):
        ts.ThreadGroup(mesh).run(stuck, [()] * 2)


def test_launch_counts_survive_concurrent_ranks():
    """Ranks launch from threads of their own: the kernels' launch counts
    lose no update (more threads than cores, a short switch interval)."""
    import sys

    from repro_torch.kernels.backend import count_launch

    counts = {"k": 0}
    n_threads, per = 16, 2000

    def hammer():
        for _ in range(per):
            count_launch(counts, "k")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert counts["k"] == n_threads * per


def test_graph_mesh_devices_and_defaults():
    mesh = ts.GraphMesh([["cpu", "cpu"], ["cpu"]])
    assert mesh.size == 3 and mesh == _mesh(3) and mesh != _mesh(2)
    assert ts.as_graph_mesh(mesh) is mesh
    assert ts.as_graph_mesh(["cpu"] * 2) == _mesh(2)
    with pytest.raises(ValueError):
        ts.GraphMesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ts.as_graph_mesh(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            ts.GraphMesh(["cuda:0"])


# ------------------------------- the view ---------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_view_build_and_refresh_match_reference(n):
    """Build + per-rank dirty-row refresh under a stream of commits, then
    compact and both grows: equal to the reference's view and to a fresh
    build at every step."""
    from repro.core import compact as j_compact, grow_edges as j_grow_e, \
        grow_vertices as j_grow_v
    from repro_torch.core import compact as t_compact, \
        grow_edges as t_grow_e, grow_vertices as t_grow_v

    jg, tg = _graph()
    jmesh, mesh = js.as_graph_mesh(), _mesh(n)
    jview = js.build_sharded_view(jg, jmesh, tile=TILE)
    tview = ts.build_sharded_view(tg, mesh, tile=TILE)
    assert tview.vp % (n * TILE) == 0 and tview.band == tview.vp // n
    assert all(b.shape == (tview.band, tview.vp) for b in tview.w)
    _assert_view(jview, tview)
    stats = ts.sharded_occupancy_stats(tview)
    jstats = js.sharded_occupancy_stats(jview)
    assert len(stats["per_shard_tile_skip_rate"]) == n
    for key in ("tiles_total", "tiles_active", "live_edges", "grid"):
        assert stats[key] == jstats[key], key
    rng = np.random.default_rng(0)
    for i in range(6):
        ops = [(jc.PUTE, int(rng.integers(0, 256)), int(rng.integers(0, 256)),
                float(rng.integers(1, 9))) for _ in range(5)]
        ops += [(jc.REME, int(rng.integers(0, 256)),
                 int(rng.integers(0, 256))),
                (jc.REMV, int(rng.integers(0, 256))) if i == 3 else
                (jc.PUTV, int(rng.integers(0, 256)))]
        jg2, tg2, jd, td = _churn(jg, tg, ops)
        jview = js.refresh_sharded_view(jg2, jview, jd)
        tview = ts.refresh_sharded_view(tg2, tview, td)
        _assert_view(jview, tview)
        jg, tg = jg2, tg2
    fresh = ts.gather_view(ts.build_sharded_view(tg, mesh, tile=TILE))
    assert torch.equal(ts.gather_view(tview).w, fresh.w)
    jg, tg = j_compact(jg), t_compact(tg)
    jview = js.refresh_sharded_view(jg, jview, jnp.zeros((256,), bool))
    tview = ts.refresh_sharded_view(tg, tview, torch.zeros(256, dtype=bool))
    _assert_view(jview, tview)
    jg, tg = j_grow_e(jg), t_grow_e(tg)
    jg2, tg2, jd, td = _churn(jg, tg, [(jc.PUTE, 1, 2, 4.0)])
    _assert_view(js.refresh_sharded_view(jg2, jview, jd),
                 ts.refresh_sharded_view(tg2, tview, td))
    jg3, tg3 = j_grow_v(jg2), t_grow_v(tg2)
    jg4, tg4, _, _ = _churn(jg3, tg3, [(jc.PUTV, 300), (jc.PUTE, 1, 300, 2.)])
    tview = ts.refresh_sharded_view(tg4, tview,
                                    torch.ones(tg4.vcap, dtype=bool))
    _assert_view(js.build_sharded_view(jg4, jmesh, tile=TILE), tview)


def test_batched_refresh_dispatch_counts():
    """Dirty rows of one rank re-derive together: fewer dispatches than
    rows, the result equal to a rebuild."""
    rng = np.random.default_rng(5)
    jg = load_rmat_graph(256, 2000, seed=2)
    tg = _to_torch(jg)
    mesh = _mesh(4)
    view = ts.build_sharded_view(tg, mesh, tile=TILE)
    ops = [(jc.PUTE, int(rng.integers(0, 96)), int(rng.integers(0, 256)), 2.)
           for _ in range(40)]
    _, tg2, _, td = _churn(jg, tg, ops)
    r0, d0 = ts.refresh_stats.rows, ts.refresh_stats.dispatches
    view2 = ts.refresh_sharded_view(tg2, view, td)
    rows = ts.refresh_stats.rows - r0
    dispatches = ts.refresh_stats.dispatches - d0
    assert rows > 1 and dispatches < rows, (rows, dispatches)
    ref = ts.gather_view(ts.build_sharded_view(tg2, mesh, tile=TILE))
    assert torch.equal(ts.gather_view(view2).w, ref.w)
    assert torch.equal(ts.gather_view(view2).occ, ref.occ)


def test_refresh_strategies():
    jg, tg = _graph()
    mesh = _mesh(4)
    view = ts.build_sharded_view(tg, mesh, tile=TILE)
    assert ts.refresh_sharded_view(tg, view,
                                   torch.zeros(256, dtype=bool)) is view
    _, tg2, _, td = _churn(jg, tg, [(jc.PUTE, 3, 9, 2.0)])
    view2 = ts.refresh_sharded_view(tg2, view, td, tile=32)
    assert view2.tile == 32
    assert torch.equal(ts.gather_view(view2).occ, ts.gather_view(
        ts.build_sharded_view(tg2, mesh, tile=32)).occ)
    with pytest.raises(ValueError):
        ts.refresh_sharded_view(tg2, None, None)


# ------------------------------ the queries -------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_queries_match_reference(n):
    """Cold bfs/sssp (dist, parent, ok, negcycle, val_ecnt, agree) and BC in
    both modes, chunked and not, against the reference's sharded path."""
    jg, tg = _graph()
    jview = js.build_sharded_view(jg, js.as_graph_mesh(), tile=TILE)
    tview = ts.build_sharded_view(tg, _mesh(n), tile=TILE)
    srcs = np.asarray(SRCS, np.int32)
    _assert_same(js.bfs(jview, jg, srcs), ts.bfs(tview, tg, srcs), "bfs")
    _assert_same(js.sssp(jview, jg, srcs), ts.sssp(tview, tg, srcs), "sssp")
    for mode in ("gather", "ring"):
        for chunk in (None, 1):
            _assert_same(
                js.bc_batched(jview, jg, srcs, src_chunk=chunk, bc_mode=mode),
                ts.bc_batched(tview, tg, srcs, src_chunk=chunk, bc_mode=mode),
                (mode, chunk))


def test_bc_default_sources_and_padding():
    """Source counts that do not divide the mesh are padded with -1 and the
    padding sliced off; ``srcs=None`` means every vertex slot."""
    jg, tg = _graph(n=64, edges=400)
    jview = js.build_sharded_view(jg, js.as_graph_mesh(), tile=TILE)
    tview = ts.build_sharded_view(tg, _mesh(4), tile=TILE)
    r = ts.bc_batched(tview, tg, [0, 5, 9])
    assert r.delta.shape == (3, 64) and r.ok.shape == (3,)
    _assert_same(js.bc_batched(jview, jg, None),
                 ts.bc_batched(tview, tg, None, bc_mode="ring"))


@pytest.mark.parametrize("bc_mode", ["gather", "ring"])
def test_delta_queries_match_reference(bc_mode):
    """Delta bfs/sssp/bc under cross-band churn: equal to the reference's
    delta, to the port's full sharded recompute, and (bfs/sssp) to the
    local engine's per-source delta."""
    from repro_torch.engine import delta_bfs, delta_sssp

    jg, tg = _graph()
    jview = js.build_sharded_view(jg, js.as_graph_mesh(), tile=TILE)
    tview = ts.build_sharded_view(tg, _mesh(4), tile=TILE)
    srcs = np.asarray(SRCS, np.int32)
    jp = (js.bfs(jview, jg, srcs), js.sssp(jview, jg, srcs),
          js.bc_batched(jview, jg, srcs, src_chunk=3, bc_mode=bc_mode))
    tp = (ts.bfs(tview, tg, srcs), ts.sssp(tview, tg, srcs),
          ts.bc_batched(tview, tg, srcs, src_chunk=3, bc_mode=bc_mode))
    jg2, tg2, jd, td = _churn(jg, tg, _churn_ops(jg))
    jview = js.refresh_sharded_view(jg2, jview, jd)
    tview = ts.refresh_sharded_view(tg2, tview, td)
    jr = (js.delta_bfs_sharded(jview, jg2, jp[0], jd, srcs),
          js.delta_sssp_sharded(jview, jg2, jp[1], jd, srcs),
          js.delta_bc_sharded(jview, jg2, jp[2], jd, srcs, src_chunk=3,
                              bc_mode=bc_mode))
    tr = (ts.delta_bfs_sharded(tview, tg2, tp[0], td, srcs),
          ts.delta_sssp_sharded(tview, tg2, tp[1], td, srcs),
          ts.delta_bc_sharded(tview, tg2, tp[2], td, srcs, src_chunk=3,
                              bc_mode=bc_mode))
    for kind, a, b in zip(("bfs", "sssp", "bc"), jr, tr):
        _assert_same(a, b, ("delta", kind))
        assert ts.validate_incremental_sharded(
            tview, tg2, srcs, b, kind, src_chunk=3, bc_mode=bc_mode), kind
    for i, s in enumerate(SRCS):
        lb = delta_bfs(tg2, tq.bfs(tg, s), td, s)
        assert torch.equal(tr[0].dist[i], lb.dist), s
        assert torch.equal(tr[0].parent[i], lb.parent), s
        ls = delta_sssp(tg2, tq.sssp(tg, s), td, s)
        assert torch.equal(tr[1].dist[i], ls.dist), s
        assert torch.equal(tr[1].parent[i], ls.parent), s


def test_delta_revived_source_restarts_cold():
    """A source dead when the prior was cached and resurrected since has an
    EMPTY prior row: recomputed from scratch in both BC modes, and the
    service ladder does not answer "unchanged"."""
    jg, tg = _graph()  # 7 and 33 are dead
    tview = ts.build_sharded_view(tg, _mesh(4), tile=TILE)
    srcs = [0, 7]
    pb = ts.bfs(tview, tg, srcs)
    pcs = {m: ts.bc_batched(tview, tg, srcs, src_chunk=2, bc_mode=m)
           for m in ("gather", "ring")}
    assert not bool(pb.ok[1])
    ops = [(jc.PUTV, 7), (jc.PUTE, 7, 20, 1.0), (jc.PUTE, 0, 40, 2.0)]
    jg2, tg2, jd, td = _churn(jg, tg, ops)
    tview = ts.refresh_sharded_view(tg2, tview, td)
    db = ts.delta_bfs_sharded(tview, tg2, pb, td, srcs)
    assert ts.validate_incremental_sharded(tview, tg2, srcs, db, "bfs")
    assert bool(db.ok[1]) and int(db.dist[1, 7]) == 0
    jview = js.build_sharded_view(jg2, js.as_graph_mesh(), tile=TILE)
    _assert_same(js.bfs(jview, jg2, np.asarray(srcs, np.int32)), db)
    for mode, prior in pcs.items():
        dc = ts.delta_bc_sharded(tview, tg2, prior, td, srcs, src_chunk=2,
                                 bc_mode=mode)
        assert ts.validate_incremental_sharded(
            tview, tg2, srcs, dc, "bc", src_chunk=2, bc_mode=mode), mode
        assert bool(dc.ok[1]) and int(dc.level[1, 7]) == 0, mode
    svc = ts.ShardedGraphService(tg, _mesh(4), tile=TILE, batch_size=4)
    local = GraphService(tg, batch_size=4)
    svc.query("bfs", [7])
    ops = [(jc.PUTV, 7), (jc.PUTE, 7, 20, 1.0)]
    svc.submit_many(ops)
    local.submit_many(ops)
    svc.flush()
    local.flush()
    rep = svc.query("bfs", [7])
    assert rep.mode != "unchanged"
    assert torch.equal(rep.result.dist[0], local.query("bfs", 7).result.dist)


@pytest.mark.parametrize("bc_mode", ["gather", "ring"])
def test_negcycle_delta_falls_back_to_full(bc_mode):
    """A negative cycle born since the cached answer: the delta re-relax
    flags it and the service re-runs the full query, as the reference's
    does; a negcycle prior is never a warm start."""
    jg, tg = _graph()
    mesh = _mesh(4)
    view = ts.build_sharded_view(tg, mesh, tile=TILE)
    prior = ts.sssp(view, tg, [0])
    assert not bool(prior.negcycle.any())
    reached = np.flatnonzero(prior.dist[0].numpy() < np.inf)
    a, b = (int(v) for v in reached[1:3])
    ops = [(jc.PUTE, a, b, 1.0), (jc.PUTE, b, a, -5.0)]
    jg2, tg2, jd, td = _churn(jg, tg, ops)
    view2 = ts.refresh_sharded_view(tg2, view, td)
    ds = ts.delta_sssp_sharded(view2, tg2, prior, td, [0])
    assert bool(ds.negcycle[0]) and not bool(ds.ok[0])
    jview = js.build_sharded_view(jg2, js.as_graph_mesh(), tile=TILE)
    _assert_same(js.sssp(jview, jg2, np.asarray([0], np.int32)),
                 ts.sssp(view2, tg2, [0]))

    svc = ts.ShardedGraphService(tg, mesh, tile=TILE, batch_size=4,
                                 bc_mode=bc_mode)
    rep0 = svc.query("sssp", [0])
    assert rep0.mode == "full" and not bool(rep0.result.negcycle[0])
    svc.submit_many(ops)
    svc.flush()
    ring_dirty = svc.ring.dirty_between(rep0.version, svc.version)
    state = svc.ring.latest.state
    assert svc._delta_collect("sssp", rep0.result, ring_dirty, [0],
                              state) is None
    rep = svc.query("sssp", [0])
    assert rep.mode == "full" and bool(rep.result.negcycle[0])
    assert torch.equal(rep.result.dist, ts.sssp(svc.view(), state, [0]).dist)
    svc.submit_many([(jc.PUTE, a, int(reached[3]), 1.0)])
    svc.flush()
    rep2 = svc.query("sssp", [0])
    assert rep2.mode == "full" and bool(rep2.result.negcycle[0])


# ------------------------------ the service -------------------------------

def _ladder(svc_j, svc_t, ops_list, queries):
    """The same commits and queries through both services; every reply and
    mode equal."""
    for ops in [None] + ops_list:
        if ops is not None:
            svc_j.submit_many(ops)
            svc_t.submit_many(ops)
            svc_j.flush()
            svc_t.flush()
        for kind, srcs, mode in queries:
            jsrcs = None if srcs is None else np.asarray(srcs, np.int32)
            jr = svc_j.query(kind, jsrcs, mode=mode)
            tr = svc_t.query(kind, srcs, mode=mode)
            ctx = (kind, srcs, mode, tr.version)
            assert (jr.version, jr.mode, jr.validated) == \
                (tr.version, tr.mode, tr.validated), ctx
            _assert_same(jr.result, tr.result, ctx)


@pytest.mark.parametrize("bc_mode", ["gather", "ring"])
def test_service_ladder_matches_reference(bc_mode):
    """The port's ShardedGraphService on four CPU shards climbs unchanged ->
    delta -> full exactly as the reference's does, with equal replies
    (cn double collects included) and tallies; bc_scores rides the
    level-cut delta."""
    jg = load_rmat_graph(256, 2400, seed=5)
    tg = _to_torch(jg)
    svc_j = js.ShardedGraphService(jg, js.as_graph_mesh(), tile=TILE,
                                   batch_size=4, bc_mode=bc_mode,
                                   src_chunk=64)
    svc_t = ts.ShardedGraphService(tg, _mesh(4), tile=TILE, batch_size=4,
                                   bc_mode=bc_mode, src_chunk=64)
    ops_list = [[(jc.PUTE, 0, v, 1.0) for v in (9, 11, 13, 15)]
                + [(jc.REME, 0, 9)],
                [(jc.PUTE, 250, 251 - i, 1.0) for i in range(4)],
                [(jc.PUTE, 3, 17, 1.0)],
                [(jc.PUTE, 0, 21, 1.0), (jc.REMV, 40)]]
    queries = [("bfs", [0, 1], "icn"), ("sssp", [0], "icn"),
               ("bc", [0, 3, 5], "icn"), ("sssp", [1], "cn"),
               ("bc", None, "icn")]
    _ladder(svc_j, svc_t, ops_list, queries)
    assert svc_t.stats.as_dict() == svc_j.stats.as_dict()
    assert svc_t.stats.delta >= 3 and svc_t.stats.unchanged >= 1
    js_, jv = svc_j.bc_scores()
    ts_, tv = svc_t.bc_scores()
    assert jv == tv
    np.testing.assert_allclose(ts_.numpy(), _np(js_), **TOL)
    lsc, _ = GraphService(svc_t.ring.latest.state).bc_scores()
    np.testing.assert_allclose(ts_.numpy(), lsc.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_collective_bytes():
    """Bytes per collective, counted as they run: the ring moves one band
    (f32) plus its occupancy band (int32) a rotation, ``n - 1`` rotations a
    product; BFS one int8 S x Vp pmax a level, SSSP one f32 S x Vp merge;
    gather mode one all-gather of the whole grid.  The service's traced
    cost carries them."""
    from repro_torch.shard.queries import _launch, _program

    _, tg = _graph()
    mesh = _mesh(4)
    view = ts.build_sharded_view(tg, mesh, tile=TILE)
    S, vp = 8, view.vp
    srcs = torch.tensor(SRCS[:S], dtype=torch.int32)
    band, rows, nt = view.band, view.rows_per_shard, view.n_tiles
    per_rot = band * vp * 4 + rows * nt * 4
    assert per_rot == vp * vp + nt * nt
    args = (view.w, view.occ, tg.alive, tg.ecnt, srcs, tg.version)

    def run(kind, chunk=None):
        body, layouts = _program(mesh, kind, TILE, None, chunk)
        return _launch(mesh, body, layouts, args)[1]

    g = run("bc_ring", chunk=1)
    assert g.bytes["collective-permute"] % per_rot == 0
    assert g.bytes["collective-permute"] == (
        g.calls["collective-permute"] * per_rot)
    assert g.calls["collective-permute"] % 3 == 0  # n - 1 hops a product
    g = run("bc")
    assert g.bytes["all-gather"] == vp * vp * 4 + nt * nt * 4
    assert "collective-permute" not in g.bytes
    scalars = 3 * 4  # the version agreement: pmax + two psums of int32
    g = run("bfs")
    levels = g.calls["all-reduce"] - 3
    assert g.bytes["all-reduce"] == levels * S * vp + scalars
    g = run("sssp")
    passes = g.calls["all-reduce"] - 3
    assert g.bytes["all-reduce"] == passes * 4 * S * vp + scalars

    tel = Telemetry(block=False)
    svc = ts.ShardedGraphService(tg, mesh, tile=TILE, telemetry=tel,
                                 bc_mode="ring")
    svc.query("bfs", SRCS[:S])
    svc.query("bc", [0, 1, 2, 3])
    recs = [r for r in tel.tracer.records if r["span"] == "query"]
    assert recs[0]["coll_bytes"] >= S * vp
    assert recs[1]["coll_bytes"] >= 3 * per_rot
    tel.close()


def test_bc_map_and_sync_hooks():
    """``bc(method="map")`` equals the reference's per-source baseline and
    the batched path; the sweep's lock-step hooks at their defaults leave
    every result as it was, and are called once per forward level and once
    per chunk."""
    jg, tg = _graph(n=64, edges=400)
    srcs = [0, 1, 5, 9, 33]
    for v in (3, 12, 33):
        want = _np(jq.bc(jg, v, jnp.asarray(srcs), method="map"))
        got = tq.bc(tg, v, srcs, method="map").numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(
            got, tq.bc(tg, v, srcs).numpy(), **TOL)
        np.testing.assert_allclose(
            tc.bc_map(tg, v, srcs).numpy(),
            _np(jc.bc_map(jg, v, jnp.asarray(srcs))), **TOL)
    with pytest.raises(ValueError):
        tq.bc(tg, 3, srcs, method="bogus")
    am, _, alive = tc.dense_views(tg)
    s = torch.tensor(srcs, dtype=torch.int32)
    base = tq.bc_batched_dense(am, s, alive, src_chunk=2)
    calls = {"any": 0, "max": 0}

    def any_(p):
        calls["any"] += 1
        return p

    def max_(x):
        calls["max"] += 1
        return x

    hooked = tq.bc_batched_dense(am, s, alive, src_chunk=2, sync_any=any_,
                                 sync_max=max_)
    for a, b in zip(base, hooked):
        assert torch.equal(a, b)
    assert calls["max"] == 3 and calls["any"] >= 3


def test_core_counts_match_reference():
    jg, tg = _graph()
    assert int(tc.num_vertices(tg)) == int(jc.num_vertices(jg))
    assert int(tc.num_edges(tg)) == int(jc.num_edges(jg))
    assert tc.num_edges(tg).dtype == torch.int32
    jv, tv = jc.build_tile_view(jg, 32), tc.build_tile_view(tg, 32)
    assert np.array_equal(_np(jc.active_tile_mask(jv)),
                          tc.active_tile_mask(tv).numpy())


# ---------------------------- the front end -------------------------------

def _front_end_run(plan=None, seed=21, bc_mode="gather"):
    """Clients and an updater race through ``AsyncGraphService`` over a
    4-shard ``ShardedGraphService``; every reply equals a fresh full
    sharded collect at the version it names."""
    rng = np.random.default_rng(seed)
    jg = load_rmat_graph(256, 1600, seed=seed)
    tg = _to_torch(jg)
    per_commit = 4
    chunks = [[(jc.PUTE, int(rng.integers(0, 64)), int(rng.integers(0, 256)),
                float(rng.integers(1, 9))) for _ in range(per_commit)]
              for _ in range(6)]
    policy = ResiliencePolicy(max_retries=2) if plan is not None else None
    tel = Telemetry(block=False)
    svc = ts.ShardedGraphService(tg, _mesh(4), tile=TILE,
                                 batch_size=per_commit, bc_mode=bc_mode,
                                 telemetry=tel, policy=policy)
    asks = [("bfs", [0, 1]), ("sssp", [0]), ("bc", [0, 3]), ("bfs", [0, 1]),
            ("sssp", [5]), ("bc", [0, 3])]
    futs, errs = [], []
    lock = threading.Lock()

    def client(i):
        try:
            for k in range(6):
                kind, srcs = asks[(i + k) % len(asks)]
                f = srv.query_async(kind, srcs)
                with lock:
                    futs.append((kind, srcs, f))
        except Exception as e:  # pragma: no cover - harness guard
            errs.append(e)

    def updater():
        try:
            for ops in chunks:
                srv.submit_many(ops)
        except Exception as e:  # pragma: no cover - harness guard
            errs.append(e)

    with fault_scope(plan):
        srv = AsyncGraphService(svc, max_batch=16).start()
        try:
            # a first wave at version 0, before any commit: served by dedup
            warm = [(kind, srcs, srv.query_async(kind, srcs))
                    for kind, srcs in asks]
            for _, _, f in warm:
                f.exception(timeout=WAIT)
            futs.extend(warm)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(3)]
            threads.append(threading.Thread(target=updater))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
                assert not t.is_alive()
            assert srv.drain(timeout=WAIT)
        finally:
            srv.stop(timeout=WAIT)
    assert not errs, errs
    states = [tg]
    for ops in chunks:
        states.append(tc.apply_ops(states[-1], ops,
                                   batch_size=per_commit)[0])
    assert svc.version == len(chunks)
    replies = []
    for kind, srcs, f in futs:
        try:
            replies.append((kind, srcs, f.result(timeout=WAIT)))
        except Exception:
            assert plan is not None
    mesh = _mesh(4)
    for kind, srcs, rep in replies:
        state = states[rep.version]
        view = ts.build_sharded_view(state, mesh, tile=TILE)
        fresh = (ts.bc_batched(view, state, srcs, bc_mode=bc_mode)
                 if kind == "bc" else
                 {"bfs": ts.bfs, "sssp": ts.sssp}[kind](view, state, srcs))
        assert results_equal(rep.result, fresh), (kind, srcs, rep.version,
                                                  rep.mode)
        assert rep.degraded or rep.validated  # the agreement flag
    assert svc.ring.pinned_versions() == []
    st = svc.stats
    assert st.unchanged + st.delta + st.full == st.queries
    dedup = sum(sum(h.samples) for h in
                tel.registry.find("serve_batch_size", rung="dedup"))
    tel.close()
    return srv.stats, st, replies, dedup


def test_front_end_serves_the_sharded_service():
    """Clean: every request answered exactly, by a shared collect at the
    latest version (dedup) or, for a group pinned behind a commit, by the
    per-request path at the latest version."""
    serve, st, replies, dedup = _front_end_run()
    assert len(replies) == 24 and st.errors == 0
    assert dedup >= 6 and dedup + serve.fallbacks == 24
    assert all(not rep.degraded for _, _, rep in replies)


def test_front_end_over_sharded_service_under_faults():
    plan = FaultPlan(seed=7, rate=0.25)
    serve, st, replies, _ = _front_end_run(plan, seed=22, bc_mode="ring")
    assert plan.fired > 0 and replies
    assert serve.fallbacks > 0 or st.retries > 0


# ------------------------ four placeholder devices ------------------------

def test_queries_match_reference_on_four_devices(tmp_path):
    """The reference on four placeholder devices (a JAX subprocess) and the
    port on four CPU shards: cold and delta bfs/sssp and BC in both modes,
    on the same numpy inputs."""
    out = tmp_path / "ref.npz"
    run_multidevice(f"""
import numpy as np, jax, jax.numpy as jnp
import repro.core as jc
from repro.core.updates import dirty_vertices
from repro.data import load_rmat_graph
import repro.shard as js

mesh = js.as_graph_mesh()
assert mesh.devices.size == 4
g = load_rmat_graph(256, 2000, seed=3)
g, _ = jc.apply_ops(g, [(jc.REME, int(g.esrc[5]), int(g.edst[5])),
                        (jc.REME, int(g.esrc[40]), int(g.edst[40])),
                        (jc.REMV, 7), (jc.REMV, 33)])
ops = [(jc.PUTE, 0, 140, 2.0), (jc.REME, 1, int(g.edst[20])),
       (jc.PUTE, 20, 155, 1.0), (jc.REMV, 12), (jc.PUTE, 147, 18, 3.0),
       (jc.PUTE, 230, 3, 1.0)]
srcs = np.asarray({SRCS}, np.int32)
view = js.build_sharded_view(g, mesh, tile={TILE})
res = {{}}
p = dict(bfs=js.bfs(view, g, srcs), sssp=js.sssp(view, g, srcs))
for m in ("gather", "ring"):
    p["bc_" + m] = js.bc_batched(view, g, srcs, src_chunk=3, bc_mode=m)
g2, _ = jc.apply_ops(g, ops)
d = dirty_vertices(g, g2)
view = js.refresh_sharded_view(g2, view, d)
r = dict(bfs=js.delta_bfs_sharded(view, g2, p["bfs"], d, srcs),
         sssp=js.delta_sssp_sharded(view, g2, p["sssp"], d, srcs))
for m in ("gather", "ring"):
    r["bc_" + m] = js.delta_bc_sharded(view, g2, p["bc_" + m], d, srcs,
                                       src_chunk=3, bc_mode=m)
for tag, group in (("cold", p), ("delta", r)):
    for k, v in group.items():
        for f, x in zip(type(v)._fields, v):
            res[f"{{tag}}/{{k}}/{{f}}"] = np.asarray(x)
np.savez({str(out)!r}, **res)
print("REF OK")
""")
    ref = np.load(out)
    jg, tg = _graph()
    jg2, tg2, _, td = _churn(jg, tg, _churn_ops(jg))
    srcs = np.asarray(SRCS, np.int32)
    view = ts.build_sharded_view(tg, _mesh(4), tile=TILE)
    p = dict(bfs=ts.bfs(view, tg, srcs), sssp=ts.sssp(view, tg, srcs))
    for m in ("gather", "ring"):
        p["bc_" + m] = ts.bc_batched(view, tg, srcs, src_chunk=3, bc_mode=m)
    view = ts.refresh_sharded_view(tg2, view, td)
    r = dict(bfs=ts.delta_bfs_sharded(view, tg2, p["bfs"], td, srcs),
             sssp=ts.delta_sssp_sharded(view, tg2, p["sssp"], td, srcs))
    for m in ("gather", "ring"):
        r["bc_" + m] = ts.delta_bc_sharded(view, tg2, p["bc_" + m], td, srcs,
                                           src_chunk=3, bc_mode=m)
    for tag, group in (("cold", p), ("delta", r)):
        for k, v in group.items():
            for f, x in zip(type(v)._fields, v):
                want = ref[f"{tag}/{k}/{f}"]
                ctx = (tag, k, f)
                assert want.shape == tuple(x.shape), ctx
                if f in CLOSE:
                    np.testing.assert_allclose(x.numpy(), want,
                                               err_msg=str(ctx), **TOL)
                else:
                    assert np.array_equal(x.numpy(), want), ctx
