"""Port parity: COO queries, the tile view, batched Brandes and the delta
queries of ``repro_torch`` against ``repro`` on the same snapshots.

BFS ``dist``/``parent``, SSSP ``dist``/``parent``/``negcycle``/``ok`` and
BC ``level``/``sigma``/``ok`` must be equal; BC ``delta`` agrees to
``rtol = atol = 1e-5`` (float summation order, the tolerance
``tests/test_bc_batched.py`` uses between its own paths)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as jc
import repro.core.queries as jq
import repro.core.tiles as jt
import repro.engine.incremental as ji
from repro.data import load_rmat_graph
import repro_torch.core as tc
import repro_torch.core.queries as tq
import repro_torch.core.tiles as tt
import repro_torch.engine.incremental as ti

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _to_torch(jstate):
    return tc.state_from_numpy(*map(_np, jstate), device=CPU)


def _assert_result(jres, tres, close=(), ctx=None):
    for name, a, b in zip(type(jres)._fields, jres, tres):
        a, b = _np(a), b.numpy()
        assert a.shape == b.shape, (ctx, name)
        if name in close:
            np.testing.assert_allclose(b, a, err_msg=str((ctx, name)), **TOL)
        else:
            assert np.array_equal(a, b), (ctx, name)


def _churned_graph(seed=11, n=40, vcap=64, neg=False):
    """Tombstoned edges, dead vertices and (optionally) negative weights."""
    rng = np.random.default_rng(seed)
    g = jc.make_graph(vcap, 512)
    ops = [(jc.PUTV, i) for i in range(n)]
    ops += [(jc.PUTE, int(rng.integers(0, n)), int(rng.integers(0, n)),
             float(rng.integers(1, 4))) for _ in range(160)]
    g, _ = jc.apply_ops(g, ops)
    live = np.flatnonzero(_np(jc.live_edge_mask(g)))[:5]
    rems = [(jc.REME, int(_np(g.esrc)[i]), int(_np(g.edst)[i])) for i in live]
    more = [(jc.REMV, 7), (jc.REMV, 23)]
    if neg:
        more += [(jc.PUTE, 30, 31, -5.0), (jc.PUTE, 31, 30, 1.0)]
    g, _ = jc.apply_ops(g, rems + more)
    return g


@pytest.mark.parametrize("neg", [False, True])
def test_coo_queries_match(neg):
    g = _churned_graph(neg=neg)
    t = _to_torch(g)
    for src in (0, 5, 7, 30, 63, -1, 70):  # dead, empty and out-of-range too
        _assert_result(jq.bfs(g, src), tq.bfs(t, src), ctx=("bfs", src))
        _assert_result(jq.sssp(g, src), tq.sssp(t, src), ctx=("sssp", src))
        _assert_result(jq.bc_dependencies(g, src), tq.bc_dependencies(t, src),
                       close=("delta",), ctx=("bc", src))
    if neg:  # the negative cycle is reachable from 30
        assert bool(tq.sssp(t, 30).negcycle)


def test_tree_parents_and_level_cut_match():
    g = _churned_graph(seed=4)
    t = _to_torch(g)
    srcs = np.array([0, 3, 9], np.int32)
    jd = jnp.stack([jq.bfs(g, int(s)).dist for s in srcs])
    sd = jnp.stack([jq.sssp(g, int(s)).dist for s in srcs])
    assert np.array_equal(
        _np(jq.bfs_tree_parents(g, jd, jnp.asarray(srcs))),
        tq.bfs_tree_parents(t, torch.tensor(_np(jd)),
                            torch.tensor(srcs)).numpy())
    assert np.array_equal(
        _np(jq.sssp_tree_parents(g, sd, jnp.asarray(srcs))),
        tq.sssp_tree_parents(t, torch.tensor(_np(sd)),
                             torch.tensor(srcs)).numpy())
    rng = np.random.default_rng(1)
    levels = np.stack([_np(jq.bfs(g, int(s)).dist) for s in srcs])
    dirty = rng.random(64) < 0.1
    alive = _np(g.alive)
    exp = _np(jq.bc_level_cut(jnp.asarray(levels), jnp.asarray(dirty),
                              jnp.asarray(alive)))
    got = tq.bc_level_cut(torch.tensor(levels), torch.tensor(dirty),
                          torch.tensor(alive)).numpy()
    assert np.array_equal(exp, got)


@pytest.mark.parametrize("tile", [16, 64])
def test_tile_view_build_and_refresh_match(tile):
    rng = np.random.default_rng(tile)
    g = load_rmat_graph(64, 400, seed=2)
    jview = jt.build_tile_view(g, tile=tile)
    tview = tt.build_tile_view(_to_torch(g), tile=tile)
    assert np.array_equal(_np(jview.w), tview.w.numpy())
    assert np.array_equal(_np(jview.occ), tview.occ.numpy())
    assert jt.occupancy_stats(jview) == tt.occupancy_stats(tview)
    for step in range(4):
        ops = [(jc.PUTE, int(rng.integers(0, 64)), int(rng.integers(0, 64)),
                float(rng.integers(1, 9))) for _ in range(6)]
        ops += [(jc.REME, int(rng.integers(0, 64)), int(rng.integers(0, 64)))
                for _ in range(3)] + [(jc.REMV, int(rng.integers(0, 64)))]
        g2, _ = jc.apply_ops(g, ops)
        dirty = jc.dirty_vertices(g, g2)
        jview = jt.refresh_tile_view(g2, jview, dirty, tile=tile)
        tview = tt.refresh_tile_view(_to_torch(g2), tview,
                                     torch.tensor(_np(dirty)), tile=tile)
        assert np.array_equal(_np(jview.w), tview.w.numpy()), step
        assert np.array_equal(_np(jview.occ), tview.occ.numpy()), step
        full = tt.build_tile_view(_to_torch(g2), tile=tile)
        assert torch.equal(full.w, tview.w) and torch.equal(full.occ,
                                                            tview.occ)
        g = g2
    am, w, alive = tt.dense_views_from_tiles(_to_torch(g), tview)
    jam, jw, jalive = jq.dense_views(g)
    assert np.array_equal(_np(jam), am.numpy())
    assert np.array_equal(_np(jw), w.numpy())


@pytest.mark.parametrize("chunk,tiled", [(None, False), (24, True),
                                         (64, True), (200, False)])
def test_bc_batched_dense_matches(chunk, tiled):
    g = load_rmat_graph(64, 400, seed=7, weighted=False)
    g, _ = jc.apply_ops(g, [(jc.REMV, 9)])
    t = _to_torch(g)
    srcs = np.arange(64, dtype=np.int32)
    kw_j, kw_t = {}, {}
    if tiled:
        jview, tview = jt.build_tile_view(g, tile=16), tt.build_tile_view(
            t, tile=16)
        jam, _, jalive = jt.dense_views_from_tiles(g, jview)
        tam, _, talive = tt.dense_views_from_tiles(t, tview)
        kw_j = dict(amask=jview.occ, tile=16)
        kw_t = dict(amask=tview.occ, tile=16)
    else:
        jam, _, jalive = jq.dense_views(g)
        tam, _, talive = tq.dense_views(t)
    exp = jq.bc_batched_dense(jam, jnp.asarray(srcs), jalive, src_chunk=chunk,
                              **kw_j)
    got = tq.bc_batched_dense(tam, torch.tensor(srcs), talive,
                              src_chunk=chunk, **kw_t)
    np.testing.assert_allclose(got[0].numpy(), _np(exp[0]), **TOL)  # delta
    for i in (1, 2, 3):                                    # sigma/level/ok
        assert np.array_equal(got[i].numpy(), _np(exp[i])), i
    # per-source COO Brandes agrees with the batched sweep
    r = tq.bc_dependencies(t, 3)
    assert torch.equal(r.level, got[2][3]) and torch.equal(r.sigma, got[1][3])


def test_bc_batched_warm_start_matches_cold():
    rng = np.random.default_rng(5)
    g = load_rmat_graph(64, 400, seed=3, weighted=False)
    t = _to_torch(g)
    srcs = torch.arange(64, dtype=torch.int32)
    am, _, alive = tq.dense_views(t)
    _, sigma0, level0, _ = tq.bc_batched_dense(am, srcs, alive)
    ops = [(jc.PUTE, int(rng.integers(0, 64)), int(rng.integers(0, 64)), 1.0)
           for _ in range(4)] + [(jc.REME, 0, 1), (jc.REMV, 40), (jc.PUTV, 40)]
    g2, _ = jc.apply_ops(g, ops)
    t2 = _to_torch(g2)
    dirty = tc.dirty_vertices(t, t2)
    am2, _, alive2 = tq.dense_views(t2)
    cut = tq.bc_level_cut(level0, dirty, alive2)
    warm = tq.bc_batched_dense(am2, srcs, alive2, src_chunk=24,
                               prior_level=level0, prior_sigma=sigma0, cut=cut)
    cold = tq.bc_batched_dense(am2, srcs, alive2)
    for a, b in zip(warm, cold):
        assert torch.equal(a, b)
    jam2, _, jalive2 = jq.dense_views(g2)
    exp = jq.bc_batched_dense(jam2, jnp.asarray(srcs.numpy()), jalive2)
    np.testing.assert_allclose(warm[0].numpy(), _np(exp[0]), **TOL)
    assert np.array_equal(warm[1].numpy(), _np(exp[1]))
    assert np.array_equal(warm[2].numpy(), _np(exp[2]))
    with pytest.raises(ValueError, match="warm start"):
        tq.bc_batched_dense(am2, srcs, alive2, prior_level=level0)


def test_bc_wrapper_matches():
    g = load_rmat_graph(32, 160, seed=6, weighted=False)
    t = _to_torch(g)
    exp = float(jq.bc(g, 9))
    for kw in ({}, {"src_chunk": 8}, {"sources": np.arange(32)},
               {"tile_view": tt.build_tile_view(t, tile=16)}):
        np.testing.assert_allclose(float(tq.bc(t, 9, **kw)), exp, **TOL)
    g2, _ = jc.apply_ops(g, [(jc.REMV, 9)])
    assert np.isnan(float(tq.bc(_to_torch(g2), 9)))  # dead vertex: NaN


@pytest.mark.parametrize("seed", [0, 1])
def test_delta_queries_match_reference_and_fresh(seed):
    """delta_bfs/sssp/bc from the same prior + dirty set equal the
    reference's delta answers and the port's own fresh recompute."""
    rng = np.random.default_rng(seed)
    g = load_rmat_graph(64, 400, seed=seed)
    t = _to_torch(g)
    src = 0
    priors_j = (jq.bfs(g, src), jq.sssp(g, src), jq.bc_dependencies(g, src))
    priors_t = (tq.bfs(t, src), tq.sssp(t, src), tq.bc_dependencies(t, src))
    hot = rng.integers(0, 64, 3)
    ops = [(jc.PUTE, int(u), int(rng.integers(0, 64)), float(rng.integers(1, 9)))
           for u in hot] + [(jc.REME, int(u), int(rng.integers(0, 64)))
                            for u in hot]
    g2, _ = jc.apply_ops(g, ops)
    t2 = _to_torch(g2)
    jdirty = jc.dirty_vertices(g, g2)
    tdirty = tc.dirty_vertices(t, t2)
    for kind, jfn, tfn, jp, tp in zip(
            ("bfs", "sssp", "bc"), (ji.delta_bfs, ji.delta_sssp, ji.delta_bc),
            (ti.delta_bfs, ti.delta_sssp, ti.delta_bc), priors_j, priors_t):
        got = tfn(t2, tp, tdirty, src)
        close = ("delta",) if kind == "bc" else ()
        _assert_result(jfn(g2, jp, jdirty, src), got, close=close, ctx=kind)
        assert ti.validate_incremental(t2, src, got, kind), kind
        res, stats = {"bfs": ti.incremental_bfs, "sssp": ti.incremental_sssp,
                      "bc": ti.incremental_bc}[kind](t2, tp, tdirty, src)
        jres, jstats = {"bfs": ji.incremental_bfs,
                        "sssp": ji.incremental_sssp,
                        "bc": ji.incremental_bc}[kind](g2, jp, jdirty, src)
        assert stats.mode == jstats.mode, kind
        _assert_result(jres, res, close=close, ctx=(kind, stats.mode))
