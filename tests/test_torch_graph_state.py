"""Port parity: graph state, batched updates, dirty sets and the R-MAT
generator of ``repro_torch`` against ``repro`` on the same numpy inputs.

Every state array, every ``OpResults`` field and every dirty set must be
equal (the update path is integer/bitwise: no tolerance applies)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as jc
import repro.core.graph_state as jgs
import repro.data.rmat as jrmat
import repro_torch.core as tc
import repro_torch.core.graph_state as tgs
import repro_torch.data.rmat as trmat

CPU = "cpu"


def _np(x):
    return np.asarray(x)


def _to_torch(jstate):
    return tc.state_from_numpy(*map(_np, jstate), device=CPU)


def _assert_state_equal(jstate, tstate, ctx=None):
    for name, a, b in zip(jc.GraphState._fields, jstate,
                          tc.state_to_numpy(tstate)):
        assert _np(a).dtype == b.dtype, (ctx, name)
        assert np.array_equal(_np(a), b), (ctx, name)


def _assert_results_equal(jres, tres, ctx=None):
    for name, a, b in zip(jc.OpResults._fields, jres, tres):
        assert np.array_equal(_np(a), b.numpy()), (ctx, name)


def _random_ops(rng, n, count):
    """Every op kind, dense ids (duplicates within a batch), some ids out of
    range on either side, and NOPs."""
    ops = []
    for _ in range(count):
        r = float(rng.random())
        u = int(rng.integers(-2, n + 3))
        v = int(rng.integers(-2, n + 3))
        w = float(rng.integers(1, 4))
        if r < 0.15:
            ops.append((jc.PUTV, u))
        elif r < 0.25:
            ops.append((jc.REMV, u))
        elif r < 0.65:
            ops.append((jc.PUTE, u, v, w))
        elif r < 0.8:
            ops.append((jc.REME, u, v))
        elif r < 0.88:
            ops.append((jc.GETV, u))
        elif r < 0.96:
            ops.append((jc.GETE, u, v))
        else:
            ops.append((jc.NOP,))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rmat_edges_identical(seed):
    for a, b in zip(jrmat.rmat_edges(64, 400, seed=seed),
                    trmat.rmat_edges(64, 400, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _assert_state_equal(jrmat.load_rmat_graph(64, 400, seed=seed),
                        trmat.load_rmat_graph(64, 400, seed=seed,
                                              device=CPU))


def test_state_numpy_round_trip():
    g = jrmat.load_rmat_graph(32, 160, seed=4)
    t = _to_torch(g)
    _assert_state_equal(g, t)
    back = tc.state_from_numpy(*tc.state_to_numpy(t), device=CPU)
    _assert_state_equal(g, back)
    assert isinstance(tc.state_to_numpy(t).esrc, np.ndarray)
    assert tc.state_to_numpy(t).vcap == 32


def test_make_graph_and_from_edge_list_match():
    _assert_state_equal(jc.make_graph(16, 40), tc.make_graph(16, 40,
                                                             device=CPU))
    rng = np.random.default_rng(3)
    src = rng.integers(0, 20, 60)
    dst = rng.integers(0, 20, 60)
    w = rng.integers(1, 5, 60).astype(np.float32)  # duplicates: keep last
    _assert_state_equal(jc.from_edge_list(24, 80, src, dst, w),
                        tc.from_edge_list(24, 80, src, dst, w, device=CPU))
    with pytest.raises(ValueError, match="edge capacity"):
        tc.from_edge_list(24, 10, src, dst, w, device=CPU)


@pytest.mark.parametrize("seed", range(4))
def test_apply_batch_streams_match(seed):
    """Batch by batch: the new state, every op's (ok, val), the overflow
    flag and the dirty set equal the reference's."""
    rng = np.random.default_rng(seed)
    n, B = 12, 16
    jstate = jc.make_graph(16, 64)
    tstate = tc.make_graph(16, 64, device=CPU)
    for step in range(8):
        ops = _random_ops(rng, n, B)
        jb = jc.make_batch(ops, B)
        tb = tc.make_batch(ops, B, device=CPU)
        jnew, jres, jover = jc.apply_batch(jstate, jb)
        tnew, tres, tover = tc.apply_batch(tstate, tb)
        ctx = (seed, step)
        assert bool(jover) == bool(tover), ctx
        _assert_results_equal(jres, tres, ctx)
        _assert_state_equal(jnew, tnew, ctx)
        assert np.array_equal(_np(jc.dirty_vertices(jstate, jnew)),
                              tc.dirty_vertices(tstate, tnew).numpy()), ctx
        if bool(jover):  # the reference's caller retries; keep the old state
            continue
        jstate, tstate = jnew, tnew


@pytest.mark.parametrize("seed", [5, 6])
def test_apply_ops_overflow_compacts_and_grows(seed):
    """A tiny edge table overflows: both packages compact, grow and retry
    into identical states and results."""
    rng = np.random.default_rng(seed)
    n = 10
    jstate = jc.make_graph(n, 8)
    tstate = tc.make_graph(n, 8, device=CPU)
    base = [(jc.PUTV, i) for i in range(n)]
    jstate, jres = jc.apply_ops(jstate, base)
    tstate, tres = tc.apply_ops(tstate, base)
    _assert_results_equal(jres, tres)
    for step in range(5):
        ops = [(jc.PUTE, int(rng.integers(0, n)), int(rng.integers(0, n)),
                float(rng.integers(1, 4))) for _ in range(10)]
        ops += [(jc.REME, int(rng.integers(0, n)), int(rng.integers(0, n)))
                for _ in range(4)]
        jstate, jres = jc.apply_ops(jstate, ops, batch_size=16)
        tstate, tres = tc.apply_ops(tstate, ops, batch_size=16)
        _assert_results_equal(jres, tres, step)
        _assert_state_equal(jstate, tstate, step)
    assert tstate.ecap > 8  # the table really grew


def test_compact_grow_densify_and_searchsorted_match():
    rng = np.random.default_rng(8)
    jstate = jc.make_graph(16, 48)
    ops = [(jc.PUTV, i) for i in range(14)]
    ops += [(jc.PUTE, int(rng.integers(0, 14)), int(rng.integers(0, 14)),
             float(rng.integers(1, 4))) for _ in range(30)]
    jstate, _ = jc.apply_ops(jstate, ops)
    jstate, _ = jc.apply_ops(jstate, [(jc.REMV, 3), (jc.REME, 0, 1),
                                      (jc.REME, 2, 5)])
    tstate = _to_torch(jstate)
    _assert_state_equal(jc.compact(jstate), tc.compact(tstate))
    _assert_state_equal(jc.grow_edges(jstate), tc.grow_edges(tstate))
    _assert_state_equal(jc.grow_vertices(jstate, 3),
                        tc.grow_vertices(tstate, 3))
    assert np.array_equal(_np(jc.densify(jstate)), tc.densify(tstate).numpy())
    assert np.array_equal(_np(jc.live_edge_mask(jstate)),
                          tc.live_edge_mask(tstate).numpy())
    qu = np.array([-3, 0, 2, 5, 13, 15, 2**31 - 1], np.int32)
    qv = np.array([4, 1, 5, 0, 13, -1, 2**31 - 1], np.int32)
    jidx = jgs.pair_searchsorted(jstate.esrc, jstate.edst, jnp.asarray(qu),
                                 jnp.asarray(qv))
    tidx = tgs.pair_searchsorted(tstate.esrc, tstate.edst,
                                 *map(torch.as_tensor, (qu, qv)))
    assert np.array_equal(_np(jidx), tidx.numpy())
    for u, v in zip(qu.tolist(), qv.tolist()):
        jl, jw = jc.get_e(jstate, u, v)
        tl, tw = tc.get_e(tstate, u, v)
        assert bool(jl) == bool(tl) and float(jw) == float(tw), (u, v)
        assert bool(jc.get_v(jstate, u)) == bool(tc.get_v(tstate, u)), u


def test_dirty_vertices_padded_across_vertex_growth():
    jstate = jc.make_graph(8, 32)
    jstate, _ = jc.apply_ops(jstate, [(jc.PUTV, i) for i in range(6)]
                             + [(jc.PUTE, 0, 1, 1.0)])
    jgrown = jc.grow_vertices(jstate)
    jnew, _ = jc.apply_ops(jgrown, [(jc.PUTV, 12), (jc.PUTE, 1, 12, 2.0)])
    tstate, tnew = _to_torch(jstate), _to_torch(jnew)
    assert np.array_equal(_np(jc.dirty_vertices_padded(jstate, jnew)),
                          tc.dirty_vertices_padded(tstate, tnew).numpy())
    with pytest.raises(ValueError, match="shrank"):
        tc.dirty_vertices_padded(tnew, tstate)
