"""Port parity: the PANIGRAHAM snapshot protocol (collects, CMPTREE,
PG-Cn / PG-Icn) of ``repro_torch`` against ``repro``.

Each case of ``tests/test_snapshot.py`` runs in both packages on the same
graphs and the same interrupting updates; the port must give the same
``ScanStats`` and the same collected arrays (BC's payload, which holds
the dependency ``delta``, to f32 summation order)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jc
import repro.core.snapshot as js
import repro_torch.core as tc
import repro_torch.core.snapshot as ts

from test_snapshot import _oracle_at, base_graph
from test_torch_queries import _to_torch

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)


def _same_collect(jcoll, tcoll, query):
    for name in ("reached", "parent", "ecnt", "payload"):
        a = np.asarray(getattr(jcoll, name))
        b = getattr(tcoll, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "payload" and query == "bc":
            np.testing.assert_allclose(b, a, err_msg=name, **TOL)
        else:
            assert np.array_equal(a, b), name


def _same_stats(js_, ts_):
    assert (js_.collects, js_.interrupting_updates, js_.validated) == (
        ts_.collects, ts_.interrupting_updates, ts_.validated)


def _refs(g, batches_j=None, batches_t=None):
    """A reference and a port StateRef over the same graph, each committing
    its own copy of the same batches, one per read."""
    jref, tref = js.StateRef(g), ts.StateRef(_to_torch(g))
    for ref, batches, apply in ((jref, batches_j, jc.apply_ops),
                                (tref, batches_t, tc.apply_ops)):
        if batches is None:
            continue
        it = iter(batches)

        def interrupt(r, it=it, apply=apply):
            ops = next(it, None)
            if ops:
                ns, _ = apply(r.state, ops)
                r.commit(ns)

        ref.on_read.append(interrupt)
    return jref, tref


@pytest.mark.parametrize("query", ["bfs", "sssp", "bc"])
def test_stable_state_validates_in_two_collects(query):
    jref, tref = _refs(base_graph())
    jres, jst = js.op_linearizable(jref, query, 0)
    tres, tst = ts.op_linearizable(tref, query, 0)
    _same_stats(jst, tst)
    assert tst.collects == 2 and tst.validated
    _same_collect(jres, tres, query)


def test_dead_source_returns_null():
    g, _ = jc.apply_ops(base_graph(), [(jc.REMV, 0)])
    jref, tref = _refs(g)
    (jres, jst), (tres, tst) = (js.op_linearizable(jref, "bfs", 0),
                                ts.op_linearizable(tref, "bfs", 0))
    assert jres is None and tres is None
    _same_stats(jst, tst)
    (jres, jst), (tres, tst) = (js.op_inconsistent(jref, "sssp", 0),
                                ts.op_inconsistent(tref, "sssp", 0))
    assert jres is None and tres is None
    _same_stats(jst, tst)


@pytest.mark.parametrize("ops,same", [
    ([[(jc.PUTE, 0, 3, 1.0)]], False),                  # new path into region
    ([[(jc.REME, 0, 1)], [(jc.PUTE, 0, 1, 1.0)]], False),  # remove, re-add
    ([[(jc.PUTE, 5, 4, 1.0)]], True),                   # outside the region
])
def test_cmp_tree_decisions_match(ops, same):
    g = base_graph()
    t = _to_torch(g)
    c1j, c1t = js.collect_bfs(g, 0), ts.collect_bfs(t, 0)
    _same_collect(c1j, c1t, "bfs")
    g2, t2 = g, t
    for batch in ops:
        g2, _ = jc.apply_ops(g2, batch)
        t2, _ = tc.apply_ops(t2, batch)
    c2j, c2t = js.collect_bfs(g2, 0), ts.collect_bfs(t2, 0)
    _same_collect(c2j, c2t, "bfs")
    assert bool(js.cmp_tree(c1j, c2j)) == ts.cmp_tree(c1t, c2t) == same
    if len(ops) == 2:  # the ABA case: same region, ecnt tells them apart
        assert torch.equal(c1t.reached, c2t.reached)


@pytest.mark.parametrize("query", ["bfs", "sssp", "bc"])
def test_retry_until_quiescent(query):
    batches = [[(jc.PUTE, 0, 1, w)] for w in (2.0, 3.0, 4.0)]
    jref, tref = _refs(base_graph(), batches, batches)
    jres, jst = js.op_linearizable(jref, query, 0)
    tres, tst = ts.op_linearizable(tref, query, 0)
    _same_stats(jst, tst)
    assert tst.validated and tst.collects >= 2
    assert tst.interrupting_updates >= 3
    _same_collect(jres, tres, query)


@pytest.mark.parametrize("query", ["bfs", "sssp", "bc"])
def test_pg_icn_never_retries(query):
    batches = [[(jc.PUTE, 0, 1, 9.0)]] * 4
    jref, tref = _refs(base_graph(), batches, batches)
    jres, jst = js.op_inconsistent(jref, query, 0)
    tres, tst = ts.op_inconsistent(tref, query, 0)
    _same_stats(jst, tst)
    assert tst.collects == 1 and not tst.validated
    _same_collect(jres, tres, query)


def test_linearizability_of_concurrent_queries():
    """The reference's system test, run in both packages on one op stream:
    equal stats and distances, and every port result equals the oracle at
    some version inside its window."""
    rng = np.random.default_rng(0)
    n = 12
    g = jc.make_graph(16, 256)
    init = [(jc.PUTV, i) for i in range(n)] + \
        [(jc.PUTE, int(u), int(v), float(rng.integers(1, 5)))
         for u, v in rng.integers(0, n, (30, 2)) if u != v]
    g, _ = jc.apply_ops(g, init)
    batches = []
    for _ in range(12):
        ops = []
        for _ in range(3):
            kind = rng.choice([jc.PUTE, jc.REME, jc.PUTV, jc.REMV],
                              p=[0.5, 0.3, 0.1, 0.1])
            u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
            if kind == jc.PUTE and u != v:
                ops.append((jc.PUTE, u, v, float(rng.integers(1, 5))))
            elif kind == jc.REME and u != v:
                ops.append((jc.REME, u, v))
            elif kind == jc.PUTV:
                ops.append((jc.PUTV, u))
            elif kind == jc.REMV and u != 0:
                ops.append((jc.REMV, u))
        batches.append(ops)
    history = [init]
    jref, tref = _refs(g, batches, None)
    it = iter(batches)

    def interrupt(r):
        ops = next(it, None)
        if ops:
            ns, _ = tc.apply_ops(r.state, ops)
            r.commit(ns)
            history.append(ops)

    tref.on_read.append(interrupt)
    for _ in range(6):
        start = len(history)
        jres, jst = js.op_linearizable(jref, "bfs", 0, max_collects=128)
        tres, tst = ts.op_linearizable(tref, "bfs", 0, max_collects=128)
        _same_stats(jst, tst)
        assert tst.validated
        if tres is None:
            assert jres is None
            continue
        _same_collect(jres, tres, "bfs")
        dist = tres.result.dist.numpy()
        got = {v: int(dist[v]) for v in range(n) if dist[v] >= 0}
        window = _oracle_at(history)[start - 1:len(history)]
        assert any(o.bfs(0) == got for o in window if o.bfs(0) is not None)


def test_pgcn_retry_loop_matches_reference():
    """``op_linearizable_jit``: the reference's on-device retry loop and the
    port's host loop commit the same batches, use the same number of
    collects and end on the same state and collect."""
    from repro.core.updates import make_batch as jmake

    g = base_graph()
    ops = [[(jc.PUTE, 0, 5, 1.0)], [(jc.REME, 0, 5)], []]
    jb = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[jmake(o, size=4) for o in ops])
    tb = tc.OpBatch(*(torch.stack(xs) for xs in zip(
        *[tc.make_batch(o, size=4, device=CPU) for o in ops])))
    fn = jax.jit(js.op_linearizable_jit, static_argnames=("max_collects",))
    jst, jcoll, jn, jok = fn(g, jb, jnp.int32(0))
    tst, tcoll, tn, tok = ts.op_linearizable_jit(_to_torch(g), tb, 0)
    assert (int(jn), bool(jok)) == (tn, tok)
    assert tok and tn >= 3  # two interrupting batches forced retries
    _same_collect(jcoll, tcoll, "bfs")
    for a, b in zip(jst, tst):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert torch.equal(tcoll.result.dist, tc.bfs(tst, 0).dist)
    # max_collects caps an endless stream, which then ends unvalidated
    alternating = tc.OpBatch(*(torch.stack([x[i % 2] for i in range(8)])
                               for x in tb))
    _, _, n, ok = ts.op_linearizable_jit(_to_torch(g), alternating, 0,
                                         max_collects=4)
    assert (n, ok) == (4, False)


def test_collect_sssp_payload_flags_negative_cycles():
    g, _ = jc.apply_ops(base_graph(), [(jc.PUTE, 3, 2, -5.0)])
    jcoll, tcoll = js.collect_sssp(g, 0), ts.collect_sssp(_to_torch(g), 0)
    _same_collect(jcoll, tcoll, "sssp")
    assert bool(tcoll.result.negcycle)
