"""Port parity: one seeded op/query stream replayed through both
``GraphService``s, in the manner of ``tests/stream_differential.py``.

Every reply must carry the same version, ladder mode and results (BC
``delta`` to ``1e-5``), ``bc_scores`` cold and delta must agree, the ladder
tallies must be equal, and every port answer must match the sequential
oracle (``tests/oracle.py``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as jc
from repro.engine import GraphService as JService
from repro.engine.version_ring import VersionRing as JRing
import repro_torch.core as tc
from repro_torch.engine import GraphService as TService
from repro_torch.engine.version_ring import VersionRing as TRing

from oracle import GraphOracle
from stream_differential import (
    WEIGHTS, _apply_oracle, check_bc, check_bfs, check_scores, check_sssp,
    gen_ops)

CHECK = {"bfs": check_bfs, "sssp": check_sssp, "bc": check_bc}
TOL = dict(rtol=1e-5, atol=1e-5)


def _assert_result(jres, tres, ctx):
    for name, a, b in zip(type(jres)._fields, jres, tres):
        a, b = np.asarray(a), b.numpy()
        if name == "delta":
            np.testing.assert_allclose(b, a, err_msg=str(ctx), **TOL)
        else:
            assert np.array_equal(a, b), (ctx, name)


@pytest.mark.parametrize("seed,neg_frac", [(0, 0.0), (1, 0.2)])
def test_stream_replay_matches_reference_and_oracle(seed, neg_frac):
    n, steps = 24, 8
    rng = np.random.default_rng(seed)
    jsvc = JService(jc.make_graph(n, 16 * n), batch_size=4)
    tsvc = TService(tc.make_graph(n, 16 * n, device="cpu"), batch_size=4)
    oracle = GraphOracle()

    def commit(ops):
        _apply_oracle(oracle, ops)
        for svc in (jsvc, tsvc):
            svc.submit_many(ops)
            svc.flush()
        assert jsvc.version == tsvc.version

    half = n // 2
    base = [(jc.PUTV, i) for i in range(n)]
    for lo, hi in ((0, half), (half, n)):
        base += [(jc.PUTE, int(rng.integers(lo, hi)), int(rng.integers(lo, hi)),
                  float(WEIGHTS[int(rng.integers(0, len(WEIGHTS)))]))
                 for _ in range(3 * half)]
    commit(base)
    for step in range(steps):
        lo, hi = (half, n) if step % 2 else (0, half)
        commit(gen_ops(rng, lo, hi, 8, neg_frac))
        for src in (0, 1, int(rng.integers(0, n))):
            for kind in ("bfs", "sssp", "bc"):
                mode = "cn" if (step + src) % 3 == 0 else "icn"
                jr = jsvc.query(kind, src, mode=mode)
                tr = tsvc.query(kind, src, mode=mode)
                ctx = (seed, step, kind, src, mode)
                assert (tr.version, tr.mode, tr.validated) == (
                    jr.version, jr.mode, jr.validated), ctx
                _assert_result(jr.result, tr.result, ctx)
                CHECK[kind]((*ctx, tr.mode), tr, oracle, src, n, False)
        if step % 3 == 2:
            jscores, jv = jsvc.bc_scores()
            tscores, tv = tsvc.bc_scores()
            assert jv == tv
            np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                                       equal_nan=True, **TOL)
            check_scores((seed, step), tscores, oracle, n)
    for field in ("queries", "unchanged", "delta", "full", "collects",
                  "cn_retries", "errors"):
        assert getattr(tsvc.stats, field) == getattr(jsvc.stats, field), field
    assert tsvc.stats.unchanged and tsvc.stats.delta and tsvc.stats.full
    for mode in ("unchanged", "delta", "full"):
        assert tsvc.bc_scores_stats[mode] == jsvc.bc_scores_stats[mode], mode
    for field in ("ops_submitted", "ops_committed", "batches_committed"):
        assert (getattr(tsvc.scheduler.stats, field)
                == getattr(jsvc.scheduler.stats, field)), field


def test_bc_scores_delta_and_unchanged_match_reference():
    """Localized churn drives bc_scores through delta and unchanged; the
    warm trees equal a cold sweep's and the scores equal the reference's."""
    from repro.data import load_rmat_graph
    g = load_rmat_graph(64, 400, seed=1, weighted=False)
    jsvc = JService(g, batch_size=8)
    tsvc = TService(tc.state_from_numpy(*map(np.asarray, g), device="cpu"),
                    batch_size=8)
    ops_seq = [[(jc.PUTE, 62, 63, 1.0), (jc.REME, 62, 61)],
               [(jc.PUTE, 60, 2, 1.0)], [(jc.PUTV, 63)]]
    for ops in [[]] + ops_seq:
        for svc in (jsvc, tsvc):
            svc.submit_many(ops)
            svc.flush()
        jscores, _ = jsvc.bc_scores(src_chunk=24)
        tscores, _ = tsvc.bc_scores(src_chunk=24)
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                                   equal_nan=True, **TOL)
        assert tsvc.bc_scores_stats == dict(jsvc.bc_scores_stats.items())
        slot = tsvc._bc_scores
        state = tsvc.ring.latest.state
        am, _, alive = tc.dense_views(state)
        _, sigma, level, ok = tc.bc_batched_dense(
            am, torch.arange(64, dtype=torch.int32), alive)
        assert torch.equal(slot["level"], level)
        assert torch.equal(slot["sigma"], sigma)
        assert torch.equal(slot["ok"], ok)
    assert tsvc.bc_scores_stats["delta"] >= 1


@pytest.mark.parametrize("strict,coalesce", [(True, False), (False, True)])
def test_scheduler_options_match_reference(strict, coalesce):
    rng = np.random.default_rng(3)
    ops = gen_ops(rng, 0, 12, 40) + [(jc.PUTE, 1, 2, 1.0), (jc.PUTE, 1, 2, 2.0),
                                     (jc.REME, 1, 2), (jc.PUTV, 3)]
    base = [(jc.PUTV, i) for i in range(12)]
    jsvc = JService(jc.make_graph(16, 64), batch_size=6, strict_order=strict,
                    coalesce=coalesce)
    tsvc = TService(tc.make_graph(16, 64, device="cpu"), batch_size=6,
                    strict_order=strict, coalesce=coalesce)
    for svc in (jsvc, tsvc):
        svc.submit_many(base + ops)
        svc.flush()
    assert jsvc.version == tsvc.version
    for a, b in zip(jsvc.ring.latest.state,
                    tc.state_to_numpy(tsvc.ring.latest.state)):
        assert np.array_equal(np.asarray(a), b)
    for field in ("ops_submitted", "ops_committed", "ops_coalesced",
                  "batches_committed", "strict_cuts"):
        assert (getattr(tsvc.scheduler.stats, field)
                == getattr(jsvc.scheduler.stats, field)), field


def test_version_ring_pins_and_dirty_spans_match_reference():
    jring = JRing(jc.make_graph(8, 32), depth=3)
    tring = TRing(tc.make_graph(8, 32, device="cpu"), depth=3)
    jstate = jring.latest.state
    pins = []
    for step in range(6):
        jstate, _ = jc.apply_ops(jstate, [(jc.PUTV, step), (jc.PUTV, step + 1),
                                          (jc.PUTE, step, step + 1, 1.0)])
        jring.commit(jstate)
        tring.commit(tc.state_from_numpy(*map(np.asarray, jstate),
                                         device="cpu"))
        if step == 1:
            pins = [jring.pin(), tring.pin()]
    assert tring.oldest_version == jring.oldest_version
    assert tring.get(2) is not None and jring.get(2) is not None  # parked
    for a, b in ((0, 6), (3, 6), (4, 6), (6, 6), (2, 2)):
        jd, td = jring.dirty_between(a, b), tring.dirty_between(a, b)
        assert (jd is None) == (td is None), (a, b)
        if jd is not None:
            assert np.array_equal(np.asarray(jd), td.numpy()), (a, b)
    for p in pins:
        p.release()
        p.release()  # idempotent
    assert tring.get(2) is None and tring.evictions == jring.evictions
    assert tring.try_pin(1) is None
    with pytest.raises(KeyError):
        tring.pin(0)
    with pytest.raises(ValueError, match="reversed"):
        tring.dirty_between(5, 4)
