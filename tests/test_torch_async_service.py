"""The port's async serving front end (``repro_torch.serve``).

The front-end tests of ``tests/test_serve.py`` for the port (lane
batching bit-identical to sequential collects on both rungs, the dispatch
fault falling back per request, deadlines, the admission contract,
commits overlapping pinned reads), then the concurrent differential of
``tests/stream_differential.py`` through the port -- every reply checked
at its own version against the oracle and bit-equal to a sequential port
collect -- clean and under a ``FaultPlan``, the dedup path of non-local
services, and the ``_icn_validated`` hook.  Every wait has a timeout.
"""
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import repro_torch.core as tc
from repro_torch.core import PUTE, PUTV
from repro_torch.core.queries import bc_dependencies, bfs, sssp
from repro_torch.engine import GraphService
from repro_torch.engine.incremental import results_equal
from repro_torch.obs import Telemetry
from repro_torch.resil import (
    FaultPlan,
    InjectedFault,
    P_SERVE_DISPATCH,
    ResiliencePolicy,
    assert_service_ok,
    fault_scope,
)
from repro_torch.serve import (
    AsyncGraphService,
    Lane,
    classify_local,
    dispatch_local_group,
    pad_pow2,
)
from repro_torch.serve.async_service import _Request

from oracle import GraphOracle
from stream_differential import WEIGHTS, _CHECK, _apply_oracle, gen_ops

VCAP, ECAP = 64, 256
WAIT = 120          # seconds any single future may take here
FRESH = {"bfs": bfs, "sssp": sssp, "bc": bc_dependencies}


def _seed_graph(rng, n=24, m=96):
    ops = [(PUTV, i) for i in range(n)]
    for _ in range(m):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        ops.append((PUTE, u, v, float(rng.integers(1, 9))))
    g, _ = tc.apply_ops(tc.make_graph(VCAP, ECAP, device="cpu"), ops)
    return g


def _path_graph(n=24):
    """0 -> 1 -> ... -> n-1: reachability from 0 is known exactly."""
    ops = [(PUTV, i) for i in range(n)]
    ops += [(PUTE, i, i + 1, 1.0) for i in range(n - 1)]
    g, _ = tc.apply_ops(tc.make_graph(VCAP, ECAP, device="cpu"), ops)
    return g


def _sizes(tel, **labels):
    return [s for h in tel.registry.find("serve_batch_size", **labels)
            for s in h.samples]


def _stopped(srv):
    srv.stop(timeout=WAIT)
    assert srv._thread is None


# ------------------------------ front end ---------------------------------

def test_pad_pow2():
    assert [pad_pow2(n) for n in (1, 2, 3, 4, 5, 8, 9, 17)] == \
        [1, 2, 4, 4, 8, 8, 16, 32]


def test_batched_full_dispatch_bit_identical():
    """A burst of same-kind queries at one version runs as ONE lane-batched
    dispatch whose per-lane answers are bit-equal to the sequential
    single-source collects."""
    g0 = _seed_graph(np.random.default_rng(8))
    tel = Telemetry(block=False)
    svc = GraphService(g0, batch_size=4, telemetry=tel)
    srv = AsyncGraphService(svc, max_batch=16).start()
    try:
        for kind in ("bfs", "sssp", "bc"):
            futs = [(s, srv.query_async(kind, s)) for s in range(6)]
            for s, f in futs:
                reply = f.result(timeout=WAIT)
                assert reply.version == 0 and reply.mode == "full"
                assert results_equal(reply.result, FRESH[kind](g0, s)), \
                    (kind, s)
    finally:
        _stopped(srv)
    assert srv.stats.batched_dispatches >= 1
    assert srv.stats.max_batch_seen >= 2
    assert max(_sizes(tel)) >= 2
    st = svc.stats
    assert st.unchanged + st.delta + st.full == st.queries == 18
    assert svc.ring.pinned_versions() == []


def test_batched_delta_rung_bit_identical():
    """Cached priors + a small committed churn: the dispatcher batches the
    delta lanes (one lane-batched delta call) and each lane equals the
    sequential full collect on the new snapshot."""
    g0 = _path_graph()
    tel = Telemetry(block=False)
    svc = GraphService(g0, batch_size=2, telemetry=tel)
    srcs = (0, 1, 2)
    srv = AsyncGraphService(svc, max_batch=16).start()
    try:
        for s in srcs:                       # warm priors at v0
            srv.query("bfs", s, timeout=WAIT)
        svc.submit_many([(PUTE, 5, 7, 1.0), (PUTE, 9, 11, 1.0)])
        svc.flush()
        g1 = svc.ring.latest.state
        futs = [(s, srv.query_async("bfs", s)) for s in srcs]
        replies = [(s, f.result(timeout=WAIT)) for s, f in futs]
    finally:
        _stopped(srv)
    for s, reply in replies:
        assert reply.version == 1
        assert reply.mode == "delta", (s, reply.mode)
        assert results_equal(reply.result, bfs(g1, s)), s
    delta_sizes = _sizes(tel, rung="delta")
    assert delta_sizes and max(delta_sizes) >= 2, \
        "delta lanes must share one dispatch"


def test_dispatch_fault_degrades_to_per_request_path():
    """An injected fault at ``serve.dispatch`` poisons the batch, not the
    requests: each falls back to the sequential resilient path and every
    answer is still exact."""
    g0 = _seed_graph(np.random.default_rng(9))
    svc = GraphService(g0, batch_size=4, policy=ResiliencePolicy())
    plan = FaultPlan({P_SERVE_DISPATCH: [0]})
    with fault_scope(plan):
        srv = AsyncGraphService(svc, max_batch=16).start()
        try:
            futs = [(s, srv.query_async("bfs", s)) for s in range(4)]
            for s, f in futs:
                reply = f.result(timeout=WAIT)
                assert not reply.degraded
                assert results_equal(reply.result, bfs(g0, s)), s
        finally:
            _stopped(srv)
    assert plan.fired == 1, "the dispatcher must see the activating " \
        "thread's fault plan (context propagation)"
    assert srv.stats.fallbacks >= 1
    st = svc.stats
    assert st.unchanged + st.delta + st.full == st.queries


def test_deadline_expiry_stale_serves_or_raises():
    g0 = _seed_graph(np.random.default_rng(10))
    svc = GraphService(g0, batch_size=4,
                       policy=ResiliencePolicy(deadline_ms=60_000))
    srv = AsyncGraphService(svc, max_batch=8).start()
    try:
        srv.query("bfs", 0, timeout=WAIT)    # cache a servable slot
        svc.policy = ResiliencePolicy(deadline_ms=0.0)   # expire at once
        reply = srv.query("bfs", 0, timeout=WAIT)
        assert reply.degraded and reply.mode == "degraded"
        assert svc.ring.get_entry(reply.version) is not None
        svc.policy = ResiliencePolicy(deadline_ms=0.0, allow_stale=False)
        with pytest.raises(TimeoutError):
            srv.query("bfs", 1, timeout=WAIT)
    finally:
        _stopped(srv)
    assert srv.stats.deadline_expired >= 2
    assert svc.stats.degraded == 1


def test_admission_contract():
    svc = GraphService(_seed_graph(np.random.default_rng(11)), batch_size=4)
    srv = AsyncGraphService(svc)
    with pytest.raises(RuntimeError):
        srv.query_async("bfs", 0)           # not started
    with pytest.raises(ValueError):
        AsyncGraphService(svc, max_batch=0)
    srv.start()
    try:
        with pytest.raises(RuntimeError):
            srv.start()                     # already started
        with pytest.raises(KeyError):
            srv.query_async("nope", 0)
        with pytest.raises(ValueError):
            srv.query_async("bfs", 0, mode="cn")   # cn needs the sync path
        with pytest.raises(ValueError):
            srv.query_async("bfs", None)
        # out-of-range source: served, flagged not-ok (same as sync path)
        assert not bool(srv.query("bfs", VCAP + 7, timeout=WAIT).result.ok)
        assert srv.query("bfs", 0, timeout=WAIT).version == 0
        assert srv._stream is None, "no CUDA stream for a CPU service"
    finally:
        _stopped(srv)
    # stopped cleanly: no pins leaked, a second start works
    assert svc.ring.pinned_versions() == []
    srv.start()
    try:
        assert srv.query("sssp", 1, timeout=WAIT).version == 0
    finally:
        _stopped(srv)
    assert svc.ring.pinned_versions() == []


def test_updates_overlap_pinned_reads():
    """Commits land while older-version queries are still pinned and in
    flight: the ring parks pinned versions instead of blocking the writer,
    and both sides finish."""
    g0 = _seed_graph(np.random.default_rng(12))
    svc = GraphService(g0, ring_depth=2, batch_size=2)
    states = {0: g0}
    srv = AsyncGraphService(svc, max_batch=4).start()
    try:
        futs = [(s, srv.query_async("bfs", s)) for s in range(4)]
        for _ in range(4):                   # rotate the window twice over
            srv.submit_many([(PUTE, 1, 2, 1.0), (PUTE, 3, 4, 1.0)])
            states[svc.version] = svc.ring.latest.state
        srv.flush()
        assert svc.version == 4
        for s, f in futs:
            reply = f.result(timeout=WAIT)
            assert reply.version in states
            assert results_equal(reply.result, bfs(states[reply.version], s))
    finally:
        _stopped(srv)
    assert svc.ring.pinned_versions() == []


# --------------------------- classification -------------------------------

def test_classify_newer_slot_runs_full():
    """A cached slot newer than the group's pinned version cannot serve it:
    the lane runs full (the reference raises on the reversed dirty span
    and falls the whole group back), and the front end's reply at the
    older version leaves the newer slot in the cache."""
    g0 = _seed_graph(np.random.default_rng(13))
    svc = GraphService(g0, batch_size=2)
    pin = svc.ring.pin()                             # admitted at v0
    svc.submit_many([(PUTE, 1, 2, 1.0), (PUTE, 3, 4, 1.0)])
    svc.flush()
    assert svc.query("bfs", 0).version == 1          # slot at v1
    slot = svc._cache[("bfs", 0)]
    lane = classify_local(svc, "bfs", 0, 0, g0)
    assert lane.mode == "full"
    results, sizes = dispatch_local_group(svc, "bfs", g0, [lane])
    assert sizes == {"full": 1}
    assert results_equal(results[0], bfs(g0, 0))

    srv = AsyncGraphService(svc)
    req = _Request("bfs", 0, 0, pin, Future(), time.perf_counter(), None)
    with srv._inflight_lock:
        srv._inflight += 1
    srv._dispatch_local("bfs", 0, svc.ring.get_entry(0), [req])
    reply = req.future.result(timeout=WAIT)
    assert reply.version == 0 and reply.mode == "full"
    assert results_equal(reply.result, bfs(g0, 0))
    assert svc._cache[("bfs", 0)] is slot            # the newer slot stays
    assert svc.ring.pinned_versions() == []


def test_direct_queries_race_the_front_end():
    """A client thread calls ``service.query`` on the keys the front end
    serves while commits land: every reply of either path equals a fresh
    query at the version it names, and the cache ends at the latest
    version."""
    g0 = _seed_graph(np.random.default_rng(18))
    svc = GraphService(g0, ring_depth=8, batch_size=4)
    states = {0: g0}
    keys = [(k, s) for k in FRESH for s in (0, 3, 7)]
    replies, errs = [], []

    def direct():
        try:
            for _ in range(4):
                for k, s in keys:
                    replies.append((k, s, svc.query(k, s)))
        except Exception as e:  # pragma: no cover - harness guard
            errs.append(e)

    rng = np.random.default_rng(19)
    srv = AsyncGraphService(svc, max_batch=8).start()
    try:
        futs = []
        for step in range(4):
            t = threading.Thread(target=direct)
            t.start()
            futs += [(k, s, srv.query_async(k, s)) for k, s in keys]
            svc.submit_many([(PUTE, int(rng.integers(0, 24)),
                              int(rng.integers(0, 24)), 1.0)
                             for _ in range(4)])
            states[svc.version] = svc.ring.latest.state
            t.join(timeout=WAIT)
            assert not t.is_alive(), "direct client hung"
        replies += [(k, s, f.result(timeout=WAIT)) for k, s, f in futs]
    finally:
        _stopped(srv)
    assert not errs, errs
    for k, s, reply in replies:
        exp = FRESH[k](states[reply.version], s)
        assert results_equal(reply.result, exp), \
            (k, s, reply.version, reply.mode)
    for k, s in keys:
        svc.query(k, s)
        assert svc._cache[(k, s)].version == svc.version
    assert svc.ring.pinned_versions() == []


def test_dispatch_reruns_negative_cycle_delta_lane_full():
    """A delta SSSP lane that meets a negative cycle born since its prior
    is reclassified and answered by the full rung (the canonical
    partially-relaxed distances), padding lanes dropped."""
    g0 = _seed_graph(np.random.default_rng(14))
    g0, _ = tc.apply_ops(g0, [(PUTE, 0, 30, 1.0), (PUTE, 30, 31, 1.0),
                              (PUTE, 31, 30, 1.0), (PUTV, 30), (PUTV, 31)])
    svc = GraphService(g0, batch_size=1)
    for s in (0, 1, 2):
        assert svc.query("sssp", s).mode == "full"
    svc.submit(((PUTE, 30, 31, -3.0)))
    g1 = svc.ring.latest.state
    lanes = [classify_local(svc, "sssp", s, 1, g1) for s in (0, 1, 2)]
    for i, ln in enumerate(lanes):
        ln.index = i
    assert [ln.mode for ln in lanes] == ["delta"] * 3
    results, sizes = dispatch_local_group(svc, "sssp", g1, lanes)
    assert sizes["delta"] == 3 and sizes["full"] >= 1
    assert lanes[0].mode == "full" and bool(results[0].negcycle)
    for s, res in zip((0, 1, 2), results):
        assert results_equal(res, sssp(g1, s)), s


@pytest.mark.parametrize("kind", ["bfs", "sssp", "bc"])
def test_padded_group_matches_sequential(kind):
    """Three full lanes pad to four (lane 0 repeated, dropped)."""
    g0 = _seed_graph(np.random.default_rng(15))
    svc = GraphService(g0, batch_size=4)
    lanes = [Lane(i, s, "full") for i, s in enumerate((3, VCAP + 1, 0))]
    results, sizes = dispatch_local_group(svc, kind, g0, lanes)
    assert sizes == {"full": 3} and len(results) == 3
    for ln, res in zip(lanes, results):
        assert results_equal(res, FRESH[kind](g0, ln.src)), ln.src


# ------------------------------ hooks / dedup ------------------------------

class _ValidatedService(GraphService):
    def _icn_validated(self, result) -> bool:
        return bool(result.ok)


def test_icn_validated_comes_from_the_hook():
    g0 = _seed_graph(np.random.default_rng(16))
    assert not GraphService(g0).query("bfs", 0).validated
    svc = _ValidatedService(g0)
    assert svc.query("bfs", 0).validated
    assert not svc.query("bfs", VCAP + 3).validated
    assert not svc.query("bfs", 0, mode="icn").scan.validated


def test_dedup_path_shares_one_collect_per_key():
    """A non-local service batches by dedup: identical keys at the latest
    version share one collect whose reply carries the hook's validated
    flag; a group pinned behind the latest version falls back."""
    g0 = _seed_graph(np.random.default_rng(17))
    tel = Telemetry(block=False)
    svc = _ValidatedService(g0, batch_size=2, telemetry=tel)
    srv = AsyncGraphService(svc, max_batch=16)
    srv._local = False
    srv.start()
    try:
        futs = [(s, srv.query_async("bfs", s)) for s in (0, 0, 0, 3, 3)]
        for s, f in futs:
            reply = f.result(timeout=WAIT)
            assert reply.version == 0 and reply.validated
            assert results_equal(reply.result, bfs(g0, s)), s
        # a request admitted at v0, enqueued once v1 has committed
        pin = svc.ring.pin()
        svc.submit_many([(PUTE, 1, 2, 1.0), (PUTE, 3, 4, 1.0)])
        req = _Request("bfs", 0, pin.version, pin, Future(),
                       time.perf_counter(), None)
        with srv._inflight_lock:
            srv._inflight += 1
        srv._queue.put(req)
        reply = req.future.result(timeout=WAIT)
        assert reply.version == 1
        assert results_equal(reply.result, bfs(svc.ring.latest.state, 0))
    finally:
        _stopped(srv)
    assert sorted(_sizes(tel, rung="dedup")) == [2, 3]
    assert srv.stats.fallbacks == 1
    assert svc.ring.pinned_versions() == []
    st = svc.stats
    assert st.unchanged + st.delta + st.full == st.queries


# ------------------------ concurrent differential --------------------------

def _run_concurrent(seed, *, n=24, chunks=10, ops_per_chunk=4, clients=3,
                    queries_per_client=12, fault_plan=None, policy=None,
                    max_batch=16):
    """``run_concurrent_differential`` through the port: clients and an
    updater race through one ``AsyncGraphService``; afterwards each reply
    is checked at its own version against the oracle and bit-equal to a
    sequential port collect on the state rebuilt from the chunk prefix."""
    rng = np.random.default_rng(seed)
    half = n // 2
    base = [(PUTV, i) for i in range(n)]
    for lo, hi in ((0, half), (half, n)):
        for _ in range(3 * half):
            base.append((PUTE, int(rng.integers(lo, hi)),
                         int(rng.integers(lo, hi)),
                         float(WEIGHTS[int(rng.integers(0, len(WEIGHTS)))])))
    g0, _ = tc.apply_ops(tc.make_graph(n, 16 * n, device="cpu"), base)
    oracle = GraphOracle()
    _apply_oracle(oracle, base)
    chunk_list = [gen_ops(rng, *((half, n) if c % 2 else (0, half)),
                          ops_per_chunk) for c in range(chunks)]
    pinned = [0, 1]
    schedules = []
    for _ in range(clients):
        sched = []
        for _ in range(queries_per_client):
            kind = ("bfs", "sssp", "bc")[int(rng.integers(0, 3))]
            src = (pinned[int(rng.integers(0, len(pinned)))]
                   if float(rng.random()) < 0.7 else int(rng.integers(0, n)))
            sched.append((kind, src))
        schedules.append(sched)

    if fault_plan is not None and policy is None:
        policy = ResiliencePolicy(max_retries=2)
    tel = Telemetry(block=False)
    svc = GraphService(g0, batch_size=ops_per_chunk, telemetry=tel,
                       policy=policy)
    results = [[] for _ in range(clients)]
    errs = []

    def updater(srv):
        try:
            for chunk in chunk_list:
                for op in chunk:
                    try:
                        srv.submit(op)
                    except InjectedFault:
                        pass   # the op is logged; a later commit drains it
            for _ in range(256):
                try:
                    srv.flush()
                    return
                except InjectedFault:
                    continue
            errs.append(AssertionError("flush never succeeded"))
        except Exception as e:  # pragma: no cover - harness guard
            errs.append(e)

    def querier(srv, idx):
        try:
            for kind, src in schedules[idx]:
                results[idx].append((kind, src, srv.query_async(kind, src)))
        except Exception as e:  # pragma: no cover - harness guard
            errs.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        with fault_scope(fault_plan):
            srv = AsyncGraphService(svc, max_batch=max_batch).start()
            try:
                warm = [(k, s, srv.query_async(k, s))
                        for k in ("bfs", "sssp", "bc") for s in pinned]
                for _, _, f in warm:
                    try:
                        f.result(timeout=WAIT)
                    except Exception:
                        assert fault_plan is not None, (seed, "warm raised")
                threads = [threading.Thread(target=updater, args=(srv,))]
                threads += [threading.Thread(target=querier, args=(srv, i))
                            for i in range(clients)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=WAIT)
                    assert not t.is_alive(), (seed, "thread hung")
                assert not errs, (seed, errs)
                assert srv.drain(timeout=WAIT), (seed, "drain timed out")
            finally:
                srv.stop(timeout=WAIT)
    finally:
        sys.setswitchinterval(switch)
    assert svc.version == chunks, (seed, svc.version, chunks)
    assert svc.ring.pinned_versions() == []

    modes = {"unchanged": 0, "delta": 0, "full": 0, "degraded": 0,
             "raised": 0}
    by_version = {}
    for kind, src, fut in warm + [r for res in results for r in res]:
        try:
            reply = fut.result(timeout=WAIT)
        except Exception as e:
            assert fault_plan is not None, (seed, kind, src, e)
            modes["raised"] += 1
            continue
        if reply.degraded:
            modes["degraded"] += 1
            assert reply.stale_version == reply.version, (seed, reply)
        else:
            modes[reply.mode] += 1
        assert 0 <= reply.version <= chunks, (seed, reply.version)
        by_version.setdefault(reply.version, []).append((kind, src, reply))

    state = g0
    for v in range(chunks + 1):
        if v > 0:
            chunk = chunk_list[v - 1]
            _apply_oracle(oracle, chunk)
            state, _ = tc.apply_ops(state, chunk, batch_size=ops_per_chunk)
        for kind, src, reply in by_version.get(v, ()):
            ctx = (seed, kind, src, v,
                   "degraded" if reply.degraded else reply.mode)
            _CHECK[kind](ctx, reply, oracle, src, n, False)
            assert results_equal(reply.result, FRESH[kind](state, src)), \
                (ctx, "batched reply not bit-equal to sequential collect")
    assert_service_ok(svc)

    st = svc.stats
    assert st.unchanged + st.delta + st.full == st.queries, (seed, st)
    recs = [r for r in tel.tracer.records if r["span"] == "query"]
    clean = [r for r in recs if "error" not in r and not r.get("degraded")]
    deg = [r for r in recs if r.get("degraded")]
    assert len(clean) == st.queries, (seed, len(clean), st.queries)
    assert len(deg) == st.degraded == modes["degraded"], (seed, st.degraded)
    if fault_plan is None:
        assert modes["raised"] == 0 and st.errors == 0, (seed, modes)
    tel.close()
    return modes, srv.stats


def test_concurrent_differential():
    modes, serve = _run_concurrent(11)
    assert modes["raised"] == 0 and modes["degraded"] == 0, modes
    assert modes["full"] > 0 and modes["unchanged"] > 0, modes
    assert serve.batched_dispatches > 0, serve
    assert serve.deadline_expired == 0, serve


def test_concurrent_differential_chaos():
    plan = FaultPlan(seed=13, rate=0.25)
    modes, serve = _run_concurrent(
        12, fault_plan=plan, policy=ResiliencePolicy(max_retries=1))
    assert plan.fired > 0
    assert modes["full"] > 0, modes
    assert serve.admitted > 0 and serve.fallbacks > 0, serve
