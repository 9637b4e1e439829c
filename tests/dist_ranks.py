"""Rank bodies for ``tests/test_torch_dist.py``.

Each function here runs once in every process of
``repro_torch.shard.spawn`` (four gloo ranks on the CPU) as ``fn(mesh,
*args)``; spawn pickles them by name, so they live at module level, in a
module that imports neither JAX nor the reference package (the processes
start from a fresh interpreter and import only what the body needs).
Each returns plain values and CPU tensors, compared in the test process.
"""
import os
import signal
import time

import numpy as np
import torch

import repro_torch.core as tc
import repro_torch.shard as ts
from repro_torch.core import PUTE, PUTV, REME, REMV
from repro_torch.core import queries as tq
from repro_torch.engine import GraphService
from repro_torch.obs import AdaptiveThresholds, Telemetry
from repro_torch.resil import (
    CircuitBreaker,
    FaultPlan,
    InjectedFault,
    OpJournal,
    ResiliencePolicy,
    assert_service_ok,
    fault_scope,
    journal_meta,
    recover,
)
from repro_torch.resil.faults import P_COLLECT_DELTA
from repro_torch.shard.queries import _launch, _program

TILE = 16
TOL = dict(rtol=1e-5, atol=1e-5)
WEIGHTS = (1.0, 2.0, 3.0)
KINDS = ("bfs", "sssp", "bc")


def _np(res) -> dict:
    return {f: x.cpu().numpy() for f, x in zip(type(res)._fields, res)}


# ------------------------------- the group --------------------------------

def group_ops(mesh, xs, perm):
    """Every collective of ``DistGroup`` on rank-dependent inputs
    (``xs[rank]``), with its counts."""
    g = ts.DistGroup(mesh)
    r = mesh.rank
    x = xs[r]
    out = {
        "psum": g.psum(x), "pmax": g.pmax(x),
        "psum_host": g.psum(float(x[0])), "pmax_host": g.pmax(int(r)),
        "flag": g.pmax(r == 2),
        "tiled": g.all_gather(x), "stacked": g.all_gather(x, tiled=False),
        "permute": g.ppermute((x, x.to(torch.int32)), perm),
        "merge": g.merge(x[:2]),
        "control": mesh.broadcast(["rank", r]),
        # three frames: the first 60 bytes, 64 KiB, the rest
        "long": mesh.broadcast({"rank": r, "n": list(range(20000))}),
    }
    mesh.barrier()
    out.update(bytes=dict(g.bytes), calls=dict(g.calls), moved=dict(g.moved),
               devices=[str(d) for d in mesh.devices], size=mesh.size,
               rank=g.axis_index())
    return out


def front_end_on_mesh(mesh, arrays):
    """``AsyncGraphService`` over a ``DistMesh`` is built: rank 0 starts
    and stops its dispatcher, the others follow until its stop command
    and refuse to admit; ``make_graph_mesh`` passes the mesh through;
    only rank 0 serves ``/metrics`` and may journal."""
    from repro_torch.launch.mesh import make_graph_mesh
    from repro_torch.serve import AsyncGraphService

    state = tc.state_from_numpy(*arrays, device="cpu")
    out = {"same_mesh": make_graph_mesh(mesh) is mesh}
    tel = Telemetry(block=False)
    svc = ts.ShardedGraphService(state, mesh, tile=TILE, telemetry=tel)
    srv = AsyncGraphService(svc)
    if mesh.rank:
        try:
            srv.query_async("bfs", [0])
            out["front_end"] = "admitted on a follower"
        except RuntimeError as e:
            out["refused"] = str(e)
            out["front_end"] = f"built, followed {srv.follow()} command(s)"
    else:
        srv.start()
        srv.stop(timeout=30)
        out["front_end"] = "built"
    server = svc.serve_metrics(port=0)
    out["metrics"] = server is not None
    if server is not None:
        server.close()
    if mesh.rank:
        try:
            ts.ShardedGraphService(state, mesh, tile=TILE,
                                   journal=object())
            out["journal"] = "accepted"
        except ValueError as e:
            out["journal"] = str(e)
    tel.close()
    mesh.barrier()
    return out


def failing_rank(mesh, how):
    """Rank 2 raises, kills its own process or falls out of step (an
    all-gather of the operand size the others reduce) after a first
    collective; the others go on to the next collectives and must fail,
    not hang or combine unrelated payloads."""
    g = ts.DistGroup(mesh)
    g.psum(torch.ones(4))
    if mesh.rank == 2:
        if how == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if how == "out_of_step":
            g.all_gather(torch.ones(4))
        raise RuntimeError("rank 2 fails on purpose")
    t0 = time.monotonic()
    try:
        for _ in range(100):
            g.pmax(torch.ones(4))
    finally:
        print(f"rank {mesh.rank} failed after "
              f"{time.monotonic() - t0:.2f} s", flush=True)
    return "no failure"


def failing_body(mesh, arrays):
    """A per-rank body raises on rank 1 inside a distributed query: every
    rank fails."""
    from repro_torch.shard import queries as sq

    state = tc.state_from_numpy(*arrays, device="cpu")
    view = ts.build_sharded_view(state, mesh, tile=TILE)
    real = sq._BODIES["bfs"]

    def body(g, *a, **kw):
        if g.axis_index() == 1:
            raise ValueError("rank 1's body fails on purpose")
        return real(g, *a, **kw)

    sq._BODIES["bfs"] = body
    sq._program.cache_clear()
    ts.bfs(view, state, [0, 1])
    return "no failure"


# --------------------------- views and queries ----------------------------

def query_set(mesh, state, srcs, ops) -> dict:
    """On any mesh: the occupancy stats and the gathered view, cold BFS/SSSP
    and BC in both modes, each kind's collective counts on eight sources,
    then ``ops`` committed, the refreshed view and the delta queries."""
    srcs = np.asarray(srcs, np.int32)
    view = ts.build_sharded_view(state, mesh, tile=TILE)
    out = {"stats": ts.sharded_occupancy_stats(view)}
    gv = ts.gather_view(view)
    out["gathered"] = (gv.w.cpu().numpy(), gv.occ.cpu().numpy())
    cold = {"bfs": ts.bfs(view, state, srcs),
            "sssp": ts.sssp(view, state, srcs)}
    for m in ("gather", "ring"):
        cold["bc_" + m] = ts.bc_batched(view, state, srcs, src_chunk=3,
                                        bc_mode=m)
    counts = {}
    args = (view.w, view.occ, state.alive, state.ecnt,
            torch.as_tensor(srcs[:8], device=state.device), state.version)
    for kind, chunk in (("bfs", None), ("sssp", None), ("bc", None),
                        ("bc_ring", 1)):
        body, layouts = _program(mesh, kind, TILE, None, chunk)
        g = _launch(mesh, body, layouts, args)[1]
        counts[kind] = (dict(g.bytes), dict(g.calls),
                        dict(getattr(g, "moved", {})))
    out["counts"] = counts
    state2, _ = tc.apply_ops(state, ops)
    dirty = tc.dirty_vertices(state, state2)
    view = ts.refresh_sharded_view(state2, view, dirty)
    out["refreshed_view"] = view
    gv = ts.gather_view(view)
    out["refreshed"] = (gv.w.cpu().numpy(), gv.occ.cpu().numpy())
    delta = {"bfs": ts.delta_bfs_sharded(view, state2, cold["bfs"], dirty,
                                         srcs),
             "sssp": ts.delta_sssp_sharded(view, state2, cold["sssp"], dirty,
                                           srcs)}
    for m in ("gather", "ring"):
        delta["bc_" + m] = ts.delta_bc_sharded(
            view, state2, cold["bc_" + m], dirty, srcs, src_chunk=3,
            bc_mode=m)
    out["cold"] = {k: _np(v) for k, v in cold.items()}
    out["delta"] = {k: _np(v) for k, v in delta.items()}
    return out


def views_and_queries(mesh, arrays, srcs, ops):
    """``query_set`` on this process's rank, on its device, with the
    view's slots and band shape."""
    state = tc.state_from_numpy(*arrays, device=mesh.device)
    view = ts.build_sharded_view(state, mesh, tile=TILE)
    out = query_set(mesh, state, srcs, ops)
    refreshed = out.pop("refreshed_view")
    out.update(slots=[w is not None for w in view.w],
               occ_slots=[o is not None for o in view.occ],
               refreshed_slots=[w is not None for w in refreshed.w],
               band_shape=tuple(view.w[mesh.rank].shape), vp=view.vp,
               band=view.band, rows_per_shard=view.rows_per_shard,
               moved=dict(mesh.moved))
    return out


# ------------------------------- the stream -------------------------------

def gen_ops(rng, lo, hi, count, neg_frac=0.0):
    """One commit's mixed ops in ``[lo, hi)`` (the reference harness's
    ``tests/stream_differential.gen_ops``)."""
    ops = []
    for _ in range(count):
        r = float(rng.random())
        u = int(rng.integers(lo, hi))
        v = int(rng.integers(lo, hi))
        if r < 0.15:
            ops.append((PUTV, u))
        elif r < 0.25:
            ops.append((REMV, u))
        elif r < 0.85:
            w = (-1.0 if float(rng.random()) < neg_frac
                 else float(WEIGHTS[int(rng.integers(0, len(WEIGHTS)))]))
            ops.append((PUTE, u, v, w))
        else:
            ops.append((REME, u, v))
    return ops


def base_ops(rng, n):
    """Every vertex alive and a random edge set per half of the range."""
    half = n // 2
    base = [(PUTV, i) for i in range(n)]
    for lo, hi in ((0, half), (half, n)):
        for _ in range(3 * half):
            base.append((PUTE, int(rng.integers(lo, hi)),
                         int(rng.integers(lo, hi)),
                         float(WEIGHTS[int(rng.integers(0,
                                                        len(WEIGHTS)))])))
    return base


def same_single(kind, got, exp) -> bool:
    """A sharded reply's row 0 against a single-source local result: every
    field bit for bit, BC delta to ``TOL``, the agreement flag set."""
    if not bool(got.agree):
        return False
    names = {"bfs": ("ok", "dist", "parent"),
             "sssp": ("ok", "negcycle", "dist", "parent"),
             "bc": ("ok", "level", "sigma", "delta")}[kind]
    for name in names:
        a, b = getattr(got, name)[0], getattr(exp, name)
        if name == "delta":
            if not torch.allclose(a, b, **TOL):
                return False
        elif a.dtype != b.dtype or not torch.equal(a, b):
            return False
    return True


_FRESH = {"bfs": tq.bfs, "sssp": tq.sssp, "bc": tq.bc_dependencies}


def _commit(svc, ops):
    """Submit and flush ``ops``; a faulted commit is retried until it
    lands (the scheduler puts the chunk back)."""
    for op in ops:
        try:
            svc.submit(op)
        except InjectedFault:
            assert_service_ok(svc)
    for _ in range(256):
        try:
            svc.flush()
            return
        except InjectedFault:
            assert_service_ok(svc)
    raise AssertionError("a commit never landed")


def stream(mesh, seed, n, steps, bc_mode, neg_frac=0.0, score_every=0,
           chaos=None, journal_dir=None, compact_every=None,
           segment_bytes=None, adaptive_walls=False):
    """The reference harness's stream (``run_differential``) through the
    sharded service on ``mesh`` and, beside it, the local
    ``GraphService``: every reply checked (non-degraded: equal to the
    single-source query at its version; degraded: equal to the validated
    reply at its stale version).  ``chaos``: ``(seed, rate)`` of a
    ``FaultPlan`` over the stream.  Returns the rung tallies, the stats,
    the final state and, with ``journal_dir``, the recovered service's."""
    plan = FaultPlan(seed=chaos[0], rate=chaos[1]) if chaos else None
    rng = np.random.default_rng(seed)
    g0 = tc.make_graph(n, 16 * n, device="cpu")
    policy = ResiliencePolicy(max_retries=1) if plan is not None else None
    tel = Telemetry(block=False)
    journal = None
    path = None
    if journal_dir is not None:
        path = os.path.join(journal_dir, "sharded.jsonl")
        if mesh.rank == 0:
            journal = OpJournal(path,
                                meta=journal_meta(g0, {"batch_size": 4}),
                                segment_bytes=segment_bytes)
    adaptive = None
    if adaptive_walls:
        adaptive = AdaptiveThresholds(period=4, min_full=1, min_delta=2,
                                      probe_every=0)
        _drive_walls(adaptive, mesh.rank)
    svc = ts.ShardedGraphService(
        g0, mesh, tile=8, batch_size=4, bc_mode=bc_mode, src_chunk=2,
        telemetry=tel, policy=policy, journal=journal,
        compact_every=compact_every, adaptive=adaptive)
    decisions = []
    if adaptive_walls:
        agree = svc._agree

        def recording(value):
            got = agree(value)
            decisions.append((value, got))
            return got

        svc._agree = recording
    local = GraphService(g0, batch_size=4)
    tallies = {m: 0 for m in ("unchanged", "delta", "full", "degraded",
                              "raised")}
    validated, checked = {}, 0

    def query(kind, src):
        nonlocal checked
        try:
            reply = svc.query(kind, [src])
        except InjectedFault:
            tallies["raised"] += 1
            assert_service_ok(svc)
            return
        if reply.degraded:
            tallies["degraded"] += 1
            prev = validated[(kind, src, reply.stale_version)]
            assert tc_equal(reply.result, prev), (kind, src, reply.version)
        else:
            tallies[reply.mode] += 1
            state = svc.ring.get(reply.version)
            assert same_single(kind, reply.result,
                               _FRESH[kind](state, src)), (
                kind, src, reply.version, reply.mode)
            validated[(kind, src, reply.version)] = reply.result
            if plan is None:
                want = local.query(kind, src)
                assert want.version == reply.version
                assert same_single(kind, reply.result, want.result)
        checked += 1

    scores = []
    with fault_scope(plan):
        base = base_ops(rng, n)
        _commit(svc, base)
        if plan is None:
            _commit(local, base)
        pinned = [0, 1]
        half = n // 2
        for step in range(steps):
            lo, hi = (half, n) if step % 2 else (0, half)
            ops = gen_ops(rng, lo, hi, 8, neg_frac)
            _commit(svc, ops)
            if plan is None:
                _commit(local, ops)
            for src in pinned + [int(rng.integers(0, n))]:
                for kind in KINDS:
                    query(kind, src)
            if score_every and (step + 1) % score_every == 0:
                got, v = svc.bc_scores()
                want, lv = GraphService(svc.ring.latest.state).bc_scores()
                assert v == svc.version
                assert torch.allclose(got, want, rtol=1e-4, atol=1e-4,
                                      equal_nan=True)
                scores.append(got)
    out = {"tallies": tallies, "stats": svc.stats.as_dict(),
           "checked": checked, "scores": scores,
           "state": [x.clone() for x in svc.ring.latest.state],
           "version": svc.version,
           "coll_bytes": [r.get("coll_bytes") for r in tel.tracer.records
                          if r.get("span") == "query"],
           "decisions": decisions,
           "thresholds": adaptive.thresholds() if adaptive else None,
           "fired": plan.fired if plan is not None else 0}
    if journal is not None:
        out["journal"] = {"rotations": journal.rotations,
                          "compactions": journal.compactions,
                          "segments_dropped": journal.segments_dropped}
    if journal_dir is not None:
        mesh.barrier()  # rank 0's journal is whole before anyone reads it

        def make_service(state, **kw):
            return ts.ShardedGraphService(state, mesh, tile=8,
                                          bc_mode=bc_mode, src_chunk=2, **kw)

        rec = recover(path, g0, make_service=make_service, device="cpu",
                      batch_size=4)
        out["recovered"] = [x.clone() for x in rec.ring.latest.state]
        out["recovered_version"] = rec.version
        out["recovered_pending"] = rec.scheduler.pending()
        out["pending"] = svc.scheduler.pending()
        assert_service_ok(rec)
        for kind in KINDS:
            for src in (0, 1):
                reply = rec.query(kind, [src])
                assert reply.version == svc.version
                assert same_single(kind, reply.result, _FRESH[kind](
                    rec.ring.latest.state, src)), (kind, src)
    tel.close()
    return out


def tc_equal(a, b) -> bool:
    from repro_torch.engine.incremental import results_equal
    return bool(results_equal(a, b))


def _drive_walls(adaptive, rank):
    """Walls that pull rank 0's crossover to the top clamp and every other
    rank's to the bottom one: left to themselves, the ranks would pick
    different rungs for one dirty fraction."""
    for kind in KINDS:
        for _ in range(8):  # eight adjustments: near the clamps
            adaptive.observe(kind, "full", 1000.0 if rank == 0 else 100.0,
                             None)
            for frac in (0.1, 0.2, 0.3):
                wall = (100.0 + 200.0 * frac if rank == 0
                        else 50.0 + 5000.0 * frac)
                adaptive.observe(kind, "delta", wall, frac)


def breaker(mesh, seed):
    """The breaker quarantines the sharded delta path on every rank (the
    reference's ``test_resil.py::test_breaker_quarantines_sharded_delta_path``):
    two delta faults trip it, the next reply runs full and equals the local
    service's."""
    rng = np.random.default_rng(seed)
    n = 32
    g0 = tc.make_graph(n, 16 * n, device="cpu")
    svc = ts.ShardedGraphService(
        g0, mesh, tile=8, batch_size=4, src_chunk=2,
        policy=ResiliencePolicy(max_retries=1),
        breaker=CircuitBreaker(fail_threshold=2, cooldown=2, probes=1))
    oracle = GraphService(g0, batch_size=4)

    def churn():
        ops = [(PUTE, 0, int(rng.integers(1, n)), 1.0),
               (PUTE, int(rng.integers(0, n)), int(rng.integers(0, n)),
                2.0)]
        for s in (svc, oracle):
            s.submit_many(ops)
            s.flush()

    base = base_ops(rng, n)
    for s in (svc, oracle):
        s.submit_many(base)
        s.flush()
        s.query("bfs", [0] if s is svc else 0)
    retries = []
    with fault_scope(FaultPlan({P_COLLECT_DELTA: list(range(64))})):
        for _ in range(2):
            churn()
            retries.append(svc.query("bfs", [0]).retries)
    state_open = svc.breaker.state("bfs")
    churn()
    reply = svc.query("bfs", [0])
    want = oracle.query("bfs", 0)
    assert_service_ok(svc)
    return {"retries": retries, "state": state_open, "mode": reply.mode,
            "reply_retries": reply.retries,
            "equal": same_single("bfs", reply.result, want.result),
            "trips": svc.breaker.trips, "stats": svc.stats.as_dict()}


# ------------------------- the front end on the mesh ----------------------

FRONT_WAIT = 120    # seconds any one wait of the front-end bodies may take


def same_rows(kind, got, srcs, state) -> bool:
    """Every row of a sharded reply against the single-source query of its
    source on ``state`` (``same_single``'s criteria)."""
    for i, src in enumerate(srcs):
        row = type(got)(*(x[i:] if x.dim() and x.shape[0] == len(srcs)
                          else x for x in got))
        if not same_single(kind, row, _FRESH[kind](state, src)):
            return False
    return True


def _front_end_lead(srv, state, chunks, asks, n_clients, sequential):
    """Rank 0's clients: ``sequential``: one client asks every ask and
    waits for each reply, a commit after each round; else ``n_clients``
    threads ask every ask (rotated) while an updater commits ``chunks``
    (each op submitted, then flushed; a faulted commit retried), one
    version a chunk from ``state``.  Returns each reply as (kind, srcs,
    version, mode, validated, degraded, result fields, held against the
    single-source queries) or its error."""
    import threading

    futs, errs = [], []
    lock = threading.Lock()

    def commit(ops):
        for op in ops:
            try:
                srv.submit(op)
            except InjectedFault:
                pass
        for _ in range(64):
            try:
                srv.flush()
                return
            except InjectedFault:
                pass
        raise AssertionError("a commit never landed")

    def client(c):
        try:
            for k in range(len(asks)):
                kind, srcs = asks[(c + k) % len(asks)]
                f = srv.query_async(kind, srcs)
                with lock:
                    futs.append((kind, srcs, f))
        except Exception as e:  # pragma: no cover - harness guard
            errs.append(e)

    def updater():
        try:
            for ops in chunks:
                commit(ops)
        except Exception as e:  # pragma: no cover - harness guard
            errs.append(e)

    srv.start()
    try:
        if sequential:
            for ops in list(chunks) + [None]:
                for kind, srcs in asks:
                    f = srv.query_async(kind, srcs)
                    f.exception(timeout=FRONT_WAIT)
                    futs.append((kind, srcs, f))
                if ops is not None:
                    commit(ops)
        else:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            threads.append(threading.Thread(target=updater))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=FRONT_WAIT)
                assert not t.is_alive(), "a client hung"
        assert srv.drain(timeout=FRONT_WAIT)
    finally:
        srv.stop(timeout=FRONT_WAIT)
    assert not errs, errs
    states = [state]    # version v: the first v chunks committed
    for ops in chunks:
        states.append(tc.apply_ops(states[-1], ops,
                                   batch_size=len(ops))[0])
    out = []
    for kind, srcs, f in futs:
        exc = f.exception(timeout=FRONT_WAIT)
        if exc is not None:
            out.append((kind, srcs, type(exc).__name__))
            continue
        rep = f.result()
        same = same_rows(kind, rep.result, srcs, states[rep.version])
        out.append((kind, srcs, rep.version, rep.mode, rep.validated,
                    rep.degraded, _np(rep.result), same))
    return out


def front_end(mesh, arrays, chunks, asks, bc_mode="gather", n_clients=3,
              chaos=None, deadline_ms=None, sequential=False, ring_depth=8):
    """``AsyncGraphService`` over ``ShardedGraphService`` on the mesh:
    rank 0 serves ``_front_end_lead``'s schedule, the other ranks
    ``follow()``.  ``chaos``: ``(seed, rate)`` of a ``FaultPlan`` active
    on every rank; ``deadline_ms``: the policy's admission deadline;
    ``ring_depth``: the service's (a shallow ring parks pinned versions).
    Every rank returns its front end's and service's tallies, the control
    bytes moved, the pins left, the admissions it finished as expired
    and the plan's decisions."""
    from repro_torch.serve import AsyncGraphService

    plan = FaultPlan(seed=chaos[0], rate=chaos[1]) if chaos else None
    policy = None
    if plan is not None or deadline_ms is not None:
        policy = ResiliencePolicy(
            max_retries=2, deadline_ms=(float("inf") if deadline_ms is None
                                        else deadline_ms))
    state = tc.state_from_numpy(*arrays, device="cpu")
    tel = Telemetry(block=False)
    svc = ts.ShardedGraphService(state, mesh, tile=TILE,
                                 batch_size=max(len(c) for c in chunks),
                                 bc_mode=bc_mode, telemetry=tel,
                                 policy=policy, ring_depth=ring_depth)
    srv = AsyncGraphService(svc, max_batch=16)
    expired = []
    finish_expired = srv._finish_expired

    def record(req):
        expired.append(req.aid)
        finish_expired(req)

    srv._finish_expired = record
    out = {"rank": mesh.rank}
    with fault_scope(plan):
        if mesh.rank:
            out["commands"] = srv.follow()
        else:
            out["replies"] = _front_end_lead(srv, state, chunks, asks,
                                             n_clients, sequential)
    st = srv.stats
    out.update(
        serve={k: getattr(st, k) for k in (
            "admitted", "batched_dispatches", "dispatches", "fallbacks",
            "deadline_expired", "max_batch_seen")},
        stats=svc.stats.as_dict(), version=svc.version,
        control=mesh.moved.get("control", 0),
        pinned=svc.ring.pinned_versions(), evictions=svc.ring.evictions,
        expired=sorted(expired),
        dedup=sum(sum(h.samples) for h in tel.registry.find(
            "serve_batch_size", rung="dedup")),
        fired=plan.fired if plan else 0,
        log=list(plan.log) if plan else [])
    tel.close()
    return out


def front_end_crash(mesh, arrays):
    """Rank 0's dispatcher dies of an ``InjectedCrash`` at its second
    dispatch; every follower must raise ``RankFailure`` then, not wait
    out the mesh's timeout.  Every rank raises."""
    import threading

    from repro_torch.resil.faults import P_SERVE_DISPATCH
    from repro_torch.serve import AsyncGraphService

    state = tc.state_from_numpy(*arrays, device="cpu")
    svc = ts.ShardedGraphService(state, mesh, tile=TILE)
    srv = AsyncGraphService(svc)
    if mesh.rank:
        t0 = time.monotonic()
        try:
            srv.follow()
        except ts.RankFailure as e:
            raise ts.RankFailure(f"follower {mesh.rank} after "
                                 f"{time.monotonic() - t0:.2f} s: {e}")
        return "followed to the end"
    died = []
    threading.excepthook = lambda a: died.append(a.exc_type.__name__)
    plan = FaultPlan({P_SERVE_DISPATCH: [1]},
                     crash_points=[P_SERVE_DISPATCH])
    with fault_scope(plan):
        srv.start()
    srv.query("bfs", [0], timeout=FRONT_WAIT)
    srv.query_async("sssp", [1])
    srv._thread.join(timeout=FRONT_WAIT)
    raise RuntimeError(f"rank 0's dispatcher died of {died}")
