"""Port parity for resilience: ``repro_torch.resil`` / ``checkpoint`` /
``runtime`` against ``repro.resil`` / ``checkpoint`` / ``runtime`` on the
same numpy inputs, on the CPU.

The fault plans, policies and breakers must make the same decisions; one
seeded op/query stream through both ``GraphService``s with every option on
and one ``FaultPlan`` must give the same replies, ledgers, fault-point hit
counts and trace records (times aside); each package's ``recover()`` must
rebuild the same state from its own journal, with and without a snapshot
and after a crash at ``journal.barrier`` / ``journal.torn``, and the port
must recover a directory the reference wrote.  The heartbeat monitors run
on a monkeypatched clock, never on sleeps.

The adaptive controller rides the stream with ``period`` above the
stream's length: its adjustments follow measured wall times, which differ
between the packages, while its probes (every 16th consult) are
deterministic and must agree.  ``test_torch_obs.py`` holds the
adjustments themselves on one observation sequence.
"""
import dataclasses
import gc
import os
import types
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.core as jc
import repro.obs as jobs
import repro.resil as jres
import repro.runtime.fault_tolerance as jft
from repro.engine import GraphService as JService
import repro_torch.checkpoint as tckpt
import repro_torch.core as tc
import repro_torch.obs as tobs
import repro_torch.resil as tres
import repro_torch.runtime.fault_tolerance as tft
from repro_torch.engine import GraphService as TService

from stream_differential import WEIGHTS, gen_ops

TOL = dict(rtol=1e-5, atol=1e-5)
N = 24
BATCH = 4
#: span fields that are measured times, not decisions.
TIME_KEYS = {"t_s", "wall_us", "device_us", "block_us"}


def _port_only(span: str) -> bool:
    """The spans the port opens inside a BC refresh and a commit, which
    the reference has no counterpart for."""
    return (span == "bc_scores"
            or span.startswith(("bc_scores.", "commit.")))


#: the fields the port adds to a record the reference also writes: a
#: traced commit's ops by kind
_PORT_FIELDS = {"commit": ("putv", "remv", "pute", "reme")}
#: shared fields whose value differs by design, with the port's value: the
#: port builds its tile view in full at each version, where the reference
#: refreshes the dirty rows of its last view
_PORT_VALUES = {("tile_refresh", "full"): True}


def _as_reference_numbers(records):
    """The port's records with its own spans folded away: a folded span's
    children hang from its parent, and ids are renumbered in the order the
    spans opened, as a tracer that never opened the folded spans numbers
    them.  The port's own fields of a shared record (``_PORT_FIELDS``)
    are left out too."""
    parent = {r["id"]: r["parent"] for r in records}
    folded = {r["id"] for r in records if _port_only(r["span"])}
    kept = [r for r in records if r["id"] not in folded]
    rank = {i: n for n, i in enumerate(sorted(r["id"] for r in kept))}

    def outer(i):
        while i in folded:
            i = parent[i]
        return None if i is None else rank[i]

    def shared(r):
        return {k: v for k, v in r.items()
                if k not in _PORT_FIELDS.get(r["span"], ())}

    return [dict(shared(r), id=rank[r["id"]], parent=outer(r["parent"]))
            for r in kept]
#: thresholds a recovered service must resume from, not the defaults.
LEARNED = {"bfs": 0.4, "sssp": 0.1, "bc": 0.02}

REF = types.SimpleNamespace(
    name="ref", core=jc, Service=JService, obs=jobs, resil=jres, ft=jft,
    graph=lambda n: jc.make_graph(n, 16 * n),
    to_np=lambda st: [np.asarray(x) for x in st], recover_kw={})
PORT = types.SimpleNamespace(
    name="port", core=tc, Service=TService, obs=tobs, resil=tres, ft=tft,
    graph=lambda n: tc.make_graph(n, 16 * n, device="cpu"),
    to_np=lambda st: [x.numpy() for x in st], recover_kw={"device": "cpu"})


class _Clock:
    """perf_counter stand-in: one second per reading, so every timed unit
    lasts exactly one second."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


@pytest.fixture
def fixed_clock(monkeypatch):
    for ft in (jft, tft):
        monkeypatch.setattr(ft, "time", _Clock())


def _base_ops(seed):
    rng = np.random.default_rng(seed)
    half = N // 2
    ops = [(jc.PUTV, i) for i in range(N)]
    for lo, hi in ((0, half), (half, N)):
        ops += [(jc.PUTE, int(rng.integers(lo, hi)),
                 int(rng.integers(lo, hi)),
                 float(WEIGHTS[int(rng.integers(0, len(WEIGHTS)))]))
                for _ in range(3 * half)]
    return ops


def _assert_result(jres_, tres_, ctx):
    for name, a, b in zip(type(jres_)._fields, jres_, tres_):
        a, b = np.asarray(a), b.numpy()
        if name == "delta":
            np.testing.assert_allclose(b, a, err_msg=str(ctx), **TOL)
        else:
            assert np.array_equal(a, b), (ctx, name)


def _assert_same_state(a, b, ctx=""):
    for name, x, y in zip(jc.GraphState._fields, a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, name)


def _full_service(pkg, tmp, g0, *, trace=True, compact_every=3, **kw):
    tel = pkg.obs.Telemetry.make(
        os.path.join(tmp, "trace.jsonl") if trace else None,
        hlo=pkg is PORT)
    journal = pkg.resil.OpJournal(
        os.path.join(tmp, "wal.jsonl"), segment_bytes=1500,
        meta=pkg.resil.journal_meta(g0, {"batch_size": BATCH}))
    adaptive = pkg.obs.AdaptiveThresholds(
        base={"bfs": 0.25, "sssp": 0.25, "bc": 0.05}, period=10 ** 6)
    return pkg.Service(
        g0, batch_size=BATCH, ring_depth=4, telemetry=tel, adaptive=adaptive,
        policy=pkg.resil.ResiliencePolicy(max_retries=1, allow_stale=True),
        breaker=pkg.resil.CircuitBreaker(fail_threshold=2, cooldown=2),
        journal=journal, monitor=pkg.ft.HeartbeatMonitor(),
        compact_every=compact_every, **kw)


def _drive(pkg, svc, plan, seed, steps):
    """The stream: commits of mixed ops, each followed by BFS/SSSP/BC
    queries (one source in "cn" mode) and every third step bc_scores.
    Returns the outcome of every call, replies as (reply, ctx)."""
    rng = np.random.default_rng(seed + 100)
    out = []
    half = N // 2
    with pkg.resil.fault_scope(plan):
        for step in range(steps):
            lo, hi = (half, N) if step % 2 else (0, half)
            ops = gen_ops(rng, lo, hi, 6, 0.0)
            try:
                svc.submit_many(ops)
            except pkg.resil.InjectedFault as e:
                out.append(("submit_fault", e.point, e.hit))
            for _ in range(4):  # a faulted commit leaves its chunk pending
                try:
                    svc.flush()
                    break
                except pkg.resil.InjectedFault as e:
                    out.append(("flush_fault", e.point, e.hit))
            for src in (0, 1, int(rng.integers(0, N))):
                for kind in ("bfs", "sssp", "bc"):
                    mode = "cn" if (step + src) % 3 == 0 else "icn"
                    try:
                        out.append((svc.query(kind, src, mode=mode),
                                    (step, kind, src, mode)))
                    except pkg.resil.InjectedFault as e:
                        out.append(("query_fault", e.point, e.hit))
            if step % 3 == 2:
                scores, v = svc.bc_scores()
                out.append(("scores", np.asarray(scores), v))
    return out


def _run_stream(pkg, tmp, seed, steps, rate, compact_every=3,
                thresholds=None):
    os.makedirs(tmp, exist_ok=True)
    g0 = pkg.graph(N)
    svc = _full_service(pkg, tmp, g0, compact_every=compact_every)
    if thresholds:
        svc.adaptive.restore(thresholds)
    svc.submit_many(_base_ops(seed))
    svc.flush()
    plan = pkg.resil.FaultPlan(seed=seed, rate=rate)
    before = len(svc.telemetry.tracer.records)
    out = _drive(pkg, svc, plan, seed, steps)
    svc.telemetry.close()
    return g0, svc, plan, out, before


@pytest.mark.parametrize("seed,rate", [(0, 0.15), (1, 0.3)])
def test_faulted_stream_with_every_option_matches_reference(
        tmp_path, fixed_clock, seed, rate):
    runs = {pkg.name: _run_stream(pkg, str(tmp_path / pkg.name), seed, 9,
                                  rate)
            for pkg in (REF, PORT)}
    (_, jsvc, jplan, jout, _), (_, tsvc, tplan, tout, before) = \
        runs["ref"], runs["port"]
    assert jplan.fired > 0
    assert len(jout) == len(tout)
    degraded = retried = 0
    for a, b in zip(jout, tout):
        if a[0] == "scores":
            assert b[0] == "scores" and a[2] == b[2]
            np.testing.assert_allclose(b[1], a[1], equal_nan=True, **TOL)
        elif isinstance(a[0], str):
            assert a == b
        else:
            (jr, ctx), (tr, tctx) = a, b
            assert ctx == tctx
            assert (tr.version, tr.mode, tr.validated, tr.degraded,
                    tr.stale_version, tr.retries) == (
                jr.version, jr.mode, jr.validated, jr.degraded,
                jr.stale_version, jr.retries), ctx
            _assert_result(jr.result, tr.result, ctx)
            degraded += tr.degraded
            retried += tr.retries > 0
    assert degraded and retried  # both lower rungs ran
    assert tsvc.stats.as_dict() == jsvc.stats.as_dict()
    assert tsvc.scheduler.stats.as_dict() == jsvc.scheduler.stats.as_dict()
    assert dict(tsvc.bc_scores_stats) == dict(jsvc.bc_scores_stats)
    # Every record the tracer writes hits ``obs.sink``: the port's own
    # spans hit it once more each, so its draws there fall on other
    # records.  Every other point is hit and fires as the reference's.
    sink = tres.P_OBS_SINK
    ours = sum(_port_only(r["span"])
               for r in tsvc.telemetry.tracer.records[before:])
    assert ours > 0
    assert tplan.hits == dict(jplan.hits, **{sink: jplan.hits[sink] + ours})
    assert ([e for e in tplan.log if e[0] != sink]
            == [e for e in jplan.log if e[0] != sink])
    assert tsvc.telemetry.tracer.sink_errors == sum(
        fired for point, _, fired in tplan.log if point == sink)
    assert tsvc.breaker.snapshot() == jsvc.breaker.snapshot()
    assert tsvc.adaptive.snapshot() == jsvc.adaptive.snapshot()
    jrec = jsvc.telemetry.tracer.records
    trec = _as_reference_numbers(tsvc.telemetry.tracer.records)
    assert [r["span"] for r in trec] == [r["span"] for r in jrec]
    for jr, tr in zip(jrec, trec):
        assert set(tr) == set(jr), (jr["span"], set(tr) ^ set(jr))
        for key in set(jr) - TIME_KEYS:
            want = _PORT_VALUES.get((jr["span"], key), jr[key])
            assert tr[key] == want, (jr["span"], key, want, tr[key])
    assert tres.verify_service(tsvc) == [] and jres.verify_service(jsvc) == []


@pytest.mark.parametrize("compact", [False, True])
def test_recover_own_and_reference_journal(tmp_path, fixed_clock, compact):
    """Each package recovers its own journal into the live state and the
    other package's state; the port also recovers the reference's
    directory.  ``compact=False`` replays the whole history from the
    initial state; ``compact=True`` restores a snapshot and replays the
    tail (no initial state given)."""
    live = {}
    for pkg in (REF, PORT):
        tmp = str(tmp_path / pkg.name)
        g0, svc, _, _, _ = _run_stream(pkg, tmp, 2, 7, 0.0,
                                    compact_every=3 if compact else None,
                                    thresholds=LEARNED)
        svc.submit_many([(jc.PUTE, 1, 2, 2.0), (jc.PUTV, 3)])  # pending tail
        assert os.path.isdir(tmp + "/wal.jsonl.ckpt") == compact
        live[pkg.name] = (tmp, g0, svc)
    jstate = REF.to_np(live["ref"][2].ring.latest.state)
    _assert_same_state(jstate, PORT.to_np(live["port"][2].ring.latest.state))
    cases = [(REF, "ref"), (PORT, "port"), (PORT, "ref")]
    for pkg, writer in cases:
        tmp, g0, svc = live[writer]
        init = None
        if not compact:
            init = PORT.graph(N) if pkg is PORT else REF.graph(N)
        adaptive = pkg.obs.AdaptiveThresholds(
            base={"bfs": 0.25, "sssp": 0.25, "bc": 0.05})
        tel = pkg.obs.Telemetry.make(hlo=False)
        rec = pkg.resil.recover(os.path.join(tmp, "wal.jsonl"), init,
                                batch_size=BATCH, ring_depth=4,
                                telemetry=tel, adaptive=adaptive,
                                **pkg.recover_kw)
        ctx = (pkg.name, writer, compact)
        _assert_same_state(pkg.to_np(rec.ring.latest.state), jstate, ctx)
        assert rec.version == svc.version, ctx
        assert rec.scheduler.pending() == svc.scheduler.pending() == 2, ctx
        ss, live_ss = rec.scheduler.stats, svc.scheduler.stats
        for f in ("ops_submitted", "ops_committed", "batches_committed"):
            assert getattr(ss, f) == getattr(live_ss, f), (ctx, f)
        if compact:  # the learned thresholds ride the snapshot
            assert rec.adaptive.thresholds() == LEARNED, ctx
        assert pkg.resil.verify_service(rec) == [], ctx


@pytest.mark.parametrize("point", ["journal.barrier", "journal.torn"])
@pytest.mark.parametrize("compact", [False, True])
def test_crash_recovers_to_last_barrier_in_both(tmp_path, fixed_clock,
                                                point, compact):
    """A crash at the barrier (unwritten or torn) rolls the batch back:
    both packages recover the same state with the batch's ops pending,
    and the port recovers the reference's directory alike."""
    rng = np.random.default_rng(7)
    stream = [gen_ops(rng, 0, N, BATCH, 0.0) for _ in range(7)]
    crashed = {}
    for pkg in (REF, PORT):
        tmp = str(tmp_path / pkg.name)
        os.makedirs(tmp)
        g0 = pkg.graph(N)
        journal = pkg.resil.OpJournal(
            os.path.join(tmp, "wal.jsonl"),
            meta=pkg.resil.journal_meta(g0, {"batch_size": BATCH}))
        svc = pkg.Service(g0, batch_size=BATCH, journal=journal,
                          compact_every=2 if compact else None)
        svc.submit_many(_base_ops(3))
        plan = pkg.resil.FaultPlan({point: [5]})
        with pytest.raises(pkg.resil.InjectedCrash):
            with pkg.resil.fault_scope(plan):
                for ops in stream:
                    svc.submit_many(ops)
        journal.close()
        crashed[pkg.name] = (tmp, svc)
    jsvc = crashed["ref"][1]
    assert jsvc.version == crashed["port"][1].version
    # the ring took the crashed batch, its barrier never reached the disk
    want = REF.to_np(jsvc.ring.get(jsvc.version - 1))
    for pkg, writer in [(REF, "ref"), (PORT, "port"), (PORT, "ref")]:
        tmp, svc = crashed[writer]
        rec = pkg.resil.recover(os.path.join(tmp, "wal.jsonl"),
                                pkg.graph(N), batch_size=BATCH,
                                **pkg.recover_kw)
        ctx = (pkg.name, writer, point, compact)
        _assert_same_state(pkg.to_np(rec.ring.latest.state), want, ctx)
        # the crashed commit's batch is back in the pending log
        assert rec.scheduler.pending() == BATCH, ctx
        assert rec.version == svc.version - 1, ctx
        assert pkg.resil.verify_service(rec) == [], ctx


@pytest.mark.parametrize("seed,rate", [(5, 0.2), (11, 0.5), (3, 0.05)])
def test_fault_plan_schedule_matches_reference(seed, rate):
    points = tres.FAULT_POINTS
    plans = [tres.FaultPlan(seed=seed, rate=rate, max_faults=20),
             jres.FaultPlan(seed=seed, rate=rate, max_faults=20)]
    rng = np.random.default_rng(seed)
    for _ in range(400):
        p = points[int(rng.integers(0, len(points)))]
        assert plans[0].check(p) == plans[1].check(p), p
    assert plans[0].to_schedule() == plans[1].to_schedule()
    assert plans[0].log == plans[1].log and plans[0].fired == plans[1].fired
    replay = tres.FaultPlan(plans[0].to_schedule())
    for p, _hit, fired in plans[0].log:
        assert replay.check(p) == fired


def test_fault_points_and_species_match_reference():
    assert tres.FAULT_POINTS == jres.FAULT_POINTS
    with tres.fault_scope(tres.FaultPlan({tres.P_JOURNAL_TORN: [0],
                                          tres.P_COLLECT_DELTA: [0]})):
        with pytest.raises(tres.InjectedFault):
            tres.inject(tres.P_COLLECT_DELTA)
        with pytest.raises(tres.InjectedCrash):
            tres.inject(tres.P_JOURNAL_TORN)
    tres.inject(tres.P_COLLECT_DELTA)  # no plan: a no-op
    assert not issubclass(tres.InjectedCrash, Exception)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_circuit_breaker_transitions_match_reference(seed):
    rng = np.random.default_rng(seed)
    brs = []
    for pkg in (PORT, REF):
        reg, tr = pkg.obs.MetricsRegistry(), pkg.obs.Tracer()
        brs.append((pkg.resil.CircuitBreaker(fail_threshold=2, cooldown=3,
                                             probes=2).bind(reg, tr, "local"),
                    reg, tr))
    for _ in range(200):
        kind = ("bfs", "sssp", "bc")[int(rng.integers(0, 3))]
        r = float(rng.random())
        states = []
        for br, _, _ in brs:
            if br.allow_delta(kind):
                (br.record_failure if r < 0.45 else br.record_success)(kind)
            states.append(br.snapshot())
        assert states[0] == states[1]
    (tb, treg, ttr), (jb, jreg, jtr) = brs
    assert tb.trips > 0 and tb.restores > 0
    assert treg.snapshot() == jreg.snapshot()
    strip = [[{k: v for k, v in r.items() if k not in TIME_KEYS}
              for r in t.records] for t in (ttr, jtr)]
    assert strip[0] == strip[1]


def test_policy_matches_reference():
    for kw in ({}, {"backoff_ms": 2.0, "backoff_factor": 3.0},
               {"deadline_ms": 0.0, "max_retries": 3}):
        t, j = tres.ResiliencePolicy(**kw), jres.ResiliencePolicy(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert [t.backoff_s(a) for a in range(1, 5)] == [
            j.backoff_s(a) for a in range(1, 5)]
        assert t.deadline_exceeded(0.0) == j.deadline_exceeded(0.0)
    for bad in ({"max_retries": -1}, {"backoff_ms": -1.0}):
        with pytest.raises(ValueError):
            tres.ResiliencePolicy(**bad)


def test_heartbeat_flags_stragglers_on_a_fake_clock(monkeypatch):
    """Commit latencies 1, 1, ... then one of 5 and one of 2.5 against a
    median of 1: with factor 3 only the 5 is a straggler, in both
    packages."""
    durations = [1.0] * 10 + [5.0, 2.5, 1.0]
    for ft in (tft, jft):
        clock = types.SimpleNamespace(t=0.0)
        monkeypatch.setattr(ft, "time", types.SimpleNamespace(
            perf_counter=lambda clock=clock: clock.t))
        seen = []
        mon = ft.HeartbeatMonitor(factor=3.0,
                                  on_straggler=lambda *a: seen.append(a))
        dts = []
        for step, d in enumerate(durations):
            mon.start()
            clock.t += d
            dts.append(mon.stop(step))
        assert dts == durations
        assert mon.stragglers == 1 and seen == [(10, 5.0, 1.0)]


def test_scheduler_counts_a_straggling_commit(monkeypatch):
    """A commit that the monitor flags lands in ``scheduler_stragglers``
    and marks its ``commit`` span, driven by the monitor module's clock."""
    readings = iter([0.0, 1.0] * 9 + [0.0, 9.0] + [0.0, 1.0] * 4)
    monkeypatch.setattr(tft, "time", types.SimpleNamespace(
        perf_counter=lambda: next(readings)))
    tel = tobs.Telemetry.make(hlo=False, profile=False)
    svc = TService(PORT.graph(N), batch_size=1, telemetry=tel,
                   monitor=tft.HeartbeatMonitor())
    svc.submit_many([(tc.PUTV, i) for i in range(14)])
    assert svc.scheduler.stats.stragglers == 1
    commits = [r for r in tel.tracer.records if r["span"] == "commit"]
    assert [r.get("straggler", False) for r in commits] == \
        [False] * 9 + [True] + [False] * 4


@pytest.mark.parametrize("verify", [False, True])
def test_checkpoint_format_matches_reference(tmp_path, verify):
    """One GraphState saved by each package: the same files, manifests
    (time aside) and bytes; each package restores the other's."""
    g = jc.from_edge_list(16, 64, np.arange(10), (np.arange(10) * 3) % 16,
                          np.linspace(1, 4, 10).astype(np.float32))
    gt = tc.state_from_numpy(*REF.to_np(g), device="cpu")
    jm = jckpt.save_checkpoint(str(tmp_path / "j"), 3, g, version=7,
                               verify=verify, extra={"a": 1})
    tm = tckpt.save_checkpoint(str(tmp_path / "t"), 3, gt, version=7,
                               verify=verify, extra={"a": 1})
    jm.pop("time"), tm.pop("time")
    assert tm == jm
    for fn in os.listdir(tmp_path / "j" / "step_00000003"):
        if fn.endswith(".npy"):
            a = np.load(tmp_path / "j" / "step_00000003" / fn)
            b = np.load(tmp_path / "t" / "step_00000003" / fn)
            assert a.dtype == b.dtype and np.array_equal(a, b), fn
    assert tckpt.latest_step(str(tmp_path / "j")) == 3
    back = tckpt.restore_checkpoint(str(tmp_path / "j"), 3, gt,
                                    device="cpu", verify=verify)
    _assert_same_state(PORT.to_np(back), REF.to_np(g))
    jback = jckpt.restore_checkpoint(str(tmp_path / "t"), 3, g,
                                     verify=verify)
    _assert_same_state(REF.to_np(jback), REF.to_np(g))


def test_checkpointer_keeps_latest_and_restores_nested_trees(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": (torch.zeros(2, dtype=torch.int32), torch.ones(()))}
    for step in (1, 2, 3):
        ck.save(step, {"w": tree["w"] * step, "opt": tree["opt"]})
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["index.json", "step_00000002",
                                            "step_00000003"]
    step, got = ck.restore_latest(tree, device="cpu")
    assert step == 3 and torch.equal(got["w"], tree["w"] * 3)
    assert got["opt"][0].dtype == torch.int32
    jtree = jckpt.restore_checkpoint(
        str(tmp_path), 3, {"w": jnp.zeros((2, 3)),
                           "opt": (jnp.zeros(2, jnp.int32), jnp.ones(()))})
    assert np.array_equal(np.asarray(jtree["w"]), got["w"].numpy())


def test_constructors_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device works")
    g = PORT.graph(8)
    tckpt.save_checkpoint(str(tmp_path / "c"), 0, g, version=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tckpt.restore_checkpoint(str(tmp_path / "c"), 0, g)
    # a mesh restore needs the specs that lay each leaf out on it
    with pytest.raises(ValueError, match="go together"):
        tckpt.restore_checkpoint(str(tmp_path / "c"), 0, g, device="cpu",
                                 mesh=object())
    tres.OpJournal(str(tmp_path / "wal")).close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.recover(str(tmp_path / "wal"), g, batch_size=BATCH)


def test_verify_service_flags_planted_violations():
    svc = TService(PORT.graph(N), batch_size=BATCH)
    svc.submit_many(_base_ops(0))
    svc.flush()
    svc.query("bfs", 0)
    assert tres.verify_service(svc) == []
    svc.stats.delta += 1
    svc.scheduler.stats.ops_committed -= 1
    problems = tres.verify_service(svc)
    assert any("mode conservation" in p for p in problems)
    assert any("op ledger" in p for p in problems)
    with pytest.raises(AssertionError):
        tres.assert_service_ok(svc)


@pytest.mark.parametrize("point", ["sched.apply_ops", "sched.ring_commit",
                                   "ring.evict", "cache.store"])
def test_single_faults_leave_both_services_consistent(point):
    """One planned fault at each update/cache point: both packages raise
    at the same call and stay consistent, and a retry converges to the
    same state."""
    outs = []
    for pkg in (REF, PORT):
        svc = pkg.Service(pkg.graph(N), batch_size=BATCH, ring_depth=2)
        svc.submit_many(_base_ops(4))
        svc.flush()
        svc.query("sssp", 0)
        events = []
        with pkg.resil.fault_scope(pkg.resil.FaultPlan({point: [0]})):
            for ops in ([(jc.PUTE, 0, 5, 1.0)] * BATCH,
                        [(jc.REME, 0, 5)] * BATCH):
                try:
                    svc.submit_many(ops)
                    svc.flush()
                    r = svc.query("sssp", 0)
                    events.append((r.version, r.mode))
                except pkg.resil.InjectedFault as e:
                    events.append(("fault", e.point))
                    svc.flush()
        assert pkg.resil.verify_service(svc) == [], (pkg.name, point)
        outs.append((events, pkg.to_np(svc.ring.latest.state),
                     svc.stats.as_dict(), svc.scheduler.stats.as_dict()))
    assert outs[0][0] == outs[1][0] and ("fault", point) in outs[0][0]
    _assert_same_state(outs[1][1], outs[0][1], point)
    assert outs[0][2:] == outs[1][2:]


def test_dropped_service_frees_without_the_cycle_collector(tmp_path):
    """A service with every option is freed by reference counting alone,
    so its device tensors go when the last reference does."""
    g0 = PORT.graph(N)
    gc.disable()
    try:
        svc = _full_service(PORT, str(tmp_path), g0)
        svc.submit_many(_base_ops(0))
        svc.query("bfs", 0)
        svc.scheduler.journal.close()
        svc.telemetry.close()
        ref = weakref.ref(svc)
        del svc
        assert ref() is None
    finally:
        gc.enable()
