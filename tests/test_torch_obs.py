"""Port parity for observability: ``repro_torch.obs`` against ``repro.obs``
on the same inputs, on the CPU.

Metrics, exposition, report and the adaptive controller are near copies
of the reference: the same observations must give the same quantiles,
snapshots, exposition text, summary rows and thresholds.  The torch
pieces -- the device timer and the cost accountant -- are held to their
own contracts here (host clock for a CPU result, ``None`` where nothing
was counted); their CUDA side runs in ``tests/test_torch_cuda.py``.
"""
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.obs.expo as jexpo
import repro.obs.report as jreport
import repro_torch.core as tc
import repro_torch.obs as tobs
import repro_torch.obs.expo as texpo
import repro_torch.obs.report as treport
import repro_torch.resil as tres
from repro_torch.engine import GraphService as TService

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIME_KEYS = {"t_s", "wall_us", "device_us", "block_us"}


def _feed(obs, seed):
    """One registry fed a seeded mix of labelled counters, gauges and
    histograms (a few hundred latency-like samples)."""
    rng = np.random.default_rng(seed)
    reg = obs.MetricsRegistry()
    for _ in range(300):
        kind = ("bfs", "sssp", "bc")[int(rng.integers(0, 3))]
        mode = obs.LADDER_MODES[int(rng.integers(0, 3))]
        reg.histogram("query_wall_us", service="local", kind=kind,
                      mode=mode).observe(float(rng.lognormal(5, 1)))
        reg.counter("service_queries", service="local").inc()
        reg.gauge("adaptive_dirty_threshold", service="local",
                  kind=kind).set(float(rng.random()))
    reg.counter("weird name-with\"quotes", label='a\\b"c\nd').inc(3)
    modes = obs.ModeCounters(reg, "bc_scores_queries", service="local")
    modes["delta"] += 2
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_quantiles_and_snapshot_match_reference(seed):
    jreg, treg = _feed(jobs, seed), _feed(tobs, seed)
    assert treg.snapshot() == jreg.snapshot()
    qs = (0.0, 0.5, 0.9, 0.95, 0.99, 1.0)
    assert treg.merged_quantiles("query_wall_us", qs) == \
        jreg.merged_quantiles("query_wall_us", qs)
    for kind in ("bfs", "sssp", "bc"):
        assert treg.merged_quantiles("query_wall_us", qs, kind=kind) == \
            jreg.merged_quantiles("query_wall_us", qs, kind=kind)
    samples = [h.samples for h in treg.find("query_wall_us")]
    for s in samples:
        for q in qs:
            assert tobs.quantile(s, q) == jobs.quantile(s, q)


def test_counter_struct_and_mode_counters_match_reference():
    out = []
    for obs in (tobs, jobs):
        class Stats(obs.CounterStruct):
            _FIELDS = ("a", "b")
            _PREFIX = "x_"
        reg = obs.MetricsRegistry()
        st = Stats(reg, service="s")
        st.a += 3
        st.b = 7
        modes = obs.ModeCounters(reg, "m", service="s")
        modes["full"] += 1
        with pytest.raises(TypeError):
            del modes["full"]
        out.append((st.as_dict(), dict(modes), reg.snapshot(), repr(st)))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [0, 3])
def test_exposition_text_matches_reference_and_validates(seed):
    jreg, treg = _feed(jobs, seed), _feed(tobs, seed)
    extra = dict(extra_counters={"trace_sink_errors": 2},
                 extra_gauges={"journal_depth": 5.0})
    ttext = texpo.render_openmetrics(treg, **extra)
    jtext = jexpo.render_openmetrics(jreg, **extra)
    assert ttext == jtext
    assert texpo.validate_openmetrics(ttext) == []
    assert jexpo.validate_openmetrics(ttext) == []
    broken = ttext.replace("# EOF\n", "").replace("_total", "", 1)
    assert texpo.validate_openmetrics(broken) == \
        jexpo.validate_openmetrics(broken) != []


def test_device_histogram_help_is_the_ports_own():
    """The one deliberate difference: ``query_device_us`` is CUDA-event
    stream time in the port, so its HELP line says so; every other line
    of the exposition is the reference's."""
    texts = []
    for obs, expo in ((tobs, texpo), (jobs, jexpo)):
        reg = obs.MetricsRegistry()
        reg.histogram("query_device_us", service="local", kind="bfs",
                      mode="full").observe(12.5)
        texts.append(expo.render_openmetrics(reg).splitlines())
    diff = [(a, b) for a, b in zip(*texts) if a != b]
    assert len(texts[0]) == len(texts[1]) and len(diff) == 1
    assert diff[0][0].startswith("# HELP query_device_us")
    assert "CUDA-event" in diff[0][0]


def _traced_stream(tmp_path, seed=0):
    """A small traced port stream with faults, for the report/expo
    readers: every ladder mode, degraded replies, error records."""
    rng = np.random.default_rng(seed)
    n = 24
    path = str(tmp_path / "trace.jsonl")
    tel = tobs.Telemetry.make(path, trace_max_bytes=20000)
    svc = TService(tc.make_graph(n, 16 * n, device="cpu"), batch_size=4,
                   telemetry=tel, adaptive=True,
                   policy=tres.ResiliencePolicy(max_retries=1))
    svc.submit_many([(tc.PUTV, i) for i in range(n)]
                    + [(tc.PUTE, int(u), int(v), 1.0) for u, v in
                       rng.integers(0, n, size=(48, 2))])
    plan = tres.FaultPlan(seed=seed, rate=0.2)
    with tres.fault_scope(plan):
        for step in range(10):
            for _ in range(2):  # churn on a hot set of 4 sources
                try:
                    svc.submit((tc.PUTE, int(rng.integers(n - 4, n)),
                                int(rng.integers(0, n)), 1.0))
                except tres.InjectedFault:
                    pass
            for src in (0, 5):
                for kind in ("bfs", "sssp", "bc"):
                    try:
                        svc.query(kind, src, mode="cn" if step % 4 == 0
                                  else "icn")
                    except tres.InjectedFault:
                        pass
    tel.close()
    files = [path] + [f"{path}.{i}" for i in range(1, 4)
                      if os.path.exists(f"{path}.{i}")]
    return svc, tel, files


def test_report_and_cli_match_reference(tmp_path, capsys):
    svc, tel, files = _traced_stream(tmp_path)
    assert tel.tracer.rotations >= 1 and len(files) >= 2
    trecs, jrecs = treport.load_many(files), jreport.load_many(files)
    assert trecs == jrecs
    rows = treport.summarize(trecs)
    assert rows == jreport.summarize(jrecs)
    assert treport.render(rows) == jreport.render(rows)
    modes = {r["mode"] for r in rows}
    assert {"unchanged", "delta", "full"} <= modes
    assert treport.validate(trecs, require_modes=("full",)) == \
        jreport.validate(jrecs, require_modes=("full",))
    for argv in ([*files], [*files, "--format", "json"],
                 [*files, "--check", "--require-modes", "full,delta"]):
        trc, tout = treport.main(argv), capsys.readouterr().out
        jrc, jout = jreport.main(argv), capsys.readouterr().out
        assert trc == jrc == 0 and tout == jout
    assert treport.main([*files, "--require-spans", "nonexistent"]) == 1


def test_report_cli_runs_as_a_module(tmp_path):
    _, _, files = _traced_stream(tmp_path, seed=1)
    env = dict(os.environ, PYTHONPATH=SRC)
    outs = []
    for mod in ("repro_torch.obs.report", "repro_torch.obs.expo"):
        r = subprocess.run([sys.executable, "-m", mod, *files, "--check"],
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert "CHECK OK" in outs[0]
    assert texpo.validate_openmetrics(outs[1]) == []
    reg = texpo.registry_from_trace(treport.load_many(files))
    jreg = jexpo.registry_from_trace(jreport.load_many(files))
    assert reg.snapshot() == jreg.snapshot()


def test_expo_server_scrape_matches_exposition(tmp_path):
    svc, tel, _ = _traced_stream(tmp_path, seed=2)
    journal = tres.OpJournal(str(tmp_path / "wal"))
    with tel.serve(port=0, journal=journal) as srv:
        assert srv.host == "127.0.0.1"
        with urllib.request.urlopen(srv.url, timeout=30) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
    assert ctype == texpo.CONTENT_TYPE
    assert body == tel.exposition(journal=journal)
    assert texpo.validate_openmetrics(body) == []
    families = {ln.split()[2] for ln in body.splitlines()
                if ln.startswith("# TYPE")}
    assert {"query_wall_us", "query_device_us", "service_queries",
            "journal_depth", "adaptive_dirty_threshold"} <= families
    journal.close()


@pytest.mark.parametrize("base,period", [(0.25, 8), ({"bfs": 0.3,
                                                       "sssp": 0.2,
                                                       "bc": 0.05}, 4)])
def test_adaptive_thresholds_match_reference(base, period):
    """One synthetic observation sequence (delta cost linear in the dirty
    fraction, full cost flat): the same consults, probes, thresholds and
    threshold_adjust records (times aside) in both packages."""
    rng = np.random.default_rng(period)
    ctrls = []
    for obs in (tobs, jobs):
        reg, tr = obs.MetricsRegistry(), obs.Tracer()
        ctrls.append((obs.AdaptiveThresholds(base=base, period=period,
                                             probe_every=5)
                      .bind(reg, tr, "local"), reg, tr))
    for _ in range(400):
        kind = ("bfs", "sssp", "bc")[int(rng.integers(0, 3))]
        frac = float(rng.random() * 0.5)
        full = float(rng.random()) < 0.3
        wall = 900.0 + rng.random() * 50 if full else 100 + 2000 * frac
        got = []
        for c, _, _ in ctrls:
            got.append(c.threshold(kind))
            c.observe(kind, "full" if full else "delta", wall,
                      None if full else frac)
            c.observe(kind, "unchanged", 1.0, None)
        assert got[0] == got[1]
    (t, treg, ttr), (j, jreg, jtr) = ctrls
    assert t.adjustments > 0 and t.snapshot() == j.snapshot()
    assert treg.snapshot() == jreg.snapshot()
    strip = [[{k: v for k, v in r.items() if k not in TIME_KEYS}
              for r in tr.records] for tr in (ttr, jtr)]
    assert strip[0] == strip[1] and len(strip[0]) == t.adjustments
    t.restore({"bfs": 2.0, "bc": 0.0, "nope": 0.5})
    j.restore({"bfs": 2.0, "bc": 0.0, "nope": 0.5})
    assert t.thresholds() == j.thresholds()


def test_tracer_rotation_and_sink_faults_match_reference(tmp_path):
    import repro.resil as jres
    recs = []
    for obs, res, name in ((tobs, tres, "t"), (jobs, jres, "j")):
        path = str(tmp_path / f"{name}.jsonl")
        tr = obs.Tracer(path=path, max_bytes=600, keep=2)
        plan = res.FaultPlan({res.P_OBS_SINK: [3, 4]})
        with res.fault_scope(plan):
            for i in range(20):
                with tr.span("query", kind="bfs", i=i) as sp:
                    with tr.span("collect", kind="bfs"):
                        obs.annotate(dirty=i)
                    sp.set(mode="full")
        tr.close()
        files = sorted(os.listdir(tmp_path))
        recs.append(([{k: v for k, v in r.items() if k not in TIME_KEYS}
                      for r in tr.records],
                     tr.rotations, tr.sink_errors, plan.hits,
                     [f[len(name):] for f in files
                      if f.startswith(name)]))
    assert recs[0] == recs[1]
    assert recs[0][1] > 0 and recs[0][2] == 2


def test_device_timer_on_cpu_uses_the_host_clock():
    timer = tobs.DeviceTimer()
    with timer.region("work", torch.device("cpu")) as reg:
        x = torch.randn(256, 256)
        y = x @ x
    assert not reg.cuda and reg.us > 0
    assert timer.measures == 1 and timer.total_us == reg.us
    assert timer.measure(y) >= 0 and timer.measures == 2
    assert tobs.block_until_ready((y, {"a": [x]})) is not None
    null = tobs.NullDeviceTimer()
    with null.region("work", torch.device("cpu")) as nreg:
        pass
    assert nreg.us == 0.0 and null.measure(y) == 0.0
    with pytest.raises(ValueError):
        with timer.region("work", torch.device("cpu")):
            raise ValueError("the work failed")
    assert timer.measures == 2  # a failed region is not read


def test_cost_accountant_measures_once_and_counts_only_what_it_sees():
    acct = tobs.CostAccountant(shared=False)
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b

    a, b = torch.randn(8, 16), torch.randn(16, 4)
    out = tobs.account_call(acct, ("mm", 8), fn, a, b)
    assert torch.equal(out, a @ b) and len(calls) == 1
    cost = acct.last
    assert set(cost) == {"collective_bytes", "collectives", "temp_bytes",
                         "peak_bytes", "flops"}
    assert cost["flops"] is None and cost["collective_bytes"] == 0
    assert cost["peak_bytes"] is None and cost["temp_bytes"] is None
    tobs.account_call(acct, ("mm", 8), fn, a, b)
    assert len(calls) == 2 and acct.last is cost  # cached, not re-run
    g = tc.from_edge_list(16, 64, np.arange(10), (np.arange(10) + 1) % 16,
                          device="cpu")
    from repro_torch.core import queries
    res = tobs.account_call(acct, ("bfs",), queries.bfs, g, 0)
    assert torch.equal(res.dist, queries.bfs(g, 0).dist)
    assert acct.last["flops"] is None
    assert tobs.account_call(None, ("x",), fn, a, b).shape == (8, 4)


def test_telemetry_make_switches_and_query_span_fields(tmp_path):
    tel = tobs.Telemetry.make(hlo=False, profile=False)
    assert tel.accountant is None
    assert isinstance(tel.profiler, tobs.NullDeviceTimer)
    svc, tel, _ = _traced_stream(tmp_path)
    q = [r for r in tel.tracer.records if r["span"] == "query"
         and "error" not in r]
    assert q and all(set(jreport.QUERY_FIELDS) <= set(r) for r in q)
    assert all(0 < r["device_us"] <= r["wall_us"] + 0.1
               for r in q if r["mode"] != "degraded")
    spans = {r["span"] for r in tel.tracer.records}
    assert {"query", "collect", "commit"} <= spans
    assert json.loads(json.dumps(tel.registry.snapshot()))


def test_profiler_trace_exports_a_chrome_trace(tmp_path):
    sess = tobs.profile.profiler_trace(str(tmp_path / "prof"))
    assert sess is not None
    timer = tobs.DeviceTimer()
    with timer.region("collect:bfs", torch.device("cpu")):
        torch.randn(64, 64).sum()
    sess.close()
    with open(sess.path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "collect:bfs" in names
