"""The spans inside ``GraphService.bc_scores`` and the scheduler's commit on
the profiler's timeline (``repro_torch.obs.trace``): the ranges a delta
refresh opens and how they nest, their counts against the ``bc_scores``
trace record, the record's ``live_block_share``, dead vertices and source
rows (revived, cold, reused) and the one read they cost, a traced commit's
ops by kind, the commit's children without telemetry, and an off path that
never enters ``record_function``.  On the card: every device-to-host
copy inside a refresh is one ``host_read``."""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.queries as tc_queries
import repro_torch.obs.trace as ttrace
from repro_torch.core.updates import PUTE, REMV
from repro_torch.data import load_rmat_graph
from repro_torch.engine import GraphService
from repro_torch.obs import Telemetry

N, E = 256, 2048

#: the ranges a refresh that runs a sweep opens, each with its parent
PARENTS = {
    "bc_scores.plan": "bc_scores",
    "tile_refresh": "bc_scores",
    "bc_scores.views": "bc_scores",
    "bc_scores.operands": "bc_scores",
    "bc_scores.forward": "bc_scores",
    "bc_scores.forward_level": "bc_scores.forward",
    "bc_scores.backward": "bc_scores",
    "bc_scores.backward_level": "bc_scores.backward",
    "bc_scores.reduce": "bc_scores",
}


def _service(device="cpu", telemetry=None, n=N, e=E):
    g = load_rmat_graph(n, e, seed=1, device=device)
    return GraphService(g, telemetry=telemetry)


def _churn(svc, seed=0, n_ops=4):
    """A few edge puts from low sources: a small dirty set, a delta
    refresh."""
    rng = np.random.default_rng(seed)
    svc.submit_many([(PUTE, int(rng.integers(0, 16)),
                      int(rng.integers(0, svc.ring.latest.state.vcap)), 0.5)
                     for _ in range(n_ops)])
    svc.flush()


def _ranges(prof, device=DeviceType.CPU):
    """The profiler's user ranges on the host, by start."""
    return sorted((e for e in prof.events() if e.is_user_annotation
                   and e.device_type == device),
                  key=lambda e: e.time_range.start)


def _inside(outer, inner) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _innermost(ranges, e):
    """The innermost range other than ``e`` that holds ``e``."""
    around = [r for r in ranges if r is not e and _inside(r, e)
              and r.name != "host_read"]
    return max(around, key=lambda r: r.time_range.start, default=None)


def _profiled_refresh(svc, mode):
    """Profile a cold (``"full"``) or a ``"delta"`` refresh."""
    if mode == "delta":
        svc.bc_scores()
        _churn(svc)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.bc_scores()
    assert svc.bc_scores_stats[mode] == 1
    return _ranges(prof)


@pytest.mark.parametrize("mode", ["full", "delta"])
def test_refresh_opens_its_phase_ranges_nested_without_telemetry(mode):
    ranges = _profiled_refresh(_service(), mode)
    names = [r.name for r in ranges]
    assert names.count("bc_scores") == 1
    assert set(PARENTS) <= set(names)
    for r in ranges:
        if r.name in PARENTS:
            assert _innermost(ranges, r).name == PARENTS[r.name], r.name
    top = next(r for r in ranges if r.name == "bc_scores")
    reads = [r for r in ranges if r.name == "host_read"]
    assert reads and all(_inside(top, r) for r in reads)


def test_range_counts_equal_the_bc_scores_record():
    tel = Telemetry.make(hlo=False, profile=False)
    svc = _service(telemetry=tel)
    svc.bc_scores()
    _churn(svc)
    n0 = len(tel.tracer.records)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.bc_scores()
    names = [r.name for r in _ranges(prof)]
    recs = tel.tracer.records[n0:]
    (rec,) = [r for r in recs if r["span"] == "bc_scores"]
    assert rec["mode"] == "delta" and rec["version"] == 1
    assert rec["n_dirty"] > 0
    assert rec["forward_levels"] == names.count("bc_scores.forward_level") > 0
    assert (rec["backward_levels"] == names.count("bc_scores.backward_level")
            > 0)
    assert rec["host_reads"] == names.count("host_read")
    # forward: two reads per level and the final one; backward: one
    assert rec["host_reads"] >= 2 * rec["forward_levels"] + 2
    # the records of the phases hang from the refresh's
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["span"] in PARENTS:
            assert by_id[r["parent"]]["span"] == PARENTS[r["span"]]
    # unprofiled, the record counts the reads all the same
    _churn(svc, seed=1)
    n1 = len(tel.tracer.records)
    svc.bc_scores()
    (again,) = [r for r in tel.tracer.records[n1:]
                if r["span"] == "bc_scores"]
    assert again["host_reads"] >= 2 * again["forward_levels"] + 2


@pytest.mark.parametrize("mode", ["full", "delta"])
def test_traced_record_has_live_block_share_and_the_off_path_no_read(mode):
    """A tracer's ``bc_scores`` record carries the share of live blocks in
    the grid the products got, read through one ``host_read`` more than
    the same refresh makes untraced."""
    tel = Telemetry.make(hlo=False, profile=False)
    traced, plain = _service(telemetry=tel), _service()
    if mode == "delta":
        for svc in (traced, plain):
            svc.bc_scores()
            _churn(svc)
    n0 = len(tel.tracer.records)
    traced.bc_scores()
    (rec,) = [r for r in tel.tracer.records[n0:] if r["span"] == "bc_scores"]
    assert rec["mode"] == mode
    state = traced.ring.latest.state
    am, _, alive = tc_queries.dense_views(state)
    grid = tc_queries.block_occupancy(
        tc_queries.permute_square(am, tc_queries.bc_vertex_order(am, alive)),
        tc_queries.ORDER_TILE)
    assert 0.0 < rec["live_block_share"] <= 1.0
    assert rec["live_block_share"] == pytest.approx(grid.float().mean())
    # Untraced, the refresh's reads count on an outer span of a tracer
    # the service does not know: the refresh's own span is the null span.
    with ttrace.Tracer().span("outer") as outer:
        plain.bc_scores()
    assert plain.bc_scores_stats[mode] == 1
    assert outer.counts["host_read"] == rec["host_reads"] - 1


@pytest.mark.parametrize("mode", ["full", "delta"])
def test_traced_record_counts_dead_vertices_and_source_rows(mode):
    """A tracer's ``bc_scores`` record: ``dead``, the vertices not alive;
    ``revived_rows``, ``cold_rows`` and ``reused_rows``, the source rows
    the sweep restarts because they were revived, restarts from level 0,
    and keeps whole.  A cold refresh restarts every row; here a delta one
    follows edge puts and the removal of one vertex: that source's row
    restarts, none is revived, and a live source's tree is kept where it
    holds no dirty vertex."""
    tel = Telemetry.make(hlo=False, profile=False)
    svc = _service(telemetry=tel)
    prior = None
    if mode == "delta":
        svc.bc_scores()
        prior = svc._bc_scores["level"]
        svc.submit((REMV, 200))
        _churn(svc)
    n0 = len(tel.tracer.records)
    svc.bc_scores()
    (rec,) = [r for r in tel.tracer.records[n0:] if r["span"] == "bc_scores"]
    assert rec["mode"] == mode
    alive = svc.ring.latest.state.alive
    assert rec["dead"] == int((~alive).sum())
    if mode == "full":
        assert (rec["revived_rows"], rec["cold_rows"],
                rec["reused_rows"]) == (0, N, 0)
        return
    dirty = svc.ring.dirty_between(0, 1)
    kept = alive & ~((prior >= 0) & dirty[None, :]).any(dim=1)
    assert (rec["dead"], rec["revived_rows"], rec["cold_rows"]) == (1, 0, 1)
    assert rec["reused_rows"] == int(kept.sum())
    assert 0 < rec["reused_rows"] < int(alive.sum())


def test_traced_commit_record_counts_its_ops_by_kind():
    """A tracer's ``commit`` record counts the chunk's ops of each kind
    from the host tuples."""
    from repro_torch.core.updates import PUTV, REME

    tel = Telemetry.make(hlo=False, profile=False)
    svc = _service(telemetry=tel)
    ops = [(PUTV, 3), (PUTE, 1, 2, 0.5), (REME, 4, 5), (REMV, 7),
           (PUTE, 6, 9, 1.5), (REMV, 8)]
    n0 = len(tel.tracer.records)
    svc.submit_many(ops)
    svc.flush()
    (rec,) = [r for r in tel.tracer.records[n0:] if r["span"] == "commit"]
    assert rec["batch_ops"] == len(ops)
    assert {k: rec[k] for k in ("putv", "remv", "pute", "reme")} == {
        "putv": 1, "remv": 2, "pute": 2, "reme": 1}


class _Counting:
    """A stand-in for ``record_function`` that counts its entries."""

    entered = 0

    def __init__(self, name):
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        type(self).entered += 1
        return self._rf.__enter__()

    def __exit__(self, *exc):
        return self._rf.__exit__(*exc)


def test_off_path_never_enters_record_function(monkeypatch):
    monkeypatch.setattr(ttrace, "record_function", _Counting)
    monkeypatch.setattr(_Counting, "entered", 0)
    svc = _service()
    svc.bc_scores()
    _churn(svc)
    svc.bc_scores()
    svc.query("bc", 3)
    assert _Counting.entered == 0
    _churn(svc, seed=1)          # the same path under the profiler enters
    with profile(activities=[ProfilerActivity.CPU]):
        svc.bc_scores()
    assert _Counting.entered > 0


def test_commit_and_its_children_appear_around_a_flush_without_telemetry():
    svc = _service()
    rng = np.random.default_rng(5)
    svc.submit_many([(PUTE, int(rng.integers(0, N)), int(rng.integers(0, N)),
                      0.25) for _ in range(3)])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.flush()
    ranges = _ranges(prof)
    commits = [r for r in ranges if r.name == "commit"]
    assert len(commits) == 1
    kids = [r for r in ranges if r.name in ("commit.apply", "commit.ring")]
    assert [r.name for r in kids] == ["commit.apply", "commit.ring"]
    assert all(_innermost(ranges, r) is commits[0] for r in kids)


def _kernels_below(evt):
    """The device operations launched inside a host event (its own and its
    children's, by launch correlation)."""
    out = list(evt.kernels)
    for child in evt.cpu_children:
        out.extend(_kernels_below(child))
    return out


def _host_events_below(evt):
    out = []
    for child in evt.cpu_children:
        out.append(child)
        out.extend(_host_events_below(child))
    return out


@pytest.mark.cuda
def test_cuda_every_device_to_host_copy_of_a_refresh_is_a_host_read():
    """On the card, a delta refresh's ``host_read`` ranges equal the
    device-to-host copies the profiler puts inside ``bc_scores``, one copy
    each, and no ``aten::_local_scalar_dense`` runs outside them: a read
    that bypasses the helper fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    svc = _service("cuda", n=4096, e=65536)
    svc.bc_scores()
    _churn(svc, n_ops=24)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc.bc_scores()
        torch.cuda.synchronize()
    assert svc.bc_scores_stats["delta"] == 1
    (top,) = [e for e in prof.events() if e.name == "bc_scores"
              and e.device_type == DeviceType.CPU]
    below = _host_events_below(top)
    reads = [e for e in below if e.name == "host_read"]
    copies = [k for k in _kernels_below(top)
              if k.name.startswith("Memcpy DtoH")]
    assert reads and len(copies) == len(reads)
    assert all(sum(k.name.startswith("Memcpy DtoH")
                   for k in _kernels_below(r)) == 1 for r in reads)
    inside = {id(e) for r in reads for e in _host_events_below(r)}
    loose = [e.name for e in below if e.name == "aten::_local_scalar_dense"
             and id(e) not in inside]
    assert not loose
