"""``tools/refresh_phases.py`` on hand-built profiler events and spans: a
device operation counts in the spans open at its launch, matched by
correlation id; the phase split of a slice per refresh that swept and per
commit; the idle gaps named by the span open when they began; and the
share of the busy time the spans hold; each refresh's ``live_block_share``,
dead vertices and source rows, and each commit's ops by kind, from a
tracer's records."""
import importlib.util
import os
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "refresh_phases", os.path.join(ROOT, "tools", "refresh_phases.py"))
rp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rp)

from graphbench.profiling import Trace  # noqa: E402  (path set by the tool)

Span = rp.Span
MS = 1e-3


def _refresh(t0: float, forward_levels: int, backward_levels: int):
    """One refresh that sweeps, from ``t0``: ``forward_levels`` products of
    2 ms device time each, ``backward_levels`` of 3 ms, the loop controls'
    reads, and 1 ms of device time in the other phases."""
    spans, t = [], t0
    plan = Span(t, t + 1 * MS, "bc_scores.plan", 0.0)
    spans += [plan, Span(t + 0.5 * MS, t + 0.6 * MS, "host_read", 0.0)]
    t += 1 * MS
    spans.append(Span(t, t + 1 * MS, "tile_refresh", 0.5 * MS))
    t += 1 * MS
    spans.append(Span(t, t + 1 * MS, "bc_scores.views", 0.25 * MS))
    t += 1 * MS
    spans.append(Span(t, t + 1 * MS, "bc_scores.operands", 0.5 * MS))
    t += 1 * MS
    f0 = t
    for _ in range(forward_levels):
        spans.append(Span(t, t + 0.1 * MS, "host_read", 0.0))
        spans.append(Span(t + 0.1 * MS, t + 0.2 * MS, "host_read", 0.0))
        spans.append(Span(t + 0.2 * MS, t + 2.2 * MS,
                          "bc_scores.forward_level", 2 * MS))
        t += 2.2 * MS
    spans.append(Span(t, t + 0.1 * MS, "host_read", 0.0))
    t += 0.1 * MS
    spans.append(Span(f0, t, "bc_scores.forward",
                      2 * MS * forward_levels))
    b0 = t
    spans.append(Span(t, t + 0.1 * MS, "host_read", 0.0))
    t += 0.1 * MS
    for _ in range(backward_levels):
        spans.append(Span(t, t + 3 * MS, "bc_scores.backward_level", 3 * MS))
        t += 3 * MS
    spans.append(Span(b0, t, "bc_scores.backward",
                      3 * MS * backward_levels))
    spans.append(Span(t, t + 0.5 * MS, "bc_scores.reduce", 0.0))
    t += 0.5 * MS
    device = sum(s.device_s for s in spans if s.name in (
        "tile_refresh", "bc_scores.views", "bc_scores.operands",
        "bc_scores.forward", "bc_scores.backward"))
    spans.append(Span(t0, t, "bc_scores", device))
    return spans, t


def _commit(t0: float, wall: float):
    return [Span(t0, t0 + wall, "commit", 0.1 * MS),
            Span(t0, t0 + wall / 2, "commit.apply", 0.1 * MS),
            Span(t0 + wall / 2, t0 + wall, "commit.ring", 0.0)]


def _slice():
    """Three steps: commit, refresh; the second refresh finds nothing to
    redo (a ``bc_scores`` span without a sweep).  The benchmark's
    ``Trace`` of the slice and its spans."""
    spans, t = [], 0.0
    spans += _commit(t, 2 * MS)
    t += 3 * MS
    one, t = _refresh(t, forward_levels=4, backward_levels=6)
    spans += one
    spans += _commit(t, 4 * MS)
    t += 5 * MS
    spans += [Span(t, t + 1 * MS, "bc_scores.plan", 0.0),
              Span(t + 0.2 * MS, t + 0.3 * MS, "host_read", 0.0),
              Span(t, t + 1 * MS, "bc_scores", 0.0)]
    t += 2 * MS
    spans += _commit(t, 3 * MS)
    t += 4 * MS
    two, t = _refresh(t, forward_levels=6, backward_levels=6)
    spans += two
    spans.sort()
    device = [(s.start, s.end, "count_mm_kernel<1, true>")
              for s in spans if s.name.endswith("_level")]
    device += [(s.end - 0.1 * MS, s.end, "elementwise_kernel")
               for s in spans if s.name == "commit"]
    host = [(s.start, s.end, "aten::_local_scalar_dense")
            for s in spans if s.name == "host_read"]
    return Trace(t + 1 * MS, device, host), spans


#: the split's values on ``_slice()``: two sweeping refreshes, three
#: commits of 2, 4 and 3 ms
EXPECTED = {
    "bc_scores.forward_ms": (4 + 6) * 2.0 / 2,
    "bc_scores.backward_ms": (6 + 6) * 3.0 / 2,
    "forward_levels": (4 + 6) / 2,
    "backward_levels": (6 + 6) / 2,
    "host_reads": ((1 + 2 * 4 + 1 + 1) + (1 + 2 * 6 + 1 + 1)) / 2,
    "commit_wall_ms": (2 + 4 + 3) / 3,
    "commit.apply_ms": 0.1,
}


@pytest.mark.parametrize("key", sorted(EXPECTED))
def test_phase_split_per_refresh_that_swept_and_per_commit(key):
    _, spans = _slice()
    assert rp.phase_split(spans)[key] == pytest.approx(EXPECTED[key])


def test_phase_split_reads_nothing_without_a_sweep():
    _, spans = _slice()
    assert rp.phase_split(spans)["bc_scores.views_ms"] == pytest.approx(0.25)
    bare = [s for s in spans if not s.name.startswith("bc_scores.")]
    split = rp.phase_split(bare)
    assert split["bc_scores.views_ms"] is None
    assert split["bc_scores.forward_ms"] is None
    assert split["forward_levels"] is None
    assert rp.phase_split([])["commit_wall_ms"] == 0.0


def test_idle_gap_names_the_span_open_when_it_began():
    trace, spans = _slice()
    gaps = rp.idle_gaps(trace, spans, k=50)
    bare = trace.idle_gaps(k=50)
    assert [g[1] for g in gaps] == [g[1] for g in bare]
    for (name, _), (old, _) in zip(gaps, bare):
        assert name.startswith(old + "; in: ")
    ins = {name.split("; in: ")[1] for name, _ in gaps}
    # between two levels the read of the next level's flags holds the gap;
    # the range of the read itself is passed over for the span around it
    assert "bc_scores.forward" in ins and "host_read" not in ins
    assert "no span" in ins           # after a commit, before its refresh
    commit = next(s for s in spans if s.name == "commit.apply")
    assert rp.open_at(spans, commit.start + 1e-6) == "commit.apply"
    by = rp.idle_by_span(trace, spans)
    assert sum(ms for ms, _ in by.values()) == pytest.approx(
        (trace.window_s - trace.busy_s) * 1e3)


def test_coverage_is_the_spans_device_time_over_the_busy_time():
    trace, spans = _slice()
    inside = sum(s.device_s for s in spans
                 if s.name in ("commit", "bc_scores"))
    assert rp.coverage(trace, spans) == pytest.approx(inside / trace.busy_s)
    assert rp.coverage(Trace(1.0), spans) == 0.0


def test_device_time_follows_the_launch_not_the_clock():
    """A kernel counts in the ranges open when the host launched it, even
    where it runs after they closed; one that runs inside a range but was
    launched before it opened counts in none of its."""
    ranges = [(0.0, 1.0, "bc_scores"), (0.2, 0.4, "bc_scores.forward"),
              (0.6, 0.8, "bc_scores.backward")]
    launched = [(0.1, 0.5),      # before forward, runs across it
                (0.3, 2.0),      # in forward, runs long after it
                (0.7, 0.25),     # in backward
                (1.5, 9.0)]      # after every range
    spans = {s.name: s for s in rp.attribute(ranges, launched)}
    assert spans["bc_scores"].device_s == pytest.approx(2.75)
    assert spans["bc_scores.forward"].device_s == pytest.approx(2.0)
    assert spans["bc_scores.backward"].device_s == pytest.approx(0.25)
    assert [s.name for s in rp.attribute(ranges, launched)] == [
        "bc_scores", "bc_scores.forward", "bc_scores.backward"]


def _event(eid, name, device, start_us, end_us, note=False):
    return SimpleNamespace(id=eid, name=name, device_type=device,
                           is_user_annotation=note,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


def test_spans_of_matches_each_operation_to_its_launch_call_by_id():
    """From a profiler session's events: user ranges on the host are the
    spans; a device operation counts by the id of the CUDA call that
    launched it, wherever it ran; the device-side copy of a range and an
    aten op are no launch."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event(1, "bc_scores", cpu, 0, 1000, note=True),
        _event(2, "bc_scores.forward", cpu, 100, 300, note=True),
        _event(3, "bc_scores", cuda, 0, 1000, note=True),
        _event(4, "aten::mul", cpu, 120, 180),
        _event(10, "cudaLaunchKernel", cpu, 150, 160),
        _event(10, "elementwise_kernel", cuda, 500, 540),
        _event(11, "cuLaunchKernelEx", cpu, 250, 260),
        _event(11, "count_mm_kernel<1, true>", cuda, 600, 1600),
        _event(12, "cudaMemcpyAsync", cpu, 900, 910),
        _event(12, "Memcpy DtoH (Device -> Pageable)", cuda, 1700, 1702),
        _event(99, "orphan_kernel", cuda, 2000, 2100),
    ]
    spans = {s.name: s for s in rp.spans_of(events)}
    assert sorted(spans) == ["bc_scores", "bc_scores.forward"]
    assert spans["bc_scores.forward"].device_s == pytest.approx(1040e-6)
    assert spans["bc_scores"].device_s == pytest.approx(1042e-6)
    assert (spans["bc_scores"].start, spans["bc_scores"].end) == (0.0, 1e-3)


def test_live_block_shares_of_the_last_refreshes_oldest_first():
    """Each refresh's ``live_block_share`` from a tracer's records: the
    last ``count`` ``bc_scores`` records, other spans passed over, and
    ``None`` for a refresh that swept nothing."""
    records = [{"span": "bc_scores", "mode": "full",
                "live_block_share": 0.5},
               {"span": "bc_scores.forward"},
               {"span": "bc_scores", "mode": "delta",
                "live_block_share": 0.25},
               {"span": "commit"},
               {"span": "bc_scores", "mode": "unchanged"},
               {"span": "bc_scores", "mode": "delta",
                "live_block_share": 0.375}]
    def shares(recs, count):
        return [r["live_block_share"] for r in rp.last_records(
            recs, "bc_scores", count, ("live_block_share",))]

    assert shares(records, 3) == [0.25, None, 0.375]
    assert shares(records, 1) == [0.375]
    assert shares(records, 9) == [0.5, 0.25, None, 0.375]
    assert shares([], 3) == []


def test_last_records_give_each_refresh_and_commit_its_fields():
    """The fields the tool prints per refresh (``RECORD_FIELDS``) and per
    commit (``COMMIT_FIELDS``), from the last records of each span, oldest
    first; ``None`` where a record lacks one."""
    records = [{"span": "commit", "putv": 1, "remv": 2, "pute": 3,
                "reme": 4},
               {"span": "bc_scores", "mode": "full", "live_block_share": 0.5,
                "dead": 9, "revived_rows": 0, "cold_rows": 64,
                "reused_rows": 0},
               {"span": "commit", "putv": 0, "remv": 6, "pute": 0,
                "reme": 0, "version": 2},
               {"span": "bc_scores.forward"},
               {"span": "bc_scores", "mode": "unchanged"},
               {"span": "bc_scores", "mode": "delta",
                "live_block_share": 0.25, "dead": 15, "revived_rows": 1,
                "cold_rows": 7, "reused_rows": 40, "n_dirty": 12}]
    assert rp.RECORD_FIELDS == ("mode", "live_block_share", "dead",
                                "revived_rows", "cold_rows", "reused_rows")
    assert rp.COMMIT_FIELDS == ("putv", "remv", "pute", "reme")
    refreshes = rp.last_records(records, "bc_scores", 2, rp.RECORD_FIELDS)
    assert refreshes == [
        dict.fromkeys(rp.RECORD_FIELDS) | {"mode": "unchanged"},
        {"mode": "delta", "live_block_share": 0.25, "dead": 15,
         "revived_rows": 1, "cold_rows": 7, "reused_rows": 40}]
    commits = rp.last_records(records, "commit", 3, rp.COMMIT_FIELDS)
    assert commits == [{"putv": 1, "remv": 2, "pute": 3, "reme": 4},
                       {"putv": 0, "remv": 6, "pute": 0, "reme": 0}]
    assert rp.last_records([], "commit", 3, rp.COMMIT_FIELDS) == []


def test_live_pairs_read_the_masked_kernels_tallies():
    """``kernel_live_pair_share`` is the live (k-step, tile) pairs over the
    pairs launched, ``zero_tiles`` the tiles with no live k-step per
    product; a slice with no masked product reads ``None``.  On the CPU no
    launch adds to the tallies, and a reset reads zeros."""
    tally = {"launches": 4, "pairs": 4 * 128 * 128 * 256,
             "live_pairs": 838861, "zero_tiles": 40000}
    got = rp.live_pairs(tally)
    assert got["masked_products"] == 4
    assert got["kernel_live_pair_share"] == pytest.approx(
        838861 / (4 * 128 * 128 * 256))
    assert got["zero_tiles"] == 10000
    assert rp.live_pairs(dict.fromkeys(tally, 0)) == {
        "masked_products": 0, "kernel_live_pair_share": None,
        "zero_tiles": None}

    import torch
    from repro_torch.kernels import count_mm

    count_mm.reset_pairs()
    s, a = torch.ones((128, 64)), torch.ones((64, 128))
    count_mm.count_mm_masked(s, a, None, torch.ones((1, 1), dtype=torch.int32))
    assert count_mm.read_pairs() == dict.fromkeys(tally, 0)
    assert rp.live_pairs(count_mm.read_pairs())["zero_tiles"] is None
