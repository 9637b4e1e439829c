#!/usr/bin/env python3
"""Where a BC refresh step goes, by the program's own spans (on the card).

    python3 tools/refresh_phases.py [--workload graph500_s14.bc_refresh]
        [--seed N] [--seconds 51] [--cold 2]

Runs the benchmark's cell once with ``--trace 1`` (``graphbench.harness``)
and reads the whole profiled slice, not only the result line: the device
time of each phase of a refresh (``bc_scores.plan``, ``tile_refresh``,
``bc_scores.views``, ``.operands``, ``.forward``, ``.backward``,
``.reduce``) and of the commit (``commit.apply``, ``commit.ring``) per
step, the share of the slice's busy time the ``commit`` and ``bc_scores``
ranges hold, every idle gap summed by the innermost span open when it
began, and the slice's mean step against the traced run's window mean.
Then ``--cold`` cold (``full``) refreshes on fresh services over the
cell's initial graph, read the same way, for the delta-against-cold
comparison.  Each refresh's record fields
(``RECORD_FIELDS``: ``live_block_share``, the share of the occupancy
grid's blocks, in the refresh's vertex order, that hold an entry; the dead
vertices; the source rows revived, restarted cold and reused whole) and
each commit's ops by kind (``COMMIT_FIELDS``) come from the ``bc_scores``
and ``commit`` records of a tracer the tool attaches to the service and
its scheduler.  The masked count kernel's own tallies
(``repro_torch.kernels.count_mm.read_pairs``), zeroed before each slice
and read after it, give the share of the (k-step, tile) pairs launched
that it found live (``kernel_live_pair_share``) and its tiles with no
live k-step per product (``zero_tiles``).  Prints one JSON object last.

The benchmark's ``Trace`` leaves the program's ``record_function`` ranges
out; this tool reads them from the same profiler events (``spans_of``).
"""
import argparse
import bisect
import gc
import json
import os
import subprocess
import sys
from collections import defaultdict
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

REFRESH = ("bc_scores.plan", "tile_refresh", "bc_scores.views",
           "bc_scores.operands", "bc_scores.forward", "bc_scores.backward",
           "bc_scores.reduce")
COMMIT = ("commit.apply", "commit.ring")
#: the program's range around one device-to-host read: a gap is named by
#: the span that holds the read, not by the read
HOST_READ = "host_read"
#: a refresh that ran a sweep holds this span (an unchanged one holds none)
SWEEP = "bc_scores.forward"
#: a ``bc_scores`` record's fields printed per refresh
RECORD_FIELDS = ("mode", "live_block_share", "dead", "revived_rows",
                 "cold_rows", "reused_rows")
#: a ``commit`` record's ops by kind, printed per commit
COMMIT_FIELDS = ("putv", "remv", "pute", "reme")


class Span(NamedTuple):
    """One program span of a slice: its host interval (seconds from the
    slice's start, as the benchmark's ``Trace`` counts), its name, and the
    device seconds of what it launched."""

    start: float
    end: float
    name: str
    device_s: float

    def holds(self, other: "Span") -> bool:
        return self.start <= other.start and other.end <= self.end


def attribute(ranges, launched) -> list:
    """``Span``s from host ranges ``(start, end, name)`` and device
    operations ``(launch time, device seconds)``: each range gets the
    device seconds of the operations launched inside it."""
    launched = sorted(launched)
    at = [t for t, _ in launched]
    csum = [0.0]
    for _, d in launched:
        csum.append(csum[-1] + d)
    out = []
    for s, t, name in sorted(ranges):
        lo, hi = bisect.bisect_left(at, s), bisect.bisect_right(at, t)
        out.append(Span(s, t, name, csum[hi] - csum[lo]))
    return out


def spans_of(events) -> list:
    """The program's spans among a profiler session's events.

    A device operation is matched to its launch by correlation id (the
    runtime call, ``cudaLaunchKernel``, ``cuLaunchKernelEx``,
    ``cudaMemcpyAsync`` ..., that the profiler gives the same id), and
    counts in every span open when that call ran: not by when it ran on
    the device.  An annotation's own ``device_time_total`` would miss the
    port's kernels, which are launched through ``ctypes`` outside any aten
    op: the profiler ties a launch to the innermost op, never to a range.
    """
    from torch.autograd import DeviceType

    # times as ``graphbench.profiling.Slice.read`` counts them
    starts = [e.time_range.start for e in events]
    base = min(starts, default=0.0)
    base = 0.0 if base < 60e6 else base
    ranges, calls, ops = [], {}, []
    for e in events:
        s = (e.time_range.start - base) / 1e6
        t = (e.time_range.end - base) / 1e6
        note = bool(getattr(e, "is_user_annotation", False))
        if e.device_type == DeviceType.CUDA:
            if not note:
                ops.append((e.id, t - s))
        elif e.device_type == DeviceType.CPU:
            if note:
                ranges.append((s, t, e.name))
            elif e.name.startswith("cu"):     # a CUDA API call
                calls[e.id] = s
    return attribute(ranges, [(calls[i], d) for i, d in ops if i in calls])


def named(spans, name: str, within: Span = None) -> list:
    """The spans called ``name``; with ``within``, those inside it."""
    return [s for s in spans if s.name == name
            and (within is None or within.holds(s))]


def per_sweep(spans, name: str, value):
    """``value(span)`` summed over the spans called ``name`` inside the
    refreshes that ran a sweep, over the number of those refreshes;
    ``None`` where no refresh swept."""
    runs = [b for b in named(spans, "bc_scores") if named(spans, SWEEP, b)]
    if not runs:
        return None
    return sum(value(s) for b in runs for s in named(spans, name, b)) / len(
        runs)


def open_at(spans, t: float) -> str:
    """The innermost program span open at ``t`` (``host_read`` aside)."""
    open_ = [s for s in spans if s.start <= t < s.end and s.name != HOST_READ]
    if not open_:
        return "no span"
    return max(open_, key=lambda s: (s.start, -s.end)).name


def phase_split(spans) -> dict:
    """Device ms per phase, per refresh that ran a sweep and per commit, and
    the refresh's counts, from one profiled slice's spans."""
    out = {}
    for name in REFRESH + ("bc_scores",):
        out[name + "_ms"] = per_sweep(spans, name, lambda s: s.device_s * 1e3)
    out["bc_scores_wall_ms"] = per_sweep(
        spans, "bc_scores", lambda s: (s.end - s.start) * 1e3)
    out["forward_levels"] = per_sweep(
        spans, "bc_scores.forward_level", lambda s: 1)
    out["backward_levels"] = per_sweep(
        spans, "bc_scores.backward_level", lambda s: 1)
    out["host_reads"] = per_sweep(spans, HOST_READ, lambda s: 1)
    commits = max(len(named(spans, "commit")), 1)
    for name in ("commit",) + COMMIT:
        out[name + "_ms"] = sum(s.device_s for s in named(spans, name)
                                ) * 1e3 / commits
    out["commit_wall_ms"] = sum(s.end - s.start for s in named(
        spans, "commit")) * 1e3 / commits
    return out


def _gaps(trace) -> list:
    """The slice's idle gaps ``(start, end)``, longest first, in the order
    ``Trace.idle_gaps`` lists them."""
    from graphbench import stats

    ivs = sorted((s, e) for s, e, _ in trace.device)
    gaps = stats.gaps(ivs, 0.0, trace.window_s)
    gaps.sort(key=lambda g: g[0] - g[1])
    return gaps


def idle_gaps(trace, spans, k: int = 10) -> list:
    """``Trace.idle_gaps``, each name followed by ``; in: <the innermost
    span open when the gap began>``."""
    return [[f"{name}; in: {open_at(spans, g0)}", length]
            for (name, length), (g0, _) in zip(trace.idle_gaps(k),
                                               _gaps(trace))]


def idle_by_span(trace, spans) -> dict:
    """Every idle gap of the slice, summed by the span open when it began:
    ``{span: [ms, count]}``, longest first."""
    by = defaultdict(lambda: [0.0, 0])
    for g0, g1 in _gaps(trace):
        by[open_at(spans, g0)][0] += (g1 - g0) * 1e3
        by[open_at(spans, g0)][1] += 1
    return dict(sorted(by.items(), key=lambda kv: -kv[1][0]))


def last_records(records, span: str, count: int, fields) -> list:
    """``fields`` of the last ``count`` records of ``span`` of a tracer,
    oldest first, ``None`` where a record lacks one (a refresh that swept
    nothing has no ``live_block_share``)."""
    mine = [r for r in records if r["span"] == span]
    return [{k: r.get(k) for k in fields} for r in mine[-count:]]


def coverage(trace, spans) -> float:
    """Device time launched inside the ``commit`` and ``bc_scores`` ranges
    over the slice's busy time."""
    inside = sum(s.device_s for s in spans
                 if s.name in ("commit", "bc_scores"))
    return inside / trace.busy_s if trace.busy_s else 0.0


def live_pairs(tally) -> dict:
    """``kernel_live_pair_share`` and ``zero_tiles`` per product from the
    masked count kernel's tallies over one slice (``read_pairs``), with
    the number of its products; ``None`` where none ran."""
    n = tally["launches"]
    return {"masked_products": n,
            "kernel_live_pair_share": (tally["live_pairs"] / tally["pairs"]
                                       if tally["pairs"] else None),
            "zero_tiles": tally["zero_tiles"] / n if n else None}


def read_slice(sl, read=None):
    """A closed ``graphbench.profiling.Slice``'s ``Trace`` (by ``read``,
    ``Slice.read`` by default) and the program's spans in it."""
    events = sl._prof.events() if sl._prof is not None else []
    return (read or type(sl).read)(sl), spans_of(events)


def cold_refreshes(cell, seed: int, count: int) -> list:
    """``count`` cold refreshes, each on a fresh service over the cell's
    initial graph, each profiled alone."""
    import torch

    from graphbench import graphs, profiling, system, traffic
    from repro_torch.engine import GraphService
    from repro_torch.kernels import count_mm
    from repro_torch.obs import Telemetry

    cfg = cell.config
    rngs = traffic.streams(seed, cfg["data_seed"])
    n, src, dst, w = graphs.draw(cfg, rngs.graph, cell.root)
    svc = system.build(cfg, n, src, dst, w,
                       graphs.edge_capacity(cfg, len(src)), "cuda")
    svc.bc_scores()                      # builds or loads the kernel
    state = svc.ring.latest.state
    del svc
    out = []
    for _ in range(count):
        gc.collect()
        torch.cuda.empty_cache()
        tel = Telemetry.make(hlo=False, profile=False)
        fresh = GraphService(state, telemetry=tel, **{
            k: int(v) for k, v in cfg["service"].items()})
        count_mm.reset_pairs()
        with profiling.Slice() as sl:
            fresh.bc_scores()
        trace, spans = read_slice(sl)
        assert fresh.bc_scores_stats["full"] == 1
        row = phase_split(spans)
        row.update(live_pairs(count_mm.read_pairs()))
        (fields,) = last_records(tel.tracer.records, "bc_scores", 1,
                                 RECORD_FIELDS)
        row.update(fields)
        row["wall_ms"] = trace.window_s * 1e3
        row["busy_ms"] = trace.busy_s * 1e3
        out.append(row)
        del fresh
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="graph500_s14.bc_refresh")
    ap.add_argument("--seed", type=int, default=4290000001)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cold", type=int, default=2)
    args = ap.parse_args()
    import torch

    from graphbench import drivers, harness, profiling, spec
    from repro_torch.kernels import count_mm
    from repro_torch.obs import Telemetry

    if not torch.cuda.is_available():
        sys.exit("refresh_phases: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cell = spec.resolve(ROOT, args.workload)
    steps = int(cell.traffic["trace_steps"])
    slices, records, runs, pairs = [], [], [], []
    read, enter = profiling.Slice.read, profiling.Slice.__enter__
    tel = Telemetry.make(hlo=False, profile=False)

    def zeroed(self):
        # the kernel's tallies count from the slice's start
        count_mm.reset_pairs()
        return enter(self)

    def keep(self):
        pairs.append(live_pairs(count_mm.read_pairs()))
        slices.append(read_slice(self, read))
        records.append({
            "refreshes": last_records(tel.tracer.records, "bc_scores",
                                      steps, RECORD_FIELDS),
            "commits": last_records(tel.tracer.records, "commit", steps,
                                    COMMIT_FIELDS)})
        return slices[-1][0]

    def traced(ctx):
        # the refreshes' and the commits' records, for their fields: a
        # tracer on the service and on its scheduler
        ctx.svc.telemetry = tel
        ctx.svc.scheduler.telemetry = tel
        runs.append(drive(ctx))
        return runs[-1]

    kind = cell.traffic["kind"]
    drive = drivers.DRIVERS[kind]
    profiling.Slice.read, profiling.Slice.__enter__ = keep, zeroed
    drivers.DRIVERS[kind] = traced
    out = harness.run_cell(cell, args.seed, args.seconds, trace=True)
    profiling.Slice.read, profiling.Slice.__enter__ = read, enter
    drivers.DRIVERS[kind] = drive
    trace, spans = slices[0]             # the window's slice
    result = {
        "card": card, "seed": args.seed, "correct": out["correct"],
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "slice_step_ms": trace.window_s / steps * 1e3,
        "window_step_ms": runs[0].e2e["bc_refresh_ms"],
        "busy_ms": trace.busy_s * 1e3, "window_ms": trace.window_s * 1e3,
        "coverage": coverage(trace, spans),
        "delta": phase_split(spans),
        **pairs[0],
        **records[0],
        "idle_by_span": idle_by_span(trace, spans),
        "idle_gaps": idle_gaps(trace, spans),
    }
    for key, value in result.items():
        print(f"{key}: {value}", flush=True)
    if args.cold:
        result["cold"] = cold_refreshes(cell, args.seed, args.cold)
        print(f"cold: {result['cold']}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
