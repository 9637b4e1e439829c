"""The traffic drivers, one per ``kind`` of traffic file.

  * ``refresh_loop`` -- one thread commits a batch, refreshes every
    vertex's betweenness at its version, and repeats.

Version ``k`` is the initial graph after the first ``k`` batches of
``Run.history``.  Every driver warms up on the cell's own traffic before
the window opens, and nothing builds inside it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from . import profiling, system, traffic


@dataclass
class Run:
    """What a driver hands back to the harness."""

    t0: float = 0.0
    seconds: float = 0.0
    e2e: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    counters: dict = field(default_factory=dict)
    trace: object = None
    work: list = field(default_factory=list)    # (ops, bytes) per product
    work_trace: object = None                   # the counted step's slice
    history: list = field(default_factory=list)  # committed batches
    steps: list = field(default_factory=list)   # refresh: (version, scores)
    notes: dict = field(default_factory=dict)   # diagnostics, not compared
    version_gaps: int = 0      # flushes that did not commit one version
    stale_refreshes: int = 0   # refreshes not at the version just committed
    memory_peak: int = 0                        # bytes, read at the close


def refresh_loop(ctx) -> Run:
    """Commit a batch, ``bc_scores()`` at its version, repeat."""
    import torch

    p, seconds, svc = ctx.traffic, ctx.seconds, ctx.svc
    upd = p["updates"]
    history = ctx.history
    pending = []

    def step():
        if not pending:     # the data's batches, 64 at a time, reordered
            pending.extend(reversed(traffic.update_batches(
                ctx.rngs.updates, ctx.n, 64, upd, ctx.weights, ctx.hot_base,
                ctx.rngs.order, ctx.cell.root)))
        ops = pending.pop()
        svc.submit_many(ops)
        entries = svc.flush()
        history.append(ops)
        gap = [e.version for e in entries] != [len(history)]
        scores, version = svc.bc_scores()
        if ctx.device != "cpu":
            torch.cuda.synchronize()
        return version, scores, gap, version != len(history)

    def record(run, version, scores, gap, stale):
        run.steps.append((version, scores))
        run.version_gaps += gap
        run.stale_refreshes += stale

    svc.bc_scores()                      # cold: builds the kernels
    for _ in range(int(p["warmup_steps"])):
        step()
    run = Run(seconds=seconds, history=history)
    ctx.before_window()
    before = system.counters(svc)
    trace_from = float(p["trace_at"]) * seconds
    trace_steps = int(p["trace_steps"])
    t0 = run.t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        profile = (ctx.trace and run.trace is None
                   and time.perf_counter() - t0 >= trace_from)
        with profiling.Slice(enabled=profile) as sl:
            for _ in range(trace_steps if profile else 1):
                record(run, *step())
        if profile:
            run.trace = sl.read()
    t_end = time.perf_counter()
    run.memory_peak = ctx.memory_peak()
    run.counters = system.delta(system.counters(svc), before)
    run.attempted = len(run.steps)
    run.e2e = {"bc_refresh_ms": (t_end - t0) / len(run.steps) * 1e3}
    if ctx.trace:
        # one more step, its products' operands counted (outside the window)
        with counting_products(run.work):
            with profiling.Slice() as sl:
                result = step()
        run.work_trace = sl.read()
        record(run, *result)
    return run


class counting_products:
    """Within the block, every counting product the program builds through
    ``repro_torch.core.semiring.count_mm_against`` records the work its
    operands need (``roofline.count_product_work``) before it runs; the
    product itself is the program's, unchanged."""

    def __init__(self, records: list):
        self.records = records

    def __enter__(self):
        from repro_torch.core import semiring

        from . import roofline

        self._orig = orig = semiring.count_mm_against
        records = self.records

        def counted(a, *args, **kw):
            product = orig(a, *args, **kw)

            def run(x):
                records.append(roofline.count_product_work(x, a))
                return product(x)
            return run

        semiring.count_mm_against = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import semiring

        semiring.count_mm_against = self._orig
        return False


DRIVERS = {"refresh_loop": refresh_loop}
