"""Resilient serving: deterministic faults, degrade ladder, WAL recovery
(port of ``repro.resil``).

The paper's core guarantee — a stalled or failed operation never corrupts
shared state or blocks other readers — needs a *failure story* to be
testable.  This package supplies it, in four pieces the serving stack
(`repro_torch.engine`) threads through its hot paths:

  * :mod:`repro_torch.resil.faults` — seeded deterministic fault injection at
    named points (``inject``/``FaultPlan``/``fault_scope``): every
    failure mode is a replayable schedule, not a flake;
  * :mod:`repro_torch.resil.policy` — per-query deadline + bounded retry where
    each retry demotes down the ladder (delta failed → full from a
    pinned snapshot → last cached answer flagged ``degraded=True`` at a
    still-resident ``stale_version``), plus :class:`CircuitBreaker`
    fault domains: consecutive delta-collect failures trip a kind's
    ladder to ``full`` until half-open probes restore it;
  * :mod:`repro_torch.resil.journal` — append-only JSONL op WAL with commit
    barriers, segment rotation, and snapshot compaction (the validated
    checkpoint is the truncation barrier); ``recover()`` restores the
    snapshot and replays the tail into a bit-identical ring latest, with
    batch commits atomic across any crash point;
  * :mod:`repro_torch.resil.invariants` — ``verify_service()``: ring
    monotonicity, pin/parked and cache consistency, stats conservation —
    run after every injected fault in the chaos suites.
"""
from .faults import (  # noqa: F401
    FAULT_POINTS,
    P_CACHE_STORE,
    P_COLLECT_DELTA,
    P_COLLECT_DISPATCH,
    P_JOURNAL_BARRIER,
    P_JOURNAL_TORN,
    P_OBS_SINK,
    P_RING_EVICT,
    P_SCHED_APPLY,
    P_SCHED_RING_COMMIT,
    P_SERVE_DISPATCH,
    FaultPlan,
    InjectedCrash,
    InjectedFault,
    active_plan,
    fault_scope,
    inject,
)
from .invariants import assert_service_ok, verify_service  # noqa: F401
from .journal import (  # noqa: F401
    JOURNAL_SCHEMA,
    JournalError,
    OpJournal,
    journal_meta,
    read_journal,
    read_journal_versions,
    recover,
    segment_files,
    snapshot_dir,
)
from .policy import CircuitBreaker, ResiliencePolicy  # noqa: F401
