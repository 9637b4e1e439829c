"""Deterministic fault injection: every failure mode a replayable schedule
(port of ``repro.resil.faults``, a copy: numpy and the standard library).

The paper's non-blocking guarantee is about *failure*: a stalled or dead
operation must never corrupt shared state or block other readers.  The
functional analogue cannot test that guarantee with real crashes — so
this module makes failure a first-class, seeded input.  Hot paths call
:func:`inject` at **named fault points** (scheduler apply / ring commit,
collect dispatch, delta-ladder compute, ring eviction, result-cache
stores, journal barriers, telemetry sink IO); a :class:`FaultPlan`
activated via :func:`fault_scope` decides, deterministically, which hits
raise.  With no active plan, ``inject`` is one contextvar read — the
serving hot path pays nothing in production.

Two fault species:

  * :class:`InjectedFault` (``RuntimeError``) — a recoverable operation
    failure: the degrade ladder in ``resil.policy`` retries/demotes it,
    and schedulers/services must stay consistent around it;
  * :class:`InjectedCrash` (``BaseException``) — simulated process death
    for the journal's crash-consistency tests.  Deliberately NOT an
    ``Exception`` so retry ladders and cleanup handlers cannot swallow
    it: only the test harness (standing in for the next process
    incarnation) catches it.

Plans are either **scheduled** (``{point: [hit indices]}`` — fire on
exactly those invocations of the point) or **seeded-random** (per-point
Bernoulli streams derived from ``(seed, crc32(point))``, so the decision
sequence is independent of dict order and of PYTHONHASHSEED).  Every
decision lands in ``plan.log``; ``plan.to_schedule()`` converts whatever
a random plan fired into an explicit schedule that replays the identical
failure pattern — a chaos flake becomes a regression test in one call.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FAULT_POINTS", "FaultPlan", "InjectedCrash", "InjectedFault",
    "P_CACHE_STORE", "P_COLLECT_DELTA", "P_COLLECT_DISPATCH",
    "P_JOURNAL_BARRIER", "P_JOURNAL_TORN", "P_OBS_SINK", "P_RING_EVICT",
    "P_SCHED_APPLY", "P_SCHED_RING_COMMIT", "P_SERVE_DISPATCH",
    "active_plan", "fault_scope", "inject",
]

# ----------------------------- named points --------------------------------
#: mid-batch in the scheduler: before ``apply_ops`` runs the chunk.
P_SCHED_APPLY = "sched.apply_ops"
#: between a successful ``apply_ops`` and the ring append — the worst
#: possible commit boundary for atomicity.
P_SCHED_RING_COMMIT = "sched.ring_commit"
#: a collect's full compute dispatch (the local ladder).
P_COLLECT_DISPATCH = "collect.dispatch"
#: the delta-ladder compute (a cached prior is about to be reused).
P_COLLECT_DELTA = "collect.delta"
#: ring eviction racing a query (a commit is about to rotate a version out).
P_RING_EVICT = "ring.evict"
#: result-cache slot write (a torn store must never corrupt a served slot).
P_CACHE_STORE = "cache.store"
#: journal commit barrier about to be written (crash point).
P_JOURNAL_BARRIER = "journal.barrier"
#: journal barrier torn mid-line (crash point; half the record reaches disk).
P_JOURNAL_TORN = "journal.torn"
#: telemetry JSONL sink IO.
P_OBS_SINK = "obs.sink"
#: the async front end's batched dispatch (a whole compatible-query batch
#: is about to run as one compiled call; a failure here must degrade to
#: the per-request resilient path, never lose a request).
P_SERVE_DISPATCH = "serve.dispatch"

#: every point the hot paths are wired with, for ``FaultPlan(points=...)``.
FAULT_POINTS: Tuple[str, ...] = (
    P_SCHED_APPLY, P_SCHED_RING_COMMIT, P_COLLECT_DISPATCH, P_COLLECT_DELTA,
    P_RING_EVICT, P_CACHE_STORE, P_JOURNAL_BARRIER, P_JOURNAL_TORN,
    P_OBS_SINK, P_SERVE_DISPATCH,
)

#: points that simulate process death by default (InjectedCrash).
DEFAULT_CRASH_POINTS: Tuple[str, ...] = (P_JOURNAL_BARRIER, P_JOURNAL_TORN)


class InjectedFault(RuntimeError):
    """A planned, recoverable operation failure."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class InjectedCrash(BaseException):
    """Simulated process death.  BaseException on purpose: recovery code
    under test must never 'handle' a crash — only the harness does."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected crash at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class FaultPlan:
    """A deterministic schedule of which fault-point hits fail.

    ``schedule``: ``{point: iterable of 0-based hit indices}`` — those
    exact invocations fire.  ``seed``/``rate``: per-point Bernoulli
    streams over ``points`` (default: every non-crash point in
    :data:`FAULT_POINTS`).  Both can be combined; a hit fires if either
    says so.  ``max_faults`` caps total firings (chaos streams with
    retries always drain).  ``crash_points`` fire as
    :class:`InjectedCrash` instead of :class:`InjectedFault`.
    """

    def __init__(self, schedule: Optional[Dict[str, Iterable[int]]] = None,
                 *, seed: Optional[int] = None, rate: float = 0.0,
                 points: Optional[Sequence[str]] = None,
                 crash_points: Sequence[str] = DEFAULT_CRASH_POINTS,
                 max_faults: Optional[int] = None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.schedule = {p: frozenset(int(h) for h in hs)
                         for p, hs in (schedule or {}).items()}
        self.seed = seed
        self.rate = rate
        if points is None:
            points = tuple(p for p in FAULT_POINTS
                           if p not in DEFAULT_CRASH_POINTS)
        self.points = tuple(points)
        self.crash_points = frozenset(crash_points)
        self.max_faults = max_faults
        self.hits: Dict[str, int] = {}
        self.log: List[Tuple[str, int, bool]] = []
        self.fired = 0
        # One RNG stream per point, keyed by (seed, crc32(point)) so the
        # draw sequence never depends on cross-point interleaving or on
        # PYTHONHASHSEED.
        self._rngs: Dict[str, np.random.Generator] = {}
        # Concurrent serving threads share one plan (the async front end
        # runs its dispatcher in the activating thread's copied context);
        # the per-hit bookkeeping must not tear across them.
        self._lock = threading.Lock()

    def _rng(self, point: str) -> np.random.Generator:
        rng = self._rngs.get(point)
        if rng is None:
            rng = np.random.default_rng(
                [self.seed, zlib.crc32(point.encode())])
            self._rngs[point] = rng
        return rng

    def check(self, point: str) -> bool:
        """Consume one hit of ``point``; True when this hit must fail."""
        return self.consume(point) is not None

    def consume(self, point: str):
        """Consume one hit of ``point``; its hit index when it must fail,
        else ``None`` — the atomic form ``inject`` uses (the index must
        come from the same critical section that drew the decision)."""
        with self._lock:
            hit = self.hits.get(point, 0)
            self.hits[point] = hit + 1
            fire = hit in self.schedule.get(point, ())
            if (not fire and self.seed is not None and self.rate > 0.0
                    and point in self.points):
                # always draw, even past max_faults, so the stream position
                # of later hits is independent of how many already fired
                draw = float(self._rng(point).random()) < self.rate
                fire = fire or draw
            if fire and (self.max_faults is not None
                         and self.fired >= self.max_faults):
                fire = False
            self.log.append((point, hit, fire))
            if fire:
                self.fired += 1
            return hit if fire else None

    def to_schedule(self) -> Dict[str, List[int]]:
        """The explicit schedule of everything this plan fired so far —
        ``FaultPlan(plan.to_schedule())`` replays the identical pattern."""
        out: Dict[str, List[int]] = {}
        for point, hit, fired in self.log:
            if fired:
                out.setdefault(point, []).append(hit)
        return out

    def __repr__(self):
        return (f"FaultPlan(fired={self.fired}, "
                f"hits={sum(self.hits.values())}, seed={self.seed}, "
                f"rate={self.rate}, schedule={bool(self.schedule)})")


# ------------------------------ activation ---------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_resil_fault_plan", default=None)


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE.get()


@contextlib.contextmanager
def fault_scope(plan: Optional[FaultPlan]):
    """Activate ``plan`` for the dynamic extent of the block (``None`` is
    allowed and a no-op, so callers can thread an optional plan)."""
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def inject(point: str) -> None:
    """Fault point: raise per the active plan; no-op (one contextvar read)
    when no plan is active."""
    plan = _ACTIVE.get()
    if plan is None:
        return
    hit = plan.consume(point)
    if hit is not None:
        if point in plan.crash_points:
            raise InjectedCrash(point, hit)
        raise InjectedFault(point, hit)
