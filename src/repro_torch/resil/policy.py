"""Deadline / retry-ladder degradation policy for the serving stack (port
of ``repro.resil.policy``, a copy).

The paper's posture — a failed writer never blocks a reader — becomes,
for a serving front end: a failed *collect* never takes down a query
that has anything correct left to say.  :class:`ResiliencePolicy`
parameterizes the ladder the services walk when a collect raises:

  1. the first attempt runs the normal unchanged → delta → full ladder;
  2. each retry **demotes**: the collect re-runs with the delta ladder
     disabled — a full recompute from a *pinned* snapshot of the latest
     ring version (delta failed → retry full), after an optional exponential
     backoff;
  3. once the retry budget or the per-query deadline is exhausted, the
     service serves the last cached answer at its still-resident ring
     version, flagged ``degraded=True`` with ``stale_version`` on the
     reply — correct *at the version it claims*, never a torn read.
     With no resident cached answer, the failure propagates: there is
     nothing correct to serve, and a loud error beats a silent lie.

The policy object is pure data + arithmetic; the ladder itself lives in
:meth:`repro_torch.engine.service.BaseGraphService._query_resilient`, so
every service walks the identical rungs.

:class:`CircuitBreaker` adds the *fault-domain* dimension the ladder
lacks: the retry ladder handles one failing query, but a persistently
poisoned delta path (a bad cache line, a pathological dirty region)
makes EVERY query pay the fail-then-retry tax.  The
breaker watches consecutive delta-collect failures per query kind and,
at ``fail_threshold``, **trips**: the kind's ladder is pinned at
``full`` (cached priors are quarantined, the delta path never runs), a
``ladder_pinned`` span + ``breaker_open`` gauge mark the transition,
and queries keep succeeding — bit-identical answers, just dearer.
After ``cooldown`` pinned collects the breaker goes **half-open**: the
next delta-eligible collect runs as a probe; ``probes`` consecutive
successful delta collects close the breaker (``ladder_restored`` span,
gauge back to 0), a single failure re-opens it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["CircuitBreaker", "ResiliencePolicy"]


@dataclass(frozen=True)
class ResiliencePolicy:
    """How a service degrades when collects fail or deadlines pass.

    ``deadline_ms`` bounds the *retry* budget, not the first attempt: a
    slow-but-successful first collect still returns fresh (better than
    stale); the deadline decides whether another rung is attempted.
    ``max_retries`` counts demoted re-collects after the first attempt.
    ``backoff_ms`` sleeps ``backoff_ms * backoff_factor**(attempt-1)``
    before retry ``attempt`` (keep 0 in tests).  ``allow_stale`` gates
    rung 3; with it off, an exhausted ladder re-raises the last error.
    """

    deadline_ms: float = float("inf")
    max_retries: int = 1
    backoff_ms: float = 0.0
    backoff_factor: float = 2.0
    allow_stale: bool = True

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_ms < 0 or self.deadline_ms < 0:
            raise ValueError("backoff_ms / deadline_ms must be >= 0")

    def deadline_exceeded(self, t0: float) -> bool:
        """True when the budget that started at ``t0`` (perf_counter) is
        spent — no further rungs should be attempted."""
        if self.deadline_ms == float("inf"):
            return False
        return (time.perf_counter() - t0) * 1e3 >= self.deadline_ms

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based), in seconds."""
        if self.backoff_ms <= 0.0:
            return 0.0
        return (self.backoff_ms * self.backoff_factor ** (attempt - 1)) / 1e3


#: query kinds the services run the ladder for (mirrors
#: ``repro_torch.obs.adaptive.LADDER_KINDS``; kept literal so the policy layer
#: stays import-free).
BREAKER_KINDS = ("bfs", "sssp", "bc")


class CircuitBreaker:
    """Per-kind delta-path circuit breaker: closed → open → half-open.

    The services consult :meth:`allow_delta` once per collect that has a
    usable cached prior (no prior → full recompute anyway, nothing to
    gate) and report back :meth:`record_failure` (a collect raised while
    the delta path was in play) or :meth:`record_success` (a delta
    collect completed).  ``fail_threshold`` consecutive failures trip a
    kind **open**: priors are quarantined and every collect runs the
    clean full path.  After ``cooldown`` denied consults the breaker
    goes **half-open** — that consult is the probe — and ``probes``
    consecutive delta successes close it again; any half-open failure
    re-opens with a fresh cooldown.  ``bind`` attaches registry / tracer
    / service label: trips emit a ``ladder_pinned`` span + set the
    ``breaker_open`` gauge, restores emit ``ladder_restored``.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *, fail_threshold: int = 3, cooldown: int = 4,
                 probes: int = 1,
                 kinds: Tuple[str, ...] = BREAKER_KINDS):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        if probes < 1:
            raise ValueError("probes must be >= 1")
        self.fail_threshold = fail_threshold
        self.cooldown = cooldown
        self.probes = probes
        self.kinds = tuple(kinds)
        self._state: Dict[str, str] = {k: self.CLOSED for k in self.kinds}
        self._consec: Dict[str, int] = {k: 0 for k in self.kinds}
        self._cool: Dict[str, int] = {k: 0 for k in self.kinds}
        self._probe_ok: Dict[str, int] = {k: 0 for k in self.kinds}
        self.trips = 0
        self.restores = 0
        self._registry = None
        self._tracer = None
        self._service = "service"

    # ------------------------------ binding ------------------------------

    def bind(self, registry, tracer, service: str) -> "CircuitBreaker":
        self._registry = registry
        self._tracer = tracer
        self._service = service
        if registry is not None:
            for k in self.kinds:
                registry.gauge("breaker_open", service=service,
                               kind=k).set(0.0)
        return self

    # ------------------------------ queries ------------------------------

    def state(self, kind: str) -> str:
        return self._state.get(kind, self.CLOSED)

    def allow_delta(self, kind: str) -> bool:
        """May this collect use its cached prior (the delta path)?

        Open breakers deny and count down the cooldown; the consult that
        exhausts it transitions to half-open and is allowed through as
        the probe."""
        st = self._state.get(kind)
        if st is None or st == self.CLOSED or st == self.HALF_OPEN:
            return True
        self._cool[kind] -= 1
        if self._cool[kind] > 0:
            return False
        self._state[kind] = self.HALF_OPEN
        self._probe_ok[kind] = 0
        return True

    # ----------------------------- reporting -----------------------------

    def record_failure(self, kind: str) -> None:
        """A collect raised while a usable prior was in play."""
        st = self._state.get(kind)
        if st == self.CLOSED:
            self._consec[kind] += 1
            if self._consec[kind] >= self.fail_threshold:
                self._trip(kind, probe_failed=False)
        elif st == self.HALF_OPEN:
            self._trip(kind, probe_failed=True)
        # open: the delta path never ran; the failure belongs to the
        # full path and says nothing about this breaker

    def record_success(self, kind: str) -> None:
        """A delta collect completed successfully."""
        st = self._state.get(kind)
        if st == self.CLOSED:
            self._consec[kind] = 0
        elif st == self.HALF_OPEN:
            self._probe_ok[kind] += 1
            if self._probe_ok[kind] >= self.probes:
                self._restore(kind)

    # ---------------------------- transitions ----------------------------

    def _trip(self, kind: str, *, probe_failed: bool) -> None:
        self._state[kind] = self.OPEN
        self._cool[kind] = self.cooldown
        self._consec[kind] = 0
        self.trips += 1
        if self._registry is not None:
            self._registry.gauge("breaker_open", service=self._service,
                                 kind=kind).set(1.0)
            self._registry.counter("breaker_trips", service=self._service,
                                   kind=kind).inc()
        if self._tracer is not None:
            with self._tracer.span("ladder_pinned", service=self._service,
                                   kind=kind) as sp:
                sp.set(failures=self.fail_threshold,
                       cooldown=self.cooldown,
                       probe_failed=bool(probe_failed))

    def _restore(self, kind: str) -> None:
        self._state[kind] = self.CLOSED
        self._consec[kind] = 0
        self.restores += 1
        if self._registry is not None:
            self._registry.gauge("breaker_open", service=self._service,
                                 kind=kind).set(0.0)
        if self._tracer is not None:
            with self._tracer.span("ladder_restored", service=self._service,
                                   kind=kind) as sp:
                sp.set(probes=self.probes)

    # ------------------------------- export ------------------------------

    def snapshot(self) -> dict:
        return {"states": dict(self._state), "trips": self.trips,
                "restores": self.restores,
                "consecutive_failures": dict(self._consec)}

    def __repr__(self):
        states = ", ".join(f"{k}={v}" for k, v in self._state.items())
        return (f"CircuitBreaker({states}, trips={self.trips}, "
                f"restores={self.restores})")
