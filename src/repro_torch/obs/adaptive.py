"""Self-tuning ``dirty_threshold`` (port of ``repro.obs.adaptive``, a near
copy: the controller is plain Python).

The unchanged → delta → full ladder pivots on a dirty-fraction threshold
that starts at a static per-kind guess (``0.25`` for BFS/SSSP).
The profitable delta-vs-full crossover is a *workload* property — it
moves with graph size, churn locality, and backend — and the service
already measures everything needed to find it: every query feeds a
``query_wall_us`` histogram labelled (service, kind, mode) and annotates
its observed dirty fraction.

:class:`AdaptiveThresholds` turns those observations into control:

  * **observe** — per successful query the service reports
    ``(kind, mode, wall_us, dirty_frac)``; full-mode walls land in a
    per-kind reservoir, delta-mode ``(frac, wall)`` pairs in another.
  * **probe** — a threshold that only ever shrinks would starve itself of
    full-mode samples (a healthy delta ladder answers almost everything
    cheaply).  Every ``probe_every``-th consult the controller returns a
    threshold of ``0.0``, demoting that one query to a full recompute —
    answers are bit-identical (the full path is the ladder's own oracle),
    only the cost moves, and the observed wall refreshes the full-cost
    estimate.
  * **fit** — with enough of both, model the delta cost as linear in the
    dirty fraction (least squares over the pair reservoir), take
    ``t_full`` as the median full wall, and solve ``a + b·f = t_full``
    for the crossover fraction ``f*``.
  * **adjust** — step the per-kind threshold toward ``f*`` by a damped
    ``alpha`` fraction per adjustment, clamped to ``[lo, hi]``; every
    adjustment emits a ``threshold_adjust`` span carrying the decision
    inputs (old/new, t_full, fit slope/intercept, crossover, sample
    counts) and updates the ``adaptive_dirty_threshold`` gauge +
    ``adaptive_adjustments`` counter, so the controller's behaviour is
    itself observable through the same trace/scrape surface it feeds on.

The controller is deliberately conservative: no samples → no movement
(the static default keeps ruling), a degenerate fit (non-positive slope:
delta not measurably dearer with dirtiness) → no movement, and clamps
bound the worst case — a bad fit can cost performance, never
correctness, because every rung returns the same answer.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

from .metrics import MetricsRegistry
from .trace import Tracer

__all__ = ["AdaptiveThresholds"]

#: query kinds the services run the ladder for.
LADDER_KINDS = ("bfs", "sssp", "bc")


class AdaptiveThresholds:
    """Per-kind ``dirty_threshold`` controller (see module docstring).

    ``base`` seeds the thresholds — one float for every kind, or a
    per-kind mapping (the services pass their static per-kind defaults:
    BC's profitable crossover sits an order of magnitude below
    BFS/SSSP's, see ``repro_torch.engine.service.DEFAULT_DIRTY_THRESHOLDS``);
    ``lo``/``hi`` clamp it — ``lo`` defaults low enough (0.005) that the
    controller can actually reach BC's few-percent crossover instead of
    being pinned above it; ``alpha`` damps each step toward the fitted
    crossover; ``period`` is the adjustment cadence in observations per
    kind; ``min_full``/``min_delta`` gate the fit on sample coverage;
    ``probe_every`` forces every Nth threshold consult to a full
    recompute (0 disables probing).  ``bind`` attaches the registry /
    tracer / service label — unbound controllers still tune, they just
    don't export.
    """

    def __init__(self, *, base=0.25, lo: float = 0.005,
                 hi: float = 0.75, alpha: float = 0.5, period: int = 16,
                 min_full: int = 2, min_delta: int = 6,
                 probe_every: int = 16, max_samples: int = 512,
                 kinds: Tuple[str, ...] = LADDER_KINDS):
        self.kinds = tuple(kinds)
        if isinstance(base, (int, float)):
            bases = {k: float(base) for k in self.kinds}
        else:
            bases = {k: float(base[k]) for k in self.kinds}
        for k, b in bases.items():
            if not (0.0 <= lo <= b <= hi <= 1.0):
                raise ValueError(f"need 0 <= lo <= base <= hi <= 1, got "
                                 f"{lo}/{b} ({k})/{hi}")
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.base, self.lo, self.hi, self.alpha = bases, lo, hi, alpha
        self.period, self.min_full, self.min_delta = period, min_full, \
            min_delta
        self.probe_every = probe_every
        self._thr: Dict[str, float] = dict(bases)
        self._full: Dict[str, deque] = {
            k: deque(maxlen=max_samples) for k in self.kinds}
        self._pairs: Dict[str, deque] = {
            k: deque(maxlen=max_samples) for k in self.kinds}
        self._since_adjust: Dict[str, int] = {k: 0 for k in self.kinds}
        self._consults: Dict[str, int] = {k: 0 for k in self.kinds}
        self.adjustments = 0
        self.probes = 0
        self._registry: Optional[MetricsRegistry] = None
        self._tracer: Optional[Tracer] = None
        self._service = "service"

    # ------------------------------ binding ------------------------------

    def bind(self, registry: Optional[MetricsRegistry],
             tracer: Optional[Tracer], service: str) -> "AdaptiveThresholds":
        self._registry = registry
        self._tracer = tracer
        self._service = service
        if registry is not None:
            for k in self.kinds:
                registry.gauge("adaptive_dirty_threshold",
                               service=service, kind=k).set(self._thr[k])
        return self

    # ------------------------------ consults -----------------------------

    def threshold(self, kind: str) -> float:
        """The dirty-fraction bound the ladder should use *now*.

        Every ``probe_every``-th consult per kind returns 0.0, demoting a
        would-be delta to a full recompute so the full-cost estimate
        stays fresh.  A probe that lands on a query the unchanged
        shortcut ends up answering anyway (the local ladder consults the
        threshold before the unchanged test) is a harmless no-op — the
        answer is the cached one either way.
        """
        if kind not in self._thr:
            return self.base.get(kind, 0.25)
        self._consults[kind] += 1
        if self.probe_every and self._consults[kind] % self.probe_every == 0:
            self.probes += 1
            return 0.0
        return self._thr[kind]

    def thresholds(self) -> Dict[str, float]:
        return dict(self._thr)

    def restore(self, thresholds: Dict[str, float]) -> "AdaptiveThresholds":
        """Adopt previously learned per-kind thresholds (e.g. off a
        compaction snapshot's manifest), clamped to ``[lo, hi]``; unknown
        kinds are ignored, missing kinds keep their current value.
        Bound gauges are refreshed so the scrape surface agrees."""
        for k, v in thresholds.items():
            if k not in self._thr:
                continue
            self._thr[k] = min(self.hi, max(self.lo, float(v)))
            if self._registry is not None:
                self._registry.gauge("adaptive_dirty_threshold",
                                     service=self._service,
                                     kind=k).set(self._thr[k])
        return self

    # ---------------------------- observations ---------------------------

    def observe(self, kind: str, mode: str, wall_us: float,
                dirty_frac: Optional[float]) -> None:
        """One successful query's outcome; may trigger an adjustment."""
        if kind not in self._thr:
            return
        if mode == "full":
            self._full[kind].append(float(wall_us))
        elif mode == "delta" and dirty_frac is not None:
            self._pairs[kind].append((float(dirty_frac), float(wall_us)))
        else:
            return  # unchanged replies say nothing about the crossover
        self._since_adjust[kind] += 1
        if self._since_adjust[kind] >= self.period:
            self._since_adjust[kind] = 0
            self._maybe_adjust(kind)

    # ------------------------------- control -----------------------------

    def _fit(self, kind: str):
        """(intercept, slope) of wall_us ~ dirty_frac over the delta pairs,
        or None when the pairs are degenerate (all one fraction)."""
        pairs = self._pairs[kind]
        n = len(pairs)
        sx = sum(f for f, _ in pairs)
        sy = sum(w for _, w in pairs)
        sxx = sum(f * f for f, _ in pairs)
        sxy = sum(f * w for f, w in pairs)
        denom = n * sxx - sx * sx
        if denom <= 0:
            return None
        b = (n * sxy - sx * sy) / denom
        a = (sy - b * sx) / n
        return a, b

    def _maybe_adjust(self, kind: str) -> None:
        n_full, n_delta = len(self._full[kind]), len(self._pairs[kind])
        if n_full < self.min_full or n_delta < self.min_delta:
            return
        fit = self._fit(kind)
        if fit is None:
            return
        a, b = fit
        if b <= 0:
            # delta not measurably dearer with dirtiness: the data gives
            # no crossover; leave the threshold where it is
            return
        full_sorted = sorted(self._full[kind])
        t_full = full_sorted[len(full_sorted) // 2]
        crossover = (t_full - a) / b
        target = min(self.hi, max(self.lo, crossover))
        old = self._thr[kind]
        new = min(self.hi, max(self.lo, old + self.alpha * (target - old)))
        if abs(new - old) < 1e-9:
            return
        self._thr[kind] = new
        self.adjustments += 1
        if self._registry is not None:
            self._registry.gauge("adaptive_dirty_threshold",
                                 service=self._service, kind=kind).set(new)
            self._registry.counter("adaptive_adjustments",
                                   service=self._service, kind=kind).inc()
        if self._tracer is not None:
            with self._tracer.span("threshold_adjust",
                                   service=self._service, kind=kind) as sp:
                sp.set(old=round(old, 6), new=round(new, 6),
                       t_full_us=round(t_full, 1),
                       fit_intercept_us=round(a, 1),
                       fit_slope_us=round(b, 1),
                       crossover=round(crossover, 6),
                       clamped=bool(crossover != target),
                       n_full=n_full, n_delta=n_delta)

    # ------------------------------- export ------------------------------

    def snapshot(self) -> dict:
        return {
            "thresholds": {k: round(v, 6) for k, v in self._thr.items()},
            "clamps": {"lo": self.lo, "hi": self.hi},
            "base": {k: round(v, 6) for k, v in self.base.items()},
            "adjustments": self.adjustments,
            "probes": self.probes,
            "samples": {k: {"full": len(self._full[k]),
                            "delta": len(self._pairs[k])}
                        for k in self.kinds},
        }

    def __repr__(self):
        thr = ", ".join(f"{k}={v:.3f}" for k, v in self._thr.items())
        return (f"AdaptiveThresholds({thr}, adjustments={self.adjustments}, "
                f"probes={self.probes})")
