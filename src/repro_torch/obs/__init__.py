"""Unified telemetry: metrics, tracing, cost accounting, and control
(port of ``repro.obs``).

  * :mod:`repro_torch.obs.metrics` -- counters / gauges / p50-p95-p99
    histograms in a :class:`MetricsRegistry`; the engine's tally objects
    (``ServiceStats``, ``bc_scores_stats``, ``SchedulerStats``) are
    attribute shims over it;
  * :mod:`repro_torch.obs.trace` -- span tracing with contextvar nesting
    and size-rotated JSONL export; every traced ``query()`` emits a record
    carrying kind / ring version / ladder mode / wall time / device time,
    with child spans for scheduler commits (``commit.apply``,
    ``commit.ring``), tile refreshes and each collect of the PG-Cn loop,
    and every ``bc_scores()`` a ``bc_scores`` record with its phases
    (plan, tile refresh, views, operands, forward and backward levels,
    reduce)
    and its device-to-host reads (``host_read``).  While
    ``torch.profiler`` records, each span is also a ``record_function``
    range of its name, with or without telemetry;
  * :mod:`repro_torch.obs.cost` -- per-signature cost accounting of the
    real call (peak and temporary bytes from the CUDA allocator),
    attributed to every query;
  * :mod:`repro_torch.obs.profile` -- per-collect device time from CUDA
    events on the launching thread's stream (the host clock for a CPU
    result), behind a null-object default; the ``collect`` span is its
    profiler range;
  * :mod:`repro_torch.obs.expo` -- OpenMetrics exposition of the registry,
    live (:meth:`Telemetry.serve`) or one-shot
    (``python -m repro_torch.obs.expo``);
  * :mod:`repro_torch.obs.adaptive` -- the :class:`AdaptiveThresholds`
    controller that tunes the ladder's per-kind ``dirty_threshold`` from
    the service's own latency / dirty-fraction observations;
  * :mod:`repro_torch.obs.report` -- ``python -m repro_torch.obs.report
    TRACE.jsonl`` renders the per-kind/per-mode summary table.

:class:`Telemetry` bundles the runtime pieces; pass one to a service
(``GraphService(..., telemetry=Telemetry.make())``) to turn the
instruments on.  Without one, services still tally their shim counters
(each shim owns a private registry) but trace and time nothing -- the
off path stays a single ``None`` check per query, and a span site inside
the engine a contextvar read and a boolean read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .adaptive import AdaptiveThresholds  # noqa: F401
from .cost import CostAccountant, account_call  # noqa: F401
from .metrics import (  # noqa: F401
    LADDER_MODES,
    Counter,
    CounterStruct,
    Gauge,
    Histogram,
    MetricsRegistry,
    ModeCounters,
    quantile,
)
from .profile import DeviceTimer, NullDeviceTimer, block_until_ready  # noqa: F401
from .trace import TRACE_SCHEMA, Span, Tracer, annotate, current_span, maybe_span  # noqa: F401


@dataclass
class Telemetry:
    """The bundle a service consumes: registry + tracer + accountant +
    device timer.

    ``block``: when True (default) a traced query waits for its result's
    device before the span closes, so the histogram / trace wall times are
    end-to-end latencies, not launch times.

    ``accountant``: on the card, each new query signature resets the
    process-wide CUDA peak-memory statistics (``repro_torch.obs.cost``).

    ``profiler``: the device-time attributor (``repro_torch.obs.profile``).
    The default :class:`DeviceTimer` brackets each collect with CUDA events
    (the host clock for a CPU state), so every query span carries
    ``device_us``; :class:`NullDeviceTimer` (``make(profile=False)``)
    reports 0.0 without synchronising.
    """

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: Tracer = field(default_factory=Tracer)
    accountant: Optional[CostAccountant] = field(
        default_factory=CostAccountant)
    block: bool = True
    profiler: object = field(default_factory=DeviceTimer)

    @classmethod
    def make(cls, trace_path: Optional[str] = None, *, block: bool = True,
             hlo: bool = True, profile: bool = True,
             trace_max_bytes: Optional[int] = None,
             trace_keep: int = 3) -> "Telemetry":
        """One-call construction: in-memory by default, JSONL-sinking when
        ``trace_path`` is given (size-rotated at ``trace_max_bytes``,
        keeping ``trace_keep`` rotated files).  ``hlo`` keeps the
        reference's keyword and switches the port's cost accounting
        (``repro_torch.obs.cost``: the first call of each query signature
        on the card runs between resets and reads of the allocator's
        process-wide peak statistics, so a telemetered service clobbers
        any other ``max_memory_allocated`` reading in its process);
        ``profile=False`` skips device-time attribution (no per-collect
        synchronisation)."""
        return cls(registry=MetricsRegistry(),
                   tracer=Tracer(path=trace_path, max_bytes=trace_max_bytes,
                                 keep=trace_keep),
                   accountant=CostAccountant() if hlo else None,
                   block=block,
                   profiler=DeviceTimer() if profile else NullDeviceTimer())

    def serve(self, port: int = 0, *, host: str = "127.0.0.1",
              journal=None):
        """Start the OpenMetrics scrape endpoint (``GET /metrics``) on a
        daemon thread; returns the :class:`repro_torch.obs.expo.ExpoServer`
        (``.url``, ``.port``, ``.close()``).  ``journal`` additionally
        exposes the WAL depth gauge."""
        from .expo import ExpoServer
        return ExpoServer(self, port=port, host=host, journal=journal)

    def exposition(self, journal=None) -> str:
        """The current OpenMetrics exposition text (what a scrape of
        :meth:`serve` returns right now)."""
        from .expo import telemetry_exposition
        return telemetry_exposition(self, journal=journal)

    def close(self) -> None:
        self.tracer.close()
