"""Metrics registry: counters, gauges, and quantile histograms (port of
``repro.obs.metrics``, a near copy: the module is plain Python).

The engine's tally objects (``ServiceStats``, ``bc_scores_stats``,
``SchedulerStats``) are thin attribute shims over named :class:`Counter`
instruments in a :class:`MetricsRegistry` (see :class:`CounterStruct` /
:class:`ModeCounters`), so the numbers the tests read are also exportable
as one structured snapshot, and latency p50/p95/p99 come straight from
the :class:`Histogram` instruments the service feeds per query.

Instruments are keyed by ``(name, sorted(labels))``; asking for the same
key twice returns the same instrument.  Nothing here imports torch.

Thread-safety: instrument *creation* is serialized by a registry lock and
instrument *mutation* (``inc``/``set``/``observe``) by a shared module
lock.  The attribute shims' ``stats.field += k`` surface remains a
read-then-write pair: each shim's counters must stay owned by one thread;
cross-thread tallies should use plain ``inc``.
"""
from __future__ import annotations

import threading
from collections import deque
from collections.abc import MutableMapping
from typing import Dict, Iterable, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "CounterStruct",
    "ModeCounters", "LADDER_MODES",
]

#: the rungs of the unchanged -> delta -> full query ladder.
LADDER_MODES = ("unchanged", "delta", "full")

#: one lock for every instrument mutation: cheap (host bookkeeping only)
#: and makes ``inc``/``observe`` atomic across serving threads.
_MUT_LOCK = threading.Lock()


class Counter:
    """Monotonic tally.  ``inc`` is atomic under concurrent callers;
    ``set`` exists for the attribute shims (``stats.field += k`` reads
    then writes — single-owner-thread only) — use ``inc`` elsewhere."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def inc(self, n: int = 1) -> None:
        with _MUT_LOCK:
            self._value += n

    def set(self, v: int) -> None:
        self._value = int(v)

    def __repr__(self):
        return f"Counter({self.name}{dict(self.labels)}={self._value})"


class Gauge:
    """Last-write-wins scalar (ring depth, cache size, ...)."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def set(self, v: float) -> None:
        self._value = float(v)

    def __repr__(self):
        return f"Gauge({self.name}{dict(self.labels)}={self._value})"


class Histogram:
    """Sample reservoir with exact quantiles over the newest samples.

    Keeps up to ``max_samples`` most-recent observations (a bounded deque,
    so a long-lived service cannot grow without bound) plus exact running
    ``count``/``total``; quantiles are computed on demand by sorting the
    reservoir — the export path, not the hot path, pays.
    """

    __slots__ = ("name", "labels", "_samples", "count", "total")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 max_samples: int = 65536):
        self.name = name
        self.labels = labels
        self._samples: deque = deque(maxlen=max_samples)
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with _MUT_LOCK:
            self._samples.append(v)
            self.count += 1
            self.total += v

    @property
    def samples(self) -> list:
        with _MUT_LOCK:
            return list(self._samples)

    def quantile(self, q: float) -> float:
        return quantile(self.samples, q)

    def quantiles(self, qs: Iterable[float]) -> Dict[float, float]:
        s = sorted(self.samples)
        return {q: _q_sorted(s, q) for q in qs}

    def __repr__(self):
        return (f"Histogram({self.name}{dict(self.labels)} "
                f"count={self.count} p50={self.quantile(0.5):.1f})")


def _q_sorted(s: list, q: float) -> float:
    """Nearest-rank quantile over an already-sorted sample list."""
    if not s:
        return float("nan")
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


def quantile(samples: Iterable[float], q: float) -> float:
    return _q_sorted(sorted(samples), q)


class MetricsRegistry:
    """Get-or-create instrument store keyed by ``(name, labels)``."""

    def __init__(self):
        self._metrics: Dict[Tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, tuple(sorted(labels.items())))
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = cls(name, tuple(sorted(labels.items())), **kw)
                self._metrics[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def instruments(self) -> list:
        """Every registered instrument, in registration order (the
        exposition renderer groups them into OpenMetrics families)."""
        with self._lock:
            return list(self._metrics.values())

    def find(self, name: str, **label_filter) -> list:
        """Every instrument called ``name`` whose labels cover the filter."""
        out = []
        for inst in self.instruments():
            if inst.name != name:
                continue
            labels = dict(inst.labels)
            if all(labels.get(k) == v for k, v in label_filter.items()):
                out.append(inst)
        return out

    def merged_quantiles(self, name: str, qs: Iterable[float],
                         **label_filter) -> Dict[float, float]:
        """Quantiles over the pooled samples of every matching histogram
        (e.g. one latency distribution across all ladder modes)."""
        pooled: list = []
        for h in self.find(name, **label_filter):
            if isinstance(h, Histogram):
                pooled.extend(h.samples)
        pooled.sort()
        return {q: _q_sorted(pooled, q) for q in qs}

    def snapshot(self) -> list:
        """JSON-able dump of every instrument (histograms as summaries)."""
        out = []
        for inst in self.instruments():
            rec = {"name": inst.name, "labels": dict(inst.labels),
                   "kind": type(inst).__name__.lower()}
            if isinstance(inst, Histogram):
                qs = inst.quantiles((0.5, 0.95, 0.99))
                rec.update(count=inst.count, total=inst.total,
                           p50=qs[0.5], p95=qs[0.95], p99=qs[0.99])
            else:
                rec["value"] = inst.value
            out.append(rec)
        return out


class CounterStruct:
    """Attribute-named counter bundle: the deprecation-shim base that lets
    ``ServiceStats`` / ``RefreshStats`` / ``SchedulerStats`` keep their
    ``stats.field`` / ``stats.field += k`` surface while the values live
    in a :class:`MetricsRegistry` (their own private one when the owning
    service has no telemetry attached).

    Subclasses set ``_FIELDS`` (attribute names) and ``_PREFIX`` (metric
    name prefix); constructor labels land on every counter.
    """

    _FIELDS: Tuple[str, ...] = ()
    _PREFIX: str = ""

    def __init__(self, registry: Optional[MetricsRegistry] = None, **labels):
        reg = registry if registry is not None else MetricsRegistry()
        object.__setattr__(self, "registry", reg)
        object.__setattr__(self, "_counters", {
            f: reg.counter(self._PREFIX + f, **labels) for f in self._FIELDS})

    def __getattr__(self, name):
        # only reached when normal lookup fails -> counter fields
        counters = object.__getattribute__(self, "_counters")
        if name in counters:
            return counters[name].value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._FIELDS:
            self._counters[name].set(value)
        else:
            object.__setattr__(self, name, value)

    def as_dict(self) -> Dict[str, int]:
        return {f: c.value for f, c in self._counters.items()}

    def __repr__(self):
        body = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"{type(self).__name__}({body})"


class ModeCounters(MutableMapping):
    """Dict-shaped shim over per-mode counters (``bc_scores_stats``):
    supports exactly the ``d[mode]`` / ``d[mode] += 1`` surface of the
    plain dict it replaces, backed by labelled registry counters."""

    def __init__(self, registry: MetricsRegistry, name: str,
                 modes: Tuple[str, ...] = LADDER_MODES, **labels):
        self._counters = {m: registry.counter(name, mode=m, **labels)
                          for m in modes}

    def __getitem__(self, mode):
        return self._counters[mode].value

    def __setitem__(self, mode, value):
        self._counters[mode].set(value)

    def __delitem__(self, mode):
        raise TypeError("ModeCounters keys are fixed")

    def __iter__(self):
        return iter(self._counters)

    def __len__(self):
        return len(self._counters)

    def __repr__(self):
        return f"ModeCounters({dict(self)})"
