"""Span-based tracing with JSONL export (port of ``repro.obs.trace``, a
near copy).

A :class:`Tracer` turns instrumented regions into flat trace records: each
``with tracer.span("query", kind="bfs") as sp`` emits one dict carrying the
span name, its wall time, an ``id``/``parent`` pair (nesting is tracked
through a :mod:`contextvars` variable, so spans opened anywhere down the
call stack — scheduler commits, tile refreshes, collect loops — attach to
the enclosing query span without threading a handle through every layer),
and whatever attributes the region set.  Records are kept in memory
(``tracer.records``, bounded) and, when a path is given, appended to a
JSONL file that ``python -m repro_torch.obs.report`` renders into the
per-kind/per-mode summary table.

:func:`annotate` is the deliberately tiny hook the engine internals use:
it sets attributes on the *current* span if one is active and costs one
contextvar read otherwise — so ``engine.incremental`` can report dirty
counts without knowing whether anyone is tracing.  :func:`child_span` is
its counterpart for regions: code that holds no tracer (``core.queries``'
level loops) opens a child of the current span, in that span's tracer.
:func:`host_read` runs one device-to-host read, counting it on the current
span.  ``Span.counts`` tallies the host reads and the child spans, by name,
that ran inside a span, its descendants' included (a closing span adds its
own to its parent's), so a record can report them.

Every span is also a ``torch.profiler.record_function`` range of the same
name while the profiler records, with or without a tracer, and every
``host_read`` a range named ``host_read``: a profiled slice then puts the
device's kernels and idle gaps down to the program's own phases.  Off the
profiler and without a tracer, a span site costs one contextvar read and
one boolean read, and allocates nothing.

Telemetry is best-effort by design: a failing JSONL sink (disk full,
rotated-away file, or the injected ``obs.sink`` fault) must never fail
the query it was observing.  ``_emit`` swallows sink ``OSError``s and
injected faults, keeps the in-memory record, and counts the loss in
``tracer.sink_errors``.

The sink itself is bounded (the WAL's bug class: an append-only file on
a long stream grows without limit): with ``max_bytes`` set, a write that
would cross the limit first rotates ``trace.jsonl`` → ``trace.jsonl.1``
(shifting older rotations up to ``keep``, dropping the oldest) and
reopens fresh — counted in ``tracer.rotations``.

Thread-safety: span *nesting* is already per-thread for free
(:mod:`contextvars` — each serving thread sees its own current-span
stack), but id assignment and record emission mutate shared tracer
state, so both run under a tracer lock; interleaved spans from the
dispatcher and the committer each come out as complete, well-parented
records.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from contextlib import contextmanager
from types import MappingProxyType
from typing import IO, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

from repro_torch.resil.faults import P_OBS_SINK, InjectedFault, inject

__all__ = ["TRACE_SCHEMA", "Span", "Tracer", "annotate", "child_span",
           "current_span", "host_read", "maybe_span"]

#: bump when the record layout changes; readers reject unknown majors.
#: The reference's layout, version 2: query spans carry device_us + flops.
TRACE_SCHEMA = 2

#: the name of a device-to-host read's profiler range and of its count
HOST_READ = "host_read"

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_span", default=None)


def current_span() -> Optional["Span"]:
    return _CURRENT.get()


def annotate(**attrs) -> None:
    """Attach attributes to the innermost active span (no-op untraced)."""
    sp = _CURRENT.get()
    if sp is not None:
        sp.set(**attrs)


def child_span(name: str):
    """A child of the current span, recorded by that span's tracer; a bare
    profiler range while profiling without one; else the null span."""
    sp = _CURRENT.get()
    if sp is not None:
        return sp.tracer.span(name)
    if _autograd_profiler._is_profiler_enabled:
        return _Range(name)
    return _NULL_SPAN


def host_read(read, *args):
    """``read(*args)``: one device-to-host read (``bool``, ``int``,
    ``Tensor.tolist``, a boolean-mask index, ...), counted on the current
    span and, while profiling, inside a ``host_read`` range.  Returns what
    ``read`` returns."""
    sp = _CURRENT.get()
    if sp is not None:
        sp.counts[HOST_READ] = sp.counts.get(HOST_READ, 0) + 1
    if _autograd_profiler._is_profiler_enabled:
        with record_function(HOST_READ):
            return read(*args)
    return read(*args)


class Span:
    """One open region; becomes a single trace record on exit.  ``counts``:
    the ``host_read`` calls and the child spans, by name, inside it, its
    descendants' included."""

    __slots__ = ("name", "id", "parent", "attrs", "t0", "wall_us", "tracer",
                 "counts")

    def __init__(self, name: str, span_id: int, parent: Optional[int],
                 attrs: dict, tracer: "Tracer"):
        self.name = name
        self.id = span_id
        self.parent = parent
        self.attrs = attrs
        self.tracer = tracer
        self.counts: dict = {}
        self.t0 = time.perf_counter()
        self.wall_us = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def setdefault(self, **attrs) -> None:
        for k, v in attrs.items():
            self.attrs.setdefault(k, v)


class Tracer:
    """Collects span records; optionally streams them to a JSONL file.

    ``max_records`` bounds the in-memory list (oldest dropped) so an
    always-on tracer cannot grow a long-lived service without bound; the
    JSONL sink, when given, sees every record regardless.
    """

    def __init__(self, path: Optional[str] = None, max_records: int = 100000,
                 max_bytes: Optional[int] = None, keep: int = 3):
        self.path = path
        self.max_records = max_records
        self.max_bytes = max_bytes
        self.keep = max(1, keep)
        self.records: list = []
        self.dropped = 0
        self.sink_errors = 0
        self.rotations = 0
        self._next_id = 0
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._sink: Optional[IO] = open(path, "a") if path else None
        self._sink_bytes = (os.path.getsize(path)
                            if path and os.path.exists(path) else 0)

    @contextmanager
    def span(self, name: str, **attrs):
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        sp = Span(name, span_id, getattr(_CURRENT.get(), "id", None), attrs,
                  self)
        token = _CURRENT.set(sp)
        rng = (record_function(name).__enter__()
               if _autograd_profiler._is_profiler_enabled else None)
        try:
            yield sp
        finally:
            if rng is not None:
                rng.__exit__(None, None, None)
            _CURRENT.reset(token)
            sp.wall_us = (time.perf_counter() - sp.t0) * 1e6
            outer = _CURRENT.get()
            if outer is not None:
                for key, n in sp.counts.items():
                    outer.counts[key] = outer.counts.get(key, 0) + n
                outer.counts[name] = outer.counts.get(name, 0) + 1
            self._emit(sp)

    def _emit(self, sp: Span) -> None:
        rec = {"schema": TRACE_SCHEMA, "span": sp.name, "id": sp.id,
               "parent": sp.parent,
               "t_s": round(sp.t0 - self._t0, 6),
               "wall_us": round(sp.wall_us, 1)}
        rec.update(sp.attrs)
        with self._lock:
            if len(self.records) >= self.max_records:
                self.records.pop(0)
                self.dropped += 1
            self.records.append(rec)
            if self._sink is None:
                return
            try:
                inject(P_OBS_SINK)
                line = json.dumps(rec) + "\n"
                if (self.max_bytes is not None and self._sink_bytes > 0
                        and self._sink_bytes + len(line) > self.max_bytes):
                    self._rotate()
                self._sink.write(line)
                self._sink.flush()
                self._sink_bytes += len(line)
            except (OSError, ValueError, InjectedFault):
                # Best-effort sink: losing a trace line must never fail
                # the observed operation.  The in-memory record survives.
                self.sink_errors += 1

    def _rotate(self) -> None:
        """Shift ``path`` → ``path.1`` → ... → ``path.keep`` (oldest
        dropped) and reopen fresh.  A failing rename is swallowed — the
        sink reopens on whatever file is there (possibly still the
        oversized one) and the caller's record is appended regardless, so
        a stuck filesystem degrades to an unrotated file, never to a
        dead or lossy trace stream."""
        self._sink.close()
        try:
            oldest = f"{self.path}.{self.keep}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
            self.rotations += 1
        except OSError:
            pass
        finally:
            self._sink = open(self.path, "a")
            self._sink_bytes = os.path.getsize(self.path)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def maybe_span(tracer: Optional[Tracer], name: str, **attrs):
    """``tracer.span`` when tracing; without a tracer a bare profiler range
    while profiling, else a reusable null span — so instrumented code
    writes one code path and pays a ``None`` check and a boolean read when
    telemetry and the profiler are off."""
    if tracer is not None:
        return tracer.span(name, **attrs)
    if _autograd_profiler._is_profiler_enabled:
        return _Range(name)
    return _NULL_SPAN


class _NullSpan:
    """The span of an untraced region, and its own context manager."""

    __slots__ = ()
    id = None
    wall_us = 0.0
    counts = MappingProxyType({})

    def set(self, **attrs) -> None:
        pass

    def setdefault(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Range:
    """A ``record_function`` range that yields the null span: a region's
    place on the profiler's timeline without a tracer."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        return _NULL_SPAN

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False
