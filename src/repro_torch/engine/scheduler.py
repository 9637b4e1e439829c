"""Streaming update scheduler: an op-log coalesced into fixed-size batches
(port of ``repro.engine.scheduler``).

  * ``submit`` appends a request to the op-log and returns its sequence
    number -- the log is the total order of the stream;
  * full chunks of ``batch_size`` ops are committed through
    ``core.apply_ops`` (compact/grow on overflow) into the
    :class:`~repro_torch.engine.version_ring.VersionRing`; ``flush`` drains
    the partial tail (padded with NOPs).

Batches commit in log order.  Within a batch ``apply_batch`` linearizes
vertex ops before edge ops; ``strict_order=True`` cuts a batch early
whenever a vertex op follows an edge op, so the committed history equals
applying every op one at a time.  ``coalesce=True`` collapses consecutive
edge ops on one ``(u, v)`` key within a chunk to the last one (the
committed state is unchanged; interior return values are not observable).

Failure semantics: commits are atomic -- an exception anywhere inside
``_commit_chunk`` (``apply_ops``, the ring append, an injected fault at
``sched.apply_ops`` / ``sched.ring_commit`` / ``ring.evict``) leaves the
ring latest AND the pending log as before: the popped chunk returns to
the front of the log.  With a :class:`repro_torch.resil.OpJournal`
attached, every submit is write-ahead logged and every successful commit
writes a barrier; ``repro_torch.resil.journal.recover`` replays the file
into a bit-identical ring latest.  An optional
:class:`~repro_torch.runtime.fault_tolerance.HeartbeatMonitor` watches
commit latency: a commit slower than ``factor`` x the rolling median
counts in ``scheduler_stragglers`` and marks its trace span
``straggler=True``.

A commit runs in a ``commit`` span with the children ``commit.apply``
(``apply_ops``) and ``commit.ring`` (the ring append); a tracer's ``commit``
record counts the chunk's ops by kind (``putv``, ``remv``, ``pute``,
``reme``) from its host tuples.  The spans are trace records with
telemetry, ``torch.profiler`` ranges while the profiler records, with or
without it (``repro_torch.obs.trace``).

Submits and commits serialize on one re-entrant lock; queries never take
it.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.updates import PUTE, PUTV, REME, REMV, apply_ops
from repro_torch.obs import CounterStruct
from repro_torch.obs.trace import maybe_span
from repro_torch.resil.faults import P_SCHED_APPLY, P_SCHED_RING_COMMIT, inject

from .version_ring import RingEntry, VersionRing

_VERTEX_OPS = (PUTV, REMV)
_EDGE_OPS = (PUTE, REME)
#: a traced commit's record counts its chunk's ops of each kind
_OP_FIELDS = {PUTV: "putv", REMV: "remv", PUTE: "pute", REME: "reme"}


def _op_counts(ops) -> dict:
    """``{putv, remv, pute, reme}``: the ops of each kind among the host
    tuples ``ops`` (NOPs and unknown kinds are not counted)."""
    counts = dict.fromkeys(_OP_FIELDS.values(), 0)
    for op in ops:
        name = _OP_FIELDS.get(op[0])
        if name is not None:
            counts[name] += 1
    return counts


class SchedulerStats(CounterStruct):
    """Op-log tallies, as ``scheduler_*`` registry counters read and
    written as attributes (see :class:`repro_torch.obs.CounterStruct`)."""

    _FIELDS = ("ops_submitted", "ops_committed", "ops_coalesced",
               "batches_committed", "strict_cuts", "commit_failures",
               "stragglers", "compacts", "compact_failures")
    _PREFIX = "scheduler_"


@dataclass
class StreamScheduler:
    """Coalesce a stream of update requests into committed ``OpBatch``es."""

    ring: VersionRing
    batch_size: int = 32
    strict_order: bool = False
    coalesce: bool = False
    telemetry: object = None  # Optional[repro_torch.obs.Telemetry]
    journal: object = None    # Optional[repro_torch.resil.OpJournal]
    monitor: object = None    # Optional[HeartbeatMonitor]
    compact_every: Optional[int] = None  # journal.compact cadence (batches)
    compact_extra: object = None  # Optional[Callable[[], dict]] manifest extra
    _log: List[Tuple] = field(default_factory=list)
    stats: SchedulerStats = None
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False)

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.stats is None:
            registry = (self.telemetry.registry
                        if self.telemetry is not None else None)
            self.stats = SchedulerStats(registry)

    # ------------------------------ intake -------------------------------

    def submit(self, op: Tuple) -> int:
        """Append one ``(kind, u[, v[, w]])`` request; returns its seq no.

        With a journal attached the op is write-ahead logged before it
        enters the in-memory log: an acknowledged submit survives a
        crash (as a pending op) even if its batch never committed.
        """
        if op[0] not in _VERTEX_OPS and op[0] not in _EDGE_OPS:
            raise ValueError(f"scheduler accepts mutations only, got {op!r}")
        with self._lock:
            seq = self.stats.ops_submitted
            if self.journal is not None:
                self.journal.append_op(seq, op)
            self._log.append(op)
            self.stats.ops_submitted += 1
            self._commit_ready()
            return seq

    def submit_many(self, ops: Sequence[Tuple]) -> List[int]:
        return [self.submit(op) for op in ops]

    def pending(self) -> int:
        with self._lock:
            return len(self._log)

    # ------------------------------ commits ------------------------------

    def _next_chunk(self, limit: Optional[int]) -> List[Tuple]:
        """Pop the next committable chunk (respecting strict-order cuts)."""
        take = len(self._log) if limit is None else min(limit, len(self._log))
        if self.strict_order:
            seen_edge = False
            for i, op in enumerate(self._log[:take]):
                if op[0] in _EDGE_OPS:
                    seen_edge = True
                elif seen_edge:  # vertex op after an edge op: cut here
                    self.stats.strict_cuts += 1
                    take = i
                    break
        chunk, self._log = self._log[:take], self._log[take:]
        return chunk

    def _coalesce_chunk(self, chunk: List[Tuple]) -> List[Tuple]:
        out: List[Tuple] = []
        for op in chunk:
            if (self.coalesce and out
                    and op[0] in _EDGE_OPS and out[-1][0] in _EDGE_OPS
                    and op[1] == out[-1][1] and op[2] == out[-1][2]):
                out[-1] = op
                self.stats.ops_coalesced += 1
            else:
                out.append(op)
        return out

    def _commit_chunk(self, chunk: List[Tuple]) -> RingEntry:
        n_raw = len(chunk)
        ops = self._coalesce_chunk(list(chunk))
        tracer = self.telemetry.tracer if self.telemetry is not None else None
        mon = self.monitor
        stragglers0 = mon.stragglers if mon is not None else 0
        try:
            with maybe_span(tracer, "commit", batch_ops=n_raw,
                            coalesced=n_raw - len(ops)) as sp:
                if sp.id is not None:   # a tracer's span: no device read
                    sp.set(**_op_counts(chunk))
                if mon is not None:
                    mon.start()
                with maybe_span(tracer, "commit.apply"):
                    inject(P_SCHED_APPLY)
                    state, _ = apply_ops(self.ring.latest.state, ops,
                                         batch_size=self.batch_size)
                with maybe_span(tracer, "commit.ring"):
                    inject(P_SCHED_RING_COMMIT)
                    entry = self.ring.commit(state)
                if mon is not None:
                    mon.stop(entry.version)
                    if mon.stragglers > stragglers0:
                        self.stats.stragglers += 1
                        sp.set(straggler=True)
                sp.set(version=entry.version)
        except BaseException:
            # Atomic commit: a failure (incl. an injected crash) leaves
            # the ring latest and the pending log exactly as before —
            # the popped chunk returns to the FRONT of the log, so a
            # retry replays the identical prefix in submission order.
            self._log[:0] = chunk
            self.stats.commit_failures += 1
            raise
        if self.journal is not None:
            # barrier AFTER the ring append: the journal's durability
            # point; a crash in between rolls the batch back on recovery
            self.journal.commit_barrier(entry.version, n_raw)
        self.stats.ops_committed += n_raw
        self.stats.batches_committed += 1
        if (self.journal is not None and self.compact_every
                and self.stats.batches_committed % self.compact_every == 0):
            self._auto_compact(entry)
        return entry

    def _auto_compact(self, entry: RingEntry) -> None:
        """Best-effort journal compaction after a commit: a failed
        snapshot must never fail the (already durable) commit."""
        try:
            extra = self.compact_extra() if self.compact_extra else None
            self.journal.compact(entry.state, entry.version, extra=extra)
            self.stats.compacts += 1
        except Exception:
            self.stats.compact_failures += 1

    def _commit_ready(self) -> List[RingEntry]:
        """Commit every full batch currently in the log."""
        entries = []
        with self._lock:
            while len(self._log) >= self.batch_size:
                chunk = self._next_chunk(self.batch_size)
                if not chunk:  # strict cut at 0 cannot happen, but guard
                    break
                entries.append(self._commit_chunk(chunk))
        return entries

    def commit_one(self) -> Optional[RingEntry]:
        """Commit a single batch (possibly partial); None when log is empty."""
        with self._lock:
            if not self._log:
                return None
            # A strict cut lands after >= 1 op, so the chunk is non-empty.
            chunk = self._next_chunk(self.batch_size)
            return self._commit_chunk(chunk)

    def flush(self) -> List[RingEntry]:
        """Drain the whole log in batch-size chunks (tail is NOP-padded)."""
        entries = []
        with self._lock:
            while self._log:
                entry = self.commit_one()
                if entry is None:
                    break
                entries.append(entry)
        return entries

    # ------------------------------ recovery ------------------------------

    def replay_commit(self, chunk: Sequence[Tuple]) -> RingEntry:
        """Journal recovery: re-commit exactly this raw chunk.

        Bypasses batching/strict-cut decisions — the chunk IS a decision
        the original process already made (one barrier's worth of ops) —
        but runs the same coalesce + apply + ring pipeline, so the
        committed state and version are bit-identical.  When this
        scheduler journals, the replayed ops are re-logged first so the
        new journal is itself recoverable.
        """
        ops = [tuple(op) for op in chunk]
        with self._lock:
            if self.journal is not None:
                for i, op in enumerate(ops):
                    self.journal.append_op(self.stats.ops_submitted + i, op)
            self.stats.ops_submitted += len(ops)
            return self._commit_chunk(ops)

    def replay_pending(self, ops: Sequence[Tuple]) -> None:
        """Journal recovery: restore un-barriered tail ops as pending.

        Unlike ``submit``, never auto-commits — the original process had
        not committed these ops, and recovery must reproduce its state,
        not improve on it."""
        with self._lock:
            for op in ops:
                op = tuple(op)
                if self.journal is not None:
                    self.journal.append_op(self.stats.ops_submitted, op)
                self._log.append(op)
                self.stats.ops_submitted += 1
