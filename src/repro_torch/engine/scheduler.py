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

Commits are atomic: an exception inside ``_commit_chunk`` leaves the ring
and the pending log as before -- the popped chunk returns to the front of
the log.  Submits and commits serialize on one re-entrant lock; queries
never take it.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.updates import PUTE, PUTV, REME, REMV, apply_ops

from .version_ring import RingEntry, VersionRing

_VERTEX_OPS = (PUTV, REMV)
_EDGE_OPS = (PUTE, REME)


@dataclass
class SchedulerStats:
    """Op-log tallies (the reference's ``scheduler_*`` counter names)."""

    ops_submitted: int = 0
    ops_committed: int = 0
    ops_coalesced: int = 0
    batches_committed: int = 0
    strict_cuts: int = 0
    commit_failures: int = 0


@dataclass
class StreamScheduler:
    """Coalesce a stream of update requests into committed ``OpBatch``es."""

    ring: VersionRing
    batch_size: int = 32
    strict_order: bool = False
    coalesce: bool = False
    _log: List[Tuple] = field(default_factory=list)
    stats: SchedulerStats = field(default_factory=SchedulerStats)
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False)

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")

    # ------------------------------ intake -------------------------------

    def submit(self, op: Tuple) -> int:
        """Append one ``(kind, u[, v[, w]])`` request; returns its seq no."""
        if op[0] not in _VERTEX_OPS and op[0] not in _EDGE_OPS:
            raise ValueError(f"scheduler accepts mutations only, got {op!r}")
        with self._lock:
            seq = self.stats.ops_submitted
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
        ops = self._coalesce_chunk(list(chunk))
        try:
            state, _ = apply_ops(self.ring.latest.state, ops,
                                 batch_size=self.batch_size)
            entry = self.ring.commit(state)
        except BaseException:
            # Atomic commit: the popped chunk returns to the FRONT of the
            # log, so a retry replays the identical prefix.
            self._log[:0] = chunk
            self.stats.commit_failures += 1
            raise
        self.stats.ops_committed += len(chunk)
        self.stats.batches_committed += 1
        return entry

    def _commit_ready(self) -> List[RingEntry]:
        """Commit every full batch currently in the log."""
        entries = []
        with self._lock:
            while len(self._log) >= self.batch_size:
                chunk = self._next_chunk(self.batch_size)
                if not chunk:
                    break
                entries.append(self._commit_chunk(chunk))
        return entries

    def commit_one(self) -> Optional[RingEntry]:
        """Commit a single batch (possibly partial); None when log is empty."""
        with self._lock:
            if not self._log:
                return None
            # A strict cut lands after >= 1 op, so the chunk is non-empty.
            return self._commit_chunk(self._next_chunk(self.batch_size))

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
