"""Fixed-depth MVCC version ring with per-commit dirty-vertex sets (port of
``repro.engine.version_ring``).

  * the last ``depth`` commits stay resident, so a reader can pin any of
    them and keep querying a stable snapshot while writers race ahead;
  * every commit records the **dirty-vertex set** it disturbed, derived
    from the ``ecnt``/``alive`` deltas (``core.updates.dirty_vertices``);
    ``dirty_between(a, b)`` ORs the per-commit sets into the exact region
    a delta query must re-examine.

Pinning: ``pin`` holds a version beyond ring rotation (the entry moves to a
side table instead of being evicted); the last ``release`` drops it.
Dirty-set history lives only in the ring window -- ``dirty_between``
returns ``None`` when the window no longer covers the span, which callers
treat as "fall back to full recompute".

Concurrency: every mutation and every read that feeds a decision runs
under one re-entrant lock.  Pins are refcounted, and a
:class:`PinnedSnapshot` releases exactly once however many threads call
``release()`` on it.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph_state import GraphState
from repro_torch.core.updates import dirty_vertices_padded
from repro_torch.resil.faults import P_RING_EVICT, inject


class RingEntry(NamedTuple):
    """One committed version: ring-assigned id, state, dirty set vs parent,
    and (on the card) an event recorded on the committing thread's stream
    once the state and the dirty set were enqueued, which a reader on
    another stream waits for (``ready_events``)."""

    version: int
    state: GraphState
    dirty: torch.Tensor  # bool[vcap] -- vertices disturbed by THIS commit
    ready: Optional[torch.cuda.Event] = None


def stream_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event recorded on ``device``'s current stream (None off the
    card): a reader on another stream waits for it to see what this
    thread enqueued so far."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


@dataclass
class PinnedSnapshot:
    """A pin handle; use as a context manager or call ``release()``.

    ``release()`` is idempotent under concurrency: the first caller to
    flip ``_released`` (inside the ring lock) drops the refcount.
    """

    ring: "VersionRing"
    version: int
    _released: bool = False

    @property
    def state(self) -> GraphState:
        entry = self.ring.get_entry(self.version)
        if entry is None:
            raise RuntimeError(f"pinned version {self.version} vanished")
        return entry.state

    def release(self) -> None:
        self.ring._release_handle(self)

    def __enter__(self) -> "PinnedSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class VersionRing:
    """Ring of the last ``depth`` committed ``GraphState`` versions."""

    def __init__(self, initial_state: GraphState, depth: int = 8):
        if depth < 1:
            raise ValueError("ring depth must be >= 1")
        self.depth = depth
        first = RingEntry(
            version=0, state=initial_state,
            dirty=torch.zeros((initial_state.vcap,), dtype=torch.bool,
                              device=initial_state.device),
            ready=stream_event(initial_state.device))
        self._window: deque[RingEntry] = deque([first])
        self._pins: dict[int, int] = {}          # version -> pin count
        self._parked: dict[int, RingEntry] = {}  # pinned but rotated out
        self.evictions = 0
        self._lock = threading.RLock()

    # ------------------------------ commits ------------------------------

    @property
    def latest(self) -> RingEntry:
        with self._lock:
            return self._window[-1]

    @property
    def oldest_version(self) -> int:
        with self._lock:
            return self._window[0].version

    def commit(self, state: GraphState) -> RingEntry:
        """Append a new version; dirty set is derived vs the previous latest.

        The commit is atomic: the ``ring.evict`` fault point (an eviction
        racing an in-flight query) fires BEFORE the append, so a planned
        eviction failure leaves the ring exactly as it was.  The dirty-set
        derivation (device work) runs outside the lock; only the window
        rotation is serialized against pin/release.
        """
        with self._lock:
            if len(self._window) >= self.depth:
                inject(P_RING_EVICT)
            prev = self._window[-1]
        dirty = dirty_vertices_padded(prev.state, state)
        ready = stream_event(state.device)
        with self._lock:
            if self._window[-1].version != prev.version:
                raise RuntimeError(
                    "concurrent VersionRing.commit: commits must be "
                    "serialized by the scheduler")
            entry = RingEntry(version=prev.version + 1, state=state,
                              dirty=dirty, ready=ready)
            self._window.append(entry)
            while len(self._window) > self.depth:
                old = self._window.popleft()
                if self._pins.get(old.version, 0) > 0:
                    self._parked[old.version] = old
                else:
                    self.evictions += 1
            return entry

    # ------------------------------ reads --------------------------------

    def get_entry(self, version: int) -> Optional[RingEntry]:
        with self._lock:
            for e in self._window:
                if e.version == version:
                    return e
            return self._parked.get(version)

    def ready_events(self, version: int) -> list:
        """The commit events of every resident version up to ``version``:
        a stream that waits for them sees those states and dirty sets
        written, whichever thread's stream committed them."""
        with self._lock:
            entries = list(self._window) + list(self._parked.values())
        return [e.ready for e in entries
                if e.version <= version and e.ready is not None]

    def get(self, version: int) -> Optional[GraphState]:
        e = self.get_entry(version)
        return None if e is None else e.state

    def dirty_between(self, v_from: int,
                      v_to: int) -> Optional[torch.Tensor]:
        """OR of dirty sets over commits ``v_from+1 .. v_to`` (inclusive).

        ``None`` when the ring window no longer covers the whole span.
        ``v_from == v_to`` yields the all-False mask sized to that version's
        ``vcap`` (the version must still be resident).
        """
        if v_from > v_to:
            raise ValueError(f"dirty_between({v_from}, {v_to}): reversed span")
        with self._lock:
            if v_to > self._window[-1].version:
                return None
            if v_from == v_to:
                entry = self.get_entry(v_to)
                if entry is None:
                    return None
                return torch.zeros((entry.state.vcap,), dtype=torch.bool,
                                   device=entry.state.device)
            if v_from + 1 < self._window[0].version:
                return None  # span starts before window: dirty info evicted
            masks = [e.dirty for e in self._window
                     if v_from < e.version <= v_to]
        if len(masks) != v_to - v_from:
            return None
        vcap = masks[-1].shape[0]
        acc = torch.zeros((vcap,), dtype=torch.bool, device=masks[-1].device)
        for m in masks:
            acc[:m.shape[0]] |= m  # a vertex table grown inside the span
        return acc

    # ------------------------------ pinning ------------------------------

    def pin(self, version: Optional[int] = None) -> PinnedSnapshot:
        """Pin a resident version (default: latest) against eviction."""
        with self._lock:
            if version is None:
                version = self._window[-1].version
            if self.get_entry(version) is None:
                raise KeyError(
                    f"version {version} is not resident in the ring")
            self._pins[version] = self._pins.get(version, 0) + 1
            return PinnedSnapshot(self, version)

    def try_pin(self, version: Optional[int] = None
                ) -> Optional[PinnedSnapshot]:
        """Like :meth:`pin` but returns ``None`` for a non-resident version
        instead of raising -- the atomic form of check-then-pin."""
        with self._lock:
            try:
                return self.pin(version)
            except KeyError:
                return None

    def release(self, version: int) -> None:
        """Drop one pin on ``version``; extra releases are no-ops.  The
        parked entry is evicted only when the LAST pin goes."""
        with self._lock:
            count = self._pins.get(version, 0)
            if count <= 0:
                return
            if count == 1:
                self._pins.pop(version, None)
                if self._parked.pop(version, None) is not None:
                    self.evictions += 1
            else:
                self._pins[version] = count - 1

    def _release_handle(self, handle: PinnedSnapshot) -> None:
        with self._lock:
            if handle._released:
                return
            handle._released = True
            self.release(handle.version)

    def pinned_versions(self) -> list[int]:
        with self._lock:
            return sorted(self._pins)

    def pin_count(self, version: int) -> int:
        with self._lock:
            return self._pins.get(version, 0)
