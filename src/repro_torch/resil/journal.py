"""Crash-consistent op journal (WAL) with segment rotation + compaction
(port of ``repro.resil.journal``).

The on-disk format is the reference's record for record, and the
compaction snapshot is the reference's checkpoint layout leaf for leaf
(``repro_torch.checkpoint``), so either package recovers a directory the
other wrote.  The one torch-specific step is the snapshot restore: the
reference builds its pytree skeleton from ``make_graph(1, 1)``; the port
reads the six ``GraphState`` leaves' shapes and dtypes from the manifest
and places them on the device the caller names.

The scheduler's op log is in-memory only: a process crash loses every
uncommitted op, and — worse — leaves no record of *which* batches made it
into the ring.  :class:`OpJournal` is the durable twin: an append-only
JSONL file the :class:`~repro_torch.engine.scheduler.StreamScheduler` writes

  * one ``op`` record per ``submit()`` (write-ahead: the intent is on
    disk before the op enters the in-memory log), and
  * one ``commit`` barrier per committed batch, written only AFTER the
    ring append succeeded — the barrier is the durability point.

Because the scheduler always commits a *prefix* of its log (strict-order
cuts included), a barrier needs only the raw op count of its chunk; the
journal therefore replays into exactly the batch boundaries the original
process cut, and :func:`recover` rebuilds a service whose ring latest is
**bit-identical** (``apply_ops`` is deterministic) with the un-barriered
tail ops back in the pending log.  Batch commits are atomic against
recovery: a crash anywhere between the first op of a batch and its
barrier yields a recovered ring WITHOUT that batch and a pending log
WITH it — all-or-nothing, never a torn prefix.

A torn final line (the classic crash-mid-write) is tolerated: JSONL is
self-synchronizing at newlines, so recovery parses up to the last
complete record and treats the fragment as never written.  Torn or
unparsable *interior* lines mean real corruption and raise
:class:`JournalError` — silently skipping history would un-order the
stream.

**Segment rotation** bounds any single file: with ``segment_bytes`` set,
the active file is sealed as ``<path>.NNNNNN`` once it crosses the
threshold — only ever at a barrier boundary with no un-barriered ops
outstanding, so every sealed segment ends with a ``commit`` record
covering all its ops and is replayable in isolation.  Readers
concatenate sealed segments (in index order) with the active file; only
the very last file may end in a torn line.

**Snapshot compaction** bounds the whole log: :meth:`OpJournal.compact`
writes the ring's latest committed state through the checkpoint store's
manifest-last atomic protocol into ``<path>.ckpt`` — the double-collect
validated snapshot *is* the truncation barrier — then deletes every
sealed segment whose last commit version the snapshot covers.  The
ordering is crash-safe: the snapshot is durable (manifest renamed)
before any segment is unlinked, and a crash mid-compaction merely
leaves covered segments behind for the next compaction (recovery skips
their batches by version).  :func:`recover` then becomes
snapshot-restore + replay-of-tail: O(tail), not O(history).
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .faults import P_JOURNAL_BARRIER, P_JOURNAL_TORN, InjectedCrash, \
    active_plan, inject

__all__ = ["JOURNAL_SCHEMA", "JournalError", "OpJournal", "read_journal",
           "read_journal_versions", "recover", "segment_files",
           "snapshot_dir"]

#: bump when the record layout changes; readers reject unknown majors.
JOURNAL_SCHEMA = 1

_SEG_RE = re.compile(r"\.(\d{6})$")


def snapshot_dir(path: str) -> str:
    """Where :meth:`OpJournal.compact` puts the truncation snapshot."""
    return str(path) + ".ckpt"


def segment_files(path: str) -> List[Tuple[int, str]]:
    """Sealed segments of ``path``, as sorted ``(index, filepath)``."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    out = []
    if not os.path.isdir(d):
        return out
    for name in os.listdir(d):
        if name.startswith(base + "."):
            m = _SEG_RE.search(name[len(base):])
            if m:
                out.append((int(m.group(1)), os.path.join(d, name)))
    return sorted(out)


class JournalError(RuntimeError):
    """Unrecoverable journal corruption (torn interior line, bad schema,
    barrier counting more ops than were journaled, replay gap)."""


class OpJournal:
    """Append-only JSONL WAL: ``meta`` header, ``op`` records, ``commit``
    barriers.  ``sync=True`` fsyncs every barrier (durability against OS
    crash, not just process crash) at the obvious latency cost.
    ``segment_bytes`` enables rotation: once the active file crosses the
    threshold it is sealed as a numbered segment at the next barrier
    boundary with no un-barriered ops outstanding."""

    def __init__(self, path: str, *, meta: Optional[dict] = None,
                 sync: bool = False, segment_bytes: Optional[int] = None):
        self.path = str(path)
        self.sync = sync
        self.segment_bytes = segment_bytes
        self.meta = dict(meta or {})
        self.ops_logged = 0
        self.barriers_logged = 0
        self.ops_barriered = 0
        self.rotations = 0
        self.compactions = 0
        self.segments_dropped = 0
        segs = segment_files(self.path)
        self._seg_idx = (segs[-1][0] + 1) if segs else 0
        fresh = not (os.path.exists(self.path)
                     and os.path.getsize(self.path) > 0)
        self._f = open(self.path, "a")
        # conservatively assume a reopened non-empty active file holds
        # history worth sealing at the next rotation opportunity
        self._commits_in_active = 0 if fresh else 1
        if fresh:
            self._write({"t": "meta", "schema": JOURNAL_SCHEMA, **self.meta})

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())

    def append_op(self, seq: int, op: Sequence) -> None:
        """Write-ahead one ``(kind, u[, v[, w]])`` request."""
        self._write({"t": "op", "seq": int(seq), "op": list(op)})
        self.ops_logged += 1

    def commit_barrier(self, version: int, n_ops: int) -> None:
        """Durability point of one committed batch of ``n_ops`` raw ops.

        Carries two injected crash points: ``journal.barrier`` (die with
        the barrier unwritten — the batch must roll back on recovery) and
        ``journal.torn`` (die mid-write, half a record on disk — recovery
        must shrug the fragment off)."""
        inject(P_JOURNAL_BARRIER)
        line = json.dumps({"t": "commit", "version": int(version),
                           "ops": int(n_ops)})
        plan = active_plan()
        if plan is not None and plan.check(P_JOURNAL_TORN):
            self._f.write(line[:max(1, len(line) // 2)])
            self._f.flush()
            raise InjectedCrash(P_JOURNAL_TORN,
                                plan.hits[P_JOURNAL_TORN] - 1)
        self._f.write(line + "\n")
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        self.barriers_logged += 1
        self.ops_barriered += int(n_ops)
        self._commits_in_active += 1
        self._maybe_rotate()

    @property
    def depth(self) -> int:
        """Ops written ahead but not yet covered by a commit barrier — the
        replay exposure if the process died right now (the ``journal_depth``
        gauge on the OpenMetrics exposition)."""
        return max(0, self.ops_logged - self.ops_barriered)

    # ---------------------------- rotation ----------------------------

    def _maybe_rotate(self) -> None:
        if self.segment_bytes is None or self.depth != 0:
            return
        try:
            size = self._f.tell()
        except ValueError:          # closed file; nothing to rotate
            return
        if size >= self.segment_bytes:
            self.rotate()

    def rotate(self) -> bool:
        """Seal the active file as the next numbered segment and start a
        fresh one (with its own ``meta`` header).  Only legal — and only
        attempted — when every logged op is barrier-covered, so sealed
        segments are always replayable in isolation.  Returns False when
        there is nothing to seal (no commits in the active file)."""
        if self.depth != 0:
            raise JournalError(
                f"{self.path}: cannot rotate with {self.depth} "
                f"un-barriered ops outstanding")
        if self._commits_in_active == 0:
            return False
        self._f.close()
        seg = f"{self.path}.{self._seg_idx:06d}"
        os.replace(self.path, seg)
        self._seg_idx += 1
        self.rotations += 1
        self._f = open(self.path, "a")
        self._commits_in_active = 0
        self._write({"t": "meta", "schema": JOURNAL_SCHEMA,
                     "segment": self._seg_idx - 1, **self.meta})
        return True

    # --------------------------- compaction ---------------------------

    def compact(self, state, version: int, *,
                extra: Optional[dict] = None) -> dict:
        """Snapshot ``state`` (the ring latest at ``version``) and drop
        every sealed segment the snapshot covers.

        The snapshot goes through the checkpoint store's manifest-last
        atomic rename — it is durable *before* any segment is unlinked,
        so a crash at any point leaves a recoverable journal (at worst
        with covered-but-undeleted segments, reclaimed next compaction).
        ``extra`` rides the manifest verbatim (e.g. learned thresholds,
        the op ledger) and is handed back to :func:`recover`.  Returns a
        report dict for telemetry/benchmarks."""
        from repro_torch.checkpoint import save_checkpoint
        version = int(version)
        ckpt = snapshot_dir(self.path)
        if self.depth == 0:
            self.rotate()       # seal covered history so it can be dropped
        save_checkpoint(ckpt, version, state, version=version, extra=extra)
        # GC superseded snapshot steps (the new manifest + index are
        # already committed, so older steps are dead weight)
        for name in os.listdir(ckpt):
            if name.startswith("step_") and int(name.split("_")[1]) != version:
                d = os.path.join(ckpt, name)
                for fn in os.listdir(d):
                    os.remove(os.path.join(d, fn))
                os.rmdir(d)
        dropped = kept = 0
        for _idx, seg in segment_files(self.path):
            last = _segment_last_version(seg)
            if last is not None and last <= version:
                os.remove(seg)
                dropped += 1
            else:
                kept += 1
        self.compactions += 1
        self.segments_dropped += dropped
        step_dir = os.path.join(ckpt, f"step_{version:08d}")
        snap_bytes = sum(os.path.getsize(os.path.join(step_dir, fn))
                         for fn in os.listdir(step_dir))
        return {"version": version, "snapshot_bytes": int(snap_bytes),
                "segments_dropped": dropped, "segments_kept": kept,
                "snapshot_dir": ckpt}

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _segment_last_version(seg_path: str) -> Optional[int]:
    """Highest commit version in a sealed segment (None: no commits —
    which a rotation never produces, so treat as not-coverable)."""
    last = None
    with open(seg_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue        # corruption surfaces loudly at read time
            if rec.get("t") == "commit":
                last = int(rec["version"])
    return last


def _parse_lines(path: str, lines: List[str], *, meta: Dict,
                 pending: List[tuple], batches: List[Tuple[int, List[tuple]]],
                 tolerate_torn_final: bool) -> None:
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            if tolerate_torn_final and i == len(lines) - 1:
                break  # torn final line despite its newline: ignore
            raise JournalError(f"{path}:{i + 1}: torn interior record: {e}")
        t = rec.get("t")
        if t == "meta":
            if rec.get("schema") != JOURNAL_SCHEMA:
                raise JournalError(
                    f"{path}: schema {rec.get('schema')} != {JOURNAL_SCHEMA}")
            if not meta:        # first header wins; later segments repeat it
                meta.update({k: v for k, v in rec.items()
                             if k not in ("t", "schema", "segment")})
        elif t == "op":
            pending.append(tuple(rec["op"]))
        elif t == "commit":
            n = int(rec["ops"])
            if n > len(pending):
                raise JournalError(
                    f"{path}:{i + 1}: barrier covers {n} ops but only "
                    f"{len(pending)} are journaled")
            batches.append((int(rec["version"]), pending[:n]))
            del pending[:n]
        else:
            raise JournalError(f"{path}:{i + 1}: unknown record type {t!r}")


def read_journal_versions(
        path: str) -> Tuple[Dict, List[Tuple[int, List[tuple]]], List[tuple]]:
    """Parse a (possibly rotated) journal into
    ``(meta, [(version, batch), ...], pending_ops)``.

    Sealed segments are read in index order, then the active file.  A
    torn FINAL line of the LAST file is treated as never written; torn
    interior lines (any file) raise :class:`JournalError`.  Each batch is
    the exact raw (pre-coalesce) chunk its barrier covered, tagged with
    the ring version that barrier committed.
    """
    files = [seg for _idx, seg in segment_files(path)]
    if os.path.exists(path):
        files.append(path)
    if not files:
        raise FileNotFoundError(path)
    meta: Dict = {}
    pending: List[tuple] = []
    batches: List[Tuple[int, List[tuple]]] = []
    for fi, fpath in enumerate(files):
        with open(fpath) as f:
            raw = f.read()
        lines = raw.split("\n")
        # a complete file ends with "\n" -> last split element is ""; any
        # trailing fragment is a torn final record, dropped (last file only)
        is_last = fi == len(files) - 1
        if lines and lines[-1] != "":
            if not is_last:
                raise JournalError(
                    f"{fpath}: sealed segment ends in a torn record")
            lines = lines[:-1]
        lines = [ln for ln in lines if ln]
        _parse_lines(fpath, lines, meta=meta, pending=pending,
                     batches=batches, tolerate_torn_final=is_last)
    return meta, batches, pending


def read_journal(path: str) -> Tuple[Dict, List[List[tuple]], List[tuple]]:
    """Parse a journal into ``(meta, committed_batches, pending_ops)``.

    Compatibility wrapper over :func:`read_journal_versions` (which also
    reports each batch's committed ring version).
    """
    meta, vbatches, pending = read_journal_versions(path)
    return meta, [chunk for _v, chunk in vbatches], pending


def _restore_snapshot(ckpt_dir: str, step: int, device):
    """Load the compaction snapshot onto ``device``: ``(GraphState,
    version, extra)``.  Leaf shapes and dtypes come from the manifest, so
    the snapshot dictates capacity."""
    from repro_torch.checkpoint import read_manifest, restore_checkpoint
    from repro_torch.checkpoint.checkpointer import like_from_manifest
    from repro_torch.core.graph_state import GraphState

    manifest = read_manifest(ckpt_dir, step)
    state = restore_checkpoint(
        ckpt_dir, step, like_from_manifest(GraphState, manifest),
        device=device)
    return state, int(manifest["version"]), manifest.get("extra") or {}


def _rebase(svc, version: int, extra: dict) -> None:
    """Rewrite the fresh service's ring base entry to the snapshot
    version and seed the scheduler ledger, so invariants
    (``ring.latest.version == batches_committed``,
    ``ops_submitted == ops_committed + pending``) hold across the elided
    history.  Learned thresholds riding the snapshot are restored too."""
    ring = svc.ring
    ring._window[0] = ring._window[0]._replace(version=int(version))
    ss = svc.scheduler.stats
    ss.batches_committed += int(version)
    n = int(extra.get("ops_committed", 0))
    ss.ops_submitted += n
    ss.ops_committed += n
    adaptive = getattr(svc, "adaptive", None)
    thr = extra.get("adaptive_thresholds")
    if adaptive is not None and thr:
        adaptive.restore(thr)


def recover(path: str, initial_state=None, *, make_service=None,
            device="cuda", **service_kwargs):
    """Rebuild a service from a journal: bit-identical ring latest.

    With a compaction snapshot present (``<path>.ckpt``), recovery is
    snapshot-restore + replay-of-tail: the validated snapshot seeds the
    ring (rebased to the snapshot version), only batches committed after
    it replay, and ``initial_state`` may be omitted entirely.  Without a
    snapshot, ``initial_state`` must be the same :class:`GraphState` the
    journaled service started from and the full history replays.

    ``service_kwargs`` must reproduce the scheduler configuration
    (``batch_size`` / ``strict_order`` / ``coalesce``) — recovery
    cross-checks them against the journal's ``meta`` header when the
    writer recorded them.  Committed batches re-commit through the same
    scheduler pipeline (identical coalescing, identical ring versions),
    with a version-continuity check so a missing segment fails loudly;
    un-barriered tail ops land back in the pending log, uncommitted.

    ``device`` names where the snapshot is restored (default ``"cuda"``;
    without CUDA that default raises, as every constructor of the port
    does); an ``initial_state`` must already live there.

    ``make_service`` builds the service from ``(state, **service_kwargs)``.
    Pass
    ``journal=OpJournal(new_path)`` in ``service_kwargs`` to resume
    journaling: the tail replay is re-logged, and when recovery started
    from a snapshot the restored base is immediately re-compacted into
    the new journal so the new WAL is self-contained.
    """
    from repro_torch.core.graph_state import resolve_device

    dev = resolve_device(device)
    if initial_state is not None and initial_state.device.type != dev.type:
        raise ValueError(f"initial_state lives on {initial_state.device}, "
                         f"recovery was asked for {dev}")
    if make_service is None:
        from repro_torch.engine import GraphService as make_service
    meta, vbatches, pending = read_journal_versions(path)
    snap_state = None
    snap_version = 0
    snap_extra: dict = {}
    ckpt = snapshot_dir(path)
    if os.path.isdir(ckpt):
        from repro_torch.checkpoint import latest_step
        step = latest_step(ckpt)
        if step is not None:
            snap_state, snap_version, snap_extra = _restore_snapshot(
                ckpt, step, dev)
    base = snap_state if snap_state is not None else initial_state
    if base is None:
        raise JournalError(
            f"{path}: no compaction snapshot and no initial_state given")
    svc = make_service(base, **service_kwargs)
    sched = svc.scheduler
    checks = [("batch_size", sched.batch_size),
              ("strict_order", sched.strict_order),
              ("coalesce", sched.coalesce)]
    if snap_state is None:
        # snapshot-restored capacities come from the manifest, which may
        # legitimately differ from the meta header's original caps
        checks = [("vcap", base.vcap), ("ecap", base.ecap)] + checks
    for key, got in checks:
        want = meta.get(key)
        if want is not None and want != got:
            raise JournalError(
                f"{path}: journal written with {key}={want}, recovering "
                f"with {key}={got}")
    if snap_state is not None:
        _rebase(svc, snap_version, snap_extra)
        new_j = getattr(sched, "journal", None)
        if new_j is not None:
            new_j.compact(svc.ring.latest.state, snap_version,
                          extra=snap_extra or None)
    for version, chunk in vbatches:
        if version <= snap_version:
            continue            # snapshot-covered (compaction raced a crash)
        want = int(svc.ring.latest.version) + 1
        if version != want:
            raise JournalError(
                f"{path}: replay gap: next batch is version {version}, "
                f"ring expects {want} (missing segment?)")
        sched.replay_commit(chunk)
    sched.replay_pending(pending)
    return svc


def journal_meta(initial_state, scheduler_kwargs: dict) -> dict:
    """The ``meta`` header a service should stamp: enough to cross-check
    a recovery's configuration."""
    return {"vcap": int(initial_state.vcap), "ecap": int(initial_state.ecap),
            **{k: scheduler_kwargs[k] for k in
               ("batch_size", "strict_order", "coalesce")
               if k in scheduler_kwargs}}
