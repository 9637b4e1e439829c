"""GraphService: the streaming update/query front end over the engine
(port of ``repro.engine.service``).

  * updates enter through :class:`~repro_torch.engine.scheduler.StreamScheduler`
    (``submit``), which coalesces them into fixed-size batches and commits
    each batch as a new version in the
    :class:`~repro_torch.engine.version_ring.VersionRing`;
  * queries (``query``) are answered from the ring.  Per ``(kind, src)``
    the service caches the last answer with the ring version it was
    computed at; the next query ORs the per-commit dirty sets since that
    version and hands prior + dirty to ``engine.incremental`` -- most
    queries cost an *unchanged* check or a few delta passes.

Consistency modes (paper section 5, at batch granularity):

  * ``"icn"`` (PG-Icn): single collect against the latest snapshot;
  * ``"cn"`` (PG-Cn): double collect -- re-run the (incremental) query on
    consecutive ring versions until two answers ``cmp_tree``-match, while
    pending update batches keep committing between collects.

Options, all off by default and all the reference's:

  * ``telemetry=`` (:class:`repro_torch.obs.Telemetry`): a ``query`` span
    per query with ``collect`` / ``commit`` / ``tile_refresh`` children,
    a ``bc_scores`` span per ``bc_scores()`` with its phases as children
    (``bc_scores`` below), ``query_wall_us`` / ``query_device_us``
    histograms, per-signature cost accounting; ``device_us`` is
    CUDA-event stream time on the card (``repro_torch.obs.profile``).
    The spans are ``torch.profiler`` ranges too, with or without
    telemetry, while the profiler records;
  * ``adaptive=`` (:class:`repro_torch.obs.AdaptiveThresholds` or True):
    the ladder consults a self-tuned per-kind crossover (needs telemetry);
  * ``policy=`` (:class:`repro_torch.resil.ResiliencePolicy`): a raising
    collect walks the degrade ladder -- retry as a full recompute from a
    pinned snapshot, then serve the last cached answer at its
    still-resident version, flagged ``degraded=True`` with
    ``stale_version``.  A degraded answer is exact at the version it
    claims.  Without a policy, collect failures propagate, counted in
    ``stats.errors``;
  * ``breaker=`` (:class:`repro_torch.resil.CircuitBreaker` or True):
    consecutive delta-collect failures pin a kind's ladder at full until
    half-open probes succeed;
  * ``journal=`` (:class:`repro_torch.resil.OpJournal`), ``monitor=``
    (:class:`repro_torch.runtime.HeartbeatMonitor`) and ``compact_every=``
    reach the scheduler: write-ahead op log with commit barriers, commit
    straggler detection, periodic snapshot compaction.

The policy catches every ``Exception`` of a collect, as the reference's
does; a CUDA launch failure would be caught too, so a caller that injects
faults on the card holds ``stats.errors`` against the faults its
``FaultPlan`` fired.
"""
from __future__ import annotations

import math
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import queries
from repro_torch.core.graph_state import GraphState
from repro_torch.core.snapshot import ScanStats
from repro_torch.core.tiles import TileView, build_tile_view, \
    dense_views_from_tiles
from repro_torch.obs import AdaptiveThresholds, CounterStruct, ModeCounters, \
    Telemetry, block_until_ready
from repro_torch.obs.trace import HOST_READ, child_span, host_read, \
    maybe_span
from repro_torch.resil.faults import (
    P_CACHE_STORE,
    P_COLLECT_DELTA,
    P_COLLECT_DISPATCH,
    InjectedCrash,
    inject,
)
from repro_torch.resil.policy import CircuitBreaker, ResiliencePolicy

from .incremental import (
    _dirty_stats,
    incremental_bc,
    incremental_bfs,
    incremental_sssp,
    results_equal,
)
from .scheduler import SchedulerStats, StreamScheduler
from .version_ring import PinnedSnapshot, VersionRing, stream_event

_INCREMENTAL = {"bfs": incremental_bfs, "sssp": incremental_sssp,
                "bc": incremental_bc}

#: per-query cost scratch template (reset at every traced query() entry).
_QUERY_COST_ZERO = {"coll_bytes": 0, "temp_bytes": 0, "flops": 0.0,
                    "device_us": 0.0}

#: static delta-vs-full crossover per query kind.  BFS/SSSP deltas are
#: frontier-local; BC's incremental path re-runs the FULL backward sweep,
#: so its delta only wins at a few percent dirty.
DEFAULT_DIRTY_THRESHOLDS: Dict[str, float] = {
    "bfs": 0.25, "sssp": 0.25, "bc": 0.05}

#: a service's dirty_threshold= accepts one float for every kind or a
#: per-kind mapping (missing kinds fall back to the defaults above).
ThresholdSpec = Union[None, float, Mapping[str, float]]


def resolve_dirty_thresholds(spec: ThresholdSpec,
                             kinds: Sequence[str]) -> Dict[str, float]:
    """Normalize a ``dirty_threshold`` spec to a per-kind dict."""
    if spec is None:
        return {k: DEFAULT_DIRTY_THRESHOLDS.get(k, 0.25) for k in kinds}
    if isinstance(spec, (int, float)):
        return {k: float(spec) for k in kinds}
    return {k: float(spec.get(k, DEFAULT_DIRTY_THRESHOLDS.get(k, 0.25)))
            for k in kinds}


def _set_counts(sp) -> None:
    """A ``bc_scores`` record's counts: its counting products per sweep
    phase and its device-to-host reads."""
    sp.set(forward_levels=sp.counts.get("bc_scores.forward_level", 0),
           backward_levels=sp.counts.get("bc_scores.backward_level", 0),
           host_reads=sp.counts.get(HOST_READ, 0))


def _sweep_fields(amask, alive, cut, prior_ok) -> dict:
    """A traced refresh's record fields, read in one ``host_read``:

      * ``live_block_share``: the share of the occupancy grid's blocks,
        in the refresh's vertex order, that hold an entry;
      * ``dead``: vertices not alive at the version;
      * ``revived_rows``: sources restarted because they were revived (alive
        now, with an empty prior tree);
      * ``cold_rows``: source rows the sweep restarts from level 0: a cut
        of 0 (a source that died), the revived ones, and every row of a
        cold refresh (``cut`` ``None``);
      * ``reused_rows``: live sources whose whole prior tree is kept (no
        dirty vertex in it: a cut past every level).
    """
    vcap = alive.shape[0]
    if cut is None:
        cut = torch.zeros_like(alive, dtype=torch.int32)
        revived = torch.zeros_like(alive)
    else:
        revived = alive & ~prior_ok
        cut = torch.where(revived, 0, cut)
    counts = torch.stack([(~alive).sum(), revived.sum(), (cut == 0).sum(),
                          (alive & (cut > vcap)).sum()]).double()
    share, *rows = host_read(torch.Tensor.tolist, torch.cat(
        [amask.float().mean().double()[None], counts]))
    dead, revived_rows, cold_rows, reused_rows = (int(x) for x in rows)
    return dict(live_block_share=share, dead=dead, revived_rows=revived_rows,
                cold_rows=cold_rows, reused_rows=reused_rows)


class ServiceStats(CounterStruct):
    """Per-query mode tallies: unchanged + delta + full == queries (a cn
    query is counted once, by its final collect's mode).

    ``queries`` and the mode tallies count only *successful* collects; a
    raising collect increments ``errors`` instead.  ``degraded`` counts
    stale-serve replies (outside ``queries``), ``retries`` the demoted
    re-collect attempts the resilience ladder ran.  The values live as
    ``service_*`` counters in the service's telemetry registry, or in a
    private registry without telemetry.
    """

    _FIELDS = ("queries", "unchanged", "delta", "full", "collects",
               "cn_retries", "errors", "degraded", "retries")
    _PREFIX = "service_"

    def count(self, mode: str) -> None:
        if mode == "unchanged":
            self.unchanged += 1
        elif mode == "delta":
            self.delta += 1
        else:
            self.full += 1


@dataclass
class _CacheSlot:
    version: int
    result: object  # BFSResult | SSSPResult | BCResult
    #: on the card, recorded on the storing thread's stream after the
    #: result's work: a reader on another stream waits for it
    ready: Optional[torch.cuda.Event] = None


def prune_result_cache(cache: Dict, max_cached: int, floor: int,
                       pinned=()) -> None:
    """Keep a per-``(kind, src)`` result cache bounded.

    Slots whose version fell below ``floor`` (out of the ring window) can
    never serve an unchanged/delta hit, so they go first; then evict in
    insertion order (callers keep it LRU by delete-then-insert).  Slots at
    ``pinned`` versions are exempt from both sweeps.
    """
    if len(cache) <= max_cached:
        return
    pinned = frozenset(pinned)
    for key in [k for k, s in cache.items()
                if s.version < floor and s.version not in pinned]:
        del cache[key]
    if len(cache) > max_cached:
        evictable = [k for k, s in cache.items() if s.version not in pinned]
        for key in evictable[:len(cache) - max_cached]:
            del cache[key]


@dataclass
class QueryReply:
    """What ``GraphService.query`` hands back.

    ``degraded`` replies carry the last cached answer at ``stale_version``
    (== ``version``, still resident in the ring) because every fresher
    rung of the resilience ladder failed; ``retries`` counts the demoted
    re-collect attempts the ladder ran before this reply.
    """

    result: object          # BFSResult | SSSPResult | BCResult
    version: int            # ring version the answer is valid at
    mode: str               # "unchanged" | "delta" | "full" | "degraded"
    validated: bool         # True for cn-mode answers that double-collected
    scan: ScanStats = field(default_factory=ScanStats)
    degraded: bool = False
    stale_version: Optional[int] = None
    retries: int = 0


class BaseGraphService:
    """Shared submit()/query() plumbing.

    Subclasses implement ``_collect(kind, srcs, key, ladder) -> (entry,
    result, mode)`` -- one collect against the latest ring version, running
    their own unchanged -> delta -> full ladder -- plus ``_key``/
    ``_check_srcs``; the base drives the scheduler/ring, the LRU result
    cache, the mode counters, the telemetry, the resilience ladder and the
    PG-Icn / PG-Cn collect loops.
    """

    #: query kinds this service answers (subclass attribute).
    _kinds: Tuple[str, ...] = ()
    #: ``service`` label on every metric / trace record (subclass attr).
    _service_name: str = "service"

    def _init_service(self, initial_state: GraphState, *, ring_depth: int,
                      batch_size: int, dirty_threshold: ThresholdSpec,
                      strict_order: bool, coalesce: bool, max_collects: int,
                      max_cached: int,
                      telemetry: Optional[Telemetry] = None,
                      policy: Optional[ResiliencePolicy] = None,
                      journal=None, monitor=None, adaptive=None,
                      breaker=None, compact_every: Optional[int] = None
                      ) -> None:
        self.telemetry = telemetry
        self.policy = policy
        registry = telemetry.registry if telemetry is not None else None
        self.dirty_thresholds = resolve_dirty_thresholds(
            dirty_threshold, self._kinds)
        # Adaptive dirty-threshold control: an AdaptiveThresholds (or True
        # for one seeded from the static per-kind thresholds) feeds on the
        # traced wall times, so it requires telemetry.
        if adaptive is True:
            adaptive = AdaptiveThresholds(base=self.dirty_thresholds)
        if adaptive is not None:
            if telemetry is None:
                raise ValueError("adaptive thresholds require telemetry= "
                                 "(the controller feeds on traced query "
                                 "wall times)")
            adaptive.bind(registry, telemetry.tracer, self._service_name)
        self.adaptive: Optional[AdaptiveThresholds] = adaptive
        # Circuit-breaker fault domains: works without telemetry; with it,
        # trips/restores are traced.
        if breaker is True:
            breaker = CircuitBreaker()
        if breaker is not None:
            breaker.bind(registry,
                         telemetry.tracer if telemetry is not None else None,
                         self._service_name)
        self.breaker: Optional[CircuitBreaker] = breaker
        self.ring = VersionRing(initial_state, depth=ring_depth)
        # The scheduler's counters carry this service's label: two services
        # sharing one telemetry registry must not alias their tallies.
        sched_stats = (SchedulerStats(registry, service=self._service_name)
                       if registry is not None else None)
        # The scheduler reaches back through a weak reference: a bound
        # method would make a cycle that keeps a dropped service, and its
        # device tensors, alive until the cycle collector runs.
        owner = weakref.ref(self)
        self.scheduler = StreamScheduler(
            self.ring, batch_size=batch_size, strict_order=strict_order,
            coalesce=coalesce, telemetry=telemetry, journal=journal,
            monitor=monitor, compact_every=compact_every,
            compact_extra=lambda: owner()._wal_extra(), stats=sched_stats)
        self.max_collects = max_collects
        self.max_cached = max_cached
        self.stats = ServiceStats(registry, service=self._service_name)
        self._cache: Dict[Tuple, _CacheSlot] = {}
        # The cache is shared between the collect path and the stale-serve
        # bottom rung; one re-entrant lock keeps store + prune + stale-read
        # atomic.
        self._cache_lock = threading.RLock()
        # Per-query observation scratch, reset at query() entry: the cost
        # summed over the query's collects, the device time, and the dirty
        # fraction the ladder saw (fed to the adaptive controller).
        # Thread-local, so concurrent callers each see their own.
        self._query_tls = threading.local()

    # ------------------------- per-thread scratch -------------------------

    @property
    def _query_cost(self) -> dict:
        cost = getattr(self._query_tls, "cost", None)
        if cost is None:
            cost = dict(_QUERY_COST_ZERO)
            self._query_tls.cost = cost
        return cost

    @_query_cost.setter
    def _query_cost(self, value: dict) -> None:
        self._query_tls.cost = value

    @property
    def _query_dirty_frac(self) -> Optional[float]:
        return getattr(self._query_tls, "dirty_frac", None)

    @_query_dirty_frac.setter
    def _query_dirty_frac(self, value: Optional[float]) -> None:
        self._query_tls.dirty_frac = value

    # ------------------------------ updates ------------------------------

    def submit(self, op: Tuple) -> int:
        """Enqueue one mutation; full batches auto-commit into the ring."""
        return self.scheduler.submit(op)

    def submit_many(self, ops: Sequence[Tuple]) -> list:
        return self.scheduler.submit_many(ops)

    def flush(self):
        """Commit every pending update (the tail batch is padded)."""
        return self.scheduler.flush()

    @property
    def version(self) -> int:
        return self.ring.latest.version

    def pin(self, version: Optional[int] = None) -> PinnedSnapshot:
        return self.ring.pin(version)

    # ---------------------------- WAL compaction --------------------------

    def _wal_extra(self) -> dict:
        """Side-car state a compaction snapshot must carry: the op ledger
        and, when the adaptive controller is bound, its learned per-kind
        thresholds -- a recovered service resumes tuned, not cold."""
        extra = {"ops_committed": int(self.scheduler.stats.ops_committed)}
        if self.adaptive is not None:
            extra["adaptive_thresholds"] = self.adaptive.thresholds()
        return extra

    def compact_wal(self) -> dict:
        """Snapshot the latest committed state into the journal's
        checkpoint store and drop covered WAL segments (see
        :meth:`repro_torch.resil.OpJournal.compact`); returns the report."""
        journal = self.scheduler.journal
        if journal is None:
            raise ValueError("compact_wal() requires a journal= on the "
                             "service")
        entry = self.ring.latest
        return journal.compact(entry.state, entry.version,
                               extra=self._wal_extra())

    # ------------------------------ breaker ------------------------------

    def _breaker_allows(self, kind: str) -> bool:
        """May this collect touch its cached prior (the delta path)?
        Consulted once per collect that HAS a usable prior."""
        return self.breaker is None or self.breaker.allow_delta(kind)

    def _breaker_failure(self, kind: str) -> None:
        if self.breaker is not None:
            self.breaker.record_failure(kind)

    def _breaker_success(self, kind: str, mode: str) -> None:
        # only an actual delta collect says anything about the delta path
        if self.breaker is not None and mode == "delta":
            self.breaker.record_success(kind)

    # ------------------------------- cache -------------------------------

    def _cache_store(self, key, version: int, result) -> None:
        # A planned fault here fires BEFORE any mutation, so the old slot
        # (still correct at ITS version) survives intact.
        inject(P_CACHE_STORE)
        # Delete-then-insert moves the key to the back of the dict so the
        # front-of-dict eviction is LRU, not FIFO.  A slot at a later
        # version stays: a reply pinned to an older version (the serving
        # front end's) must not replace a newer answer.
        ready = stream_event(self.ring.latest.state.device)
        with self._cache_lock:
            old = self._cache.get(key)
            if old is not None and old.version > version:
                return
            self._cache.pop(key, None)
            self._cache[key] = _CacheSlot(version, result, ready)
            # dirty_between still spans slots at oldest_version - 1, so
            # only versions strictly below that are unservable.
            prune_result_cache(self._cache, self.max_cached,
                               self.ring.oldest_version - 1,
                               pinned=self.ring.pinned_versions())

    # ------------------------------- hooks -------------------------------

    def _key(self, kind: str, srcs) -> Tuple:
        raise NotImplementedError

    def _check_srcs(self, kind: str, srcs) -> None:
        """Reject source specs this service cannot answer (ValueError)."""

    def _collect(self, kind: str, srcs, key, ladder: bool = True):
        """One collect at the latest ring version -> (entry, result, mode).

        ``ladder=False`` (a resilience-ladder retry) must bypass the
        cache/delta rungs and recompute fully from a pinned snapshot."""
        raise NotImplementedError

    def _icn_validated(self, result) -> bool:
        """The ``validated`` flag of a single-collect reply (the reference's
        sharded service carries its cross-shard agreement here)."""
        return False

    def _agree(self, value):
        """The value every process of the service acts on, for a decision
        that reads the clock: this process's own here; the sharded service
        on a process group takes rank 0's."""
        return value

    # ----------------------------- telemetry -----------------------------

    def _acct_begin(self):
        """The cost accountant with its deposit slot cleared, or None."""
        tel = self.telemetry
        acct = tel.accountant if tel is not None else None
        if acct is not None:
            acct.last = None
        return acct

    def _acct_charge(self, acct) -> None:
        """Add one collect's deposited cost to the current query's record."""
        cost = acct.last if acct is not None else None
        if cost:
            qc = self._query_cost
            qc["coll_bytes"] += cost.get("collective_bytes", 0) or 0
            qc["temp_bytes"] = max(qc["temp_bytes"],
                                   cost.get("temp_bytes") or 0)
            qc["flops"] += cost.get("flops") or 0.0

    def _threshold(self, kind: str) -> float:
        """The ladder's delta-vs-full crossover for ``kind``: the adaptive
        controller's current (possibly probing) value when one is bound,
        else the static per-kind threshold."""
        if self.adaptive is not None:
            return self.adaptive.threshold(kind)
        return self.dirty_thresholds[kind]

    def _note_dirty_frac(self, frac) -> None:
        if frac is not None:
            self._query_dirty_frac = float(frac)

    def _traced_collect(self, kind: str, srcs, key, ladder: bool = True):
        """``_collect`` in a child span when tracing is on, its device time
        read from the device timer's region around it."""
        tel = self.telemetry
        if tel is None:
            return self._collect(kind, srcs, key, ladder=ladder)
        with tel.tracer.span("collect", kind=kind) as sp:
            with tel.profiler.region(f"collect:{kind}",
                                     self.ring.latest.state.device) as reg:
                entry, res, qmode = self._collect(kind, srcs, key,
                                                  ladder=ladder)
            dev = reg.us
            self._query_cost["device_us"] += dev
            sp.set(version=entry.version, mode=qmode,
                   device_us=round(dev, 1))
        return entry, res, qmode

    # ------------------------------ queries ------------------------------

    def query(self, kind: str, srcs=None, mode: str = "icn") -> QueryReply:
        """Answer one analytics query.

        ``kind``: one of ``self._kinds``; ``srcs``: a vertex id.
        ``mode``: ``"icn"`` (single collect) or ``"cn"`` (double collect).

        With telemetry attached, every call emits one ``span == "query"``
        trace record (kind / ring version / ladder mode / wall and block
        time / device time / collect count / cost) and observes the wall
        time into the ``query_wall_us`` histogram labelled
        service/kind/mode.
        """
        if kind not in self._kinds:
            raise KeyError(f"unknown query kind {kind!r}")
        if mode not in ("icn", "cn"):
            raise ValueError(f"unknown mode {mode!r}")
        self._check_srcs(kind, srcs)
        tel = self.telemetry
        if tel is None:
            return self._query_guarded(kind, srcs, mode)
        self._query_cost = dict(_QUERY_COST_ZERO)
        self._query_dirty_frac = None
        with tel.tracer.span("query", service=self._service_name,
                             kind=kind, cn=(mode == "cn")) as sp:
            try:
                reply = self._query_guarded(kind, srcs, mode)
            except BaseException as e:
                # A failed query has no version/mode to claim.
                sp.set(error=type(e).__name__)
                raise
            block_us = 0.0
            if tel.block:
                t0 = time.perf_counter()
                block_until_ready(reply.result)
                block_us = (time.perf_counter() - t0) * 1e6
            sp.set(version=reply.version, mode=reply.mode,
                   collects=reply.scan.collects,
                   cn_interrupts=reply.scan.interrupting_updates,
                   validated=reply.validated,
                   block_us=round(block_us, 1),
                   device_us=round(self._query_cost["device_us"], 1),
                   coll_bytes=self._query_cost["coll_bytes"],
                   temp_bytes=self._query_cost["temp_bytes"],
                   flops=self._query_cost["flops"],
                   degraded=reply.degraded,
                   stale_version=reply.stale_version,
                   retries=reply.retries)
        tel.registry.histogram(
            "query_wall_us", service=self._service_name, kind=kind,
            mode=reply.mode).observe(sp.wall_us)
        if self._query_cost["device_us"] > 0:
            tel.registry.histogram(
                "query_device_us", service=self._service_name, kind=kind,
                mode=reply.mode).observe(self._query_cost["device_us"])
        # Feed the controller after the span closed so any resulting
        # threshold_adjust span is a sibling, not a child, of the query.
        if self.adaptive is not None and not reply.degraded:
            self.adaptive.observe(kind, reply.mode, sp.wall_us,
                                  self._query_dirty_frac)
        return reply

    def _query_guarded(self, kind: str, srcs, mode: str) -> QueryReply:
        """One query under the failure policy (or bare stats accounting)."""
        if self.policy is None:
            try:
                return self._query_inner(kind, srcs, mode)
            except InjectedCrash:
                raise  # crashes are not an error path: they end the process
            except Exception:
                self.stats.errors += 1
                raise
        return self._query_resilient(kind, srcs, mode)

    def _query_resilient(self, kind: str, srcs, mode: str) -> QueryReply:
        """Walk the degrade ladder: attempt, retry-as-full, stale serve.

        The first attempt runs the normal unchanged -> delta -> full
        ladder; every retry forces a full recompute from a pinned snapshot.
        The deadline bounds *retries*, never the first attempt.
        """
        pol = self.policy
        t0 = time.perf_counter()
        last_exc: Optional[Exception] = None
        for attempt in range(pol.max_retries + 1):
            if attempt:
                if self._agree(pol.deadline_exceeded(t0)):
                    break
                back = pol.backoff_s(attempt)
                if back > 0:
                    time.sleep(back)
                self.stats.retries += 1
            try:
                reply = self._query_inner(kind, srcs, mode,
                                          force_full=attempt > 0)
                reply.retries = attempt
                return reply
            except InjectedCrash:
                raise
            except Exception as e:
                self.stats.errors += 1
                last_exc = e
        if pol.allow_stale:
            reply = self._stale_reply(kind, srcs)
            if reply is not None:
                self.stats.degraded += 1
                return reply
        assert last_exc is not None
        raise last_exc

    def _stale_reply(self, kind: str, srcs) -> Optional[QueryReply]:
        """Bottom rung: last cached answer, iff its version is still
        resident in the ring.  ``try_pin`` checks residency and takes the
        pin in one critical section, so a degraded reply never names a
        version that was already gone when it was built."""
        key = self._key(kind, srcs)
        with self._cache_lock:
            slot = self._cache.get(key)
            if slot is None:
                return None
            pin = self.ring.try_pin(slot.version)
        if pin is None:
            return None
        with pin:
            return QueryReply(slot.result, slot.version, "degraded", False,
                              ScanStats(), degraded=True,
                              stale_version=slot.version)

    def _query_inner(self, kind: str, srcs, mode: str,
                     force_full: bool = False) -> QueryReply:
        key = self._key(kind, srcs)
        if mode == "icn":
            entry, res, qmode = self._traced_collect(
                kind, srcs, key, ladder=not force_full)
            # Success accounting only: a raising collect leaves queries
            # (and the mode tallies) untouched.
            self.stats.queries += 1
            self.stats.collects += 1
            self.stats.count(qmode)
            return QueryReply(res, entry.version, qmode,
                              self._icn_validated(res),
                              ScanStats(collects=1, validated=False))
        return self._query_cn(kind, srcs, key, force_full=force_full)

    def _query_cn(self, kind: str, srcs, key,
                  force_full: bool = False) -> QueryReply:
        """PG-Cn: double-collect over ring versions until answers match.

        Between collects, one pending update batch commits (the stream's
        interrupting updates).  Two collects at the same ring version are
        equal by construction, so the loop ends as soon as the collect
        window sees no interleaved commit.
        """
        ladder = not force_full
        scan = ScanStats()
        v0 = self.ring.latest.version
        entry, prev_res, qmode = self._traced_collect(kind, srcs, key,
                                                      ladder=ladder)
        scan.collects = 1
        while scan.collects < self.max_collects:
            self.scheduler.commit_one()  # interrupting update, if pending
            cur_entry, cur_res, cur_mode = self._traced_collect(
                kind, srcs, key, ladder=ladder)
            scan.collects += 1
            if cur_entry.version == entry.version or results_equal(
                    prev_res, cur_res):
                self.stats.queries += 1
                self.stats.collects += scan.collects
                self.stats.count(cur_mode)
                scan.interrupting_updates = cur_entry.version - v0
                scan.validated = True
                return QueryReply(cur_res, cur_entry.version, cur_mode,
                                  True, scan)
            self.stats.cn_retries += 1
            entry, prev_res, qmode = cur_entry, cur_res, cur_mode
        scan.validated = False
        scan.interrupting_updates = self.ring.latest.version - v0
        self.stats.queries += 1
        self.stats.collects += scan.collects
        self.stats.count(qmode)
        return QueryReply(prev_res, entry.version, qmode, False, scan)


class GraphService(BaseGraphService):
    """submit()/query() front end: streaming updates, incremental queries."""

    _kinds = ("bfs", "sssp", "bc")
    _service_name = "local"

    def __init__(self, initial_state: GraphState, *, ring_depth: int = 8,
                 batch_size: int = 32,
                 dirty_threshold: ThresholdSpec = None,
                 strict_order: bool = False, coalesce: bool = False,
                 max_collects: int = 16, max_cached: int = 512,
                 telemetry: Optional[Telemetry] = None,
                 policy: Optional[ResiliencePolicy] = None,
                 journal=None, monitor=None, adaptive=None, breaker=None,
                 compact_every: Optional[int] = None):
        self._init_service(
            initial_state, ring_depth=ring_depth, batch_size=batch_size,
            dirty_threshold=dirty_threshold, strict_order=strict_order,
            coalesce=coalesce, max_collects=max_collects,
            max_cached=max_cached, telemetry=telemetry, policy=policy,
            journal=journal, monitor=monitor, adaptive=adaptive,
            breaker=breaker, compact_every=compact_every)
        self._tiles: Optional[TileView] = None
        self._tiles_version: int = -1
        self._bc_scores: Optional[dict] = None
        self.bc_scores_stats = ModeCounters(
            self.stats.registry, "bc_scores_queries",
            service=self._service_name)

    # ------------------------------ queries ------------------------------

    def _key(self, kind: str, src) -> Tuple[str, int]:
        return kind, src

    def _check_srcs(self, kind: str, src) -> None:
        if src is None:
            raise ValueError(f"{kind!r} needs an explicit source vertex")

    def _collect(self, kind: str, src, key, ladder: bool = True):
        """One incremental collect against the current latest ring version:
        the unchanged -> delta -> full ladder lives in
        ``engine.incremental``.

        ``ladder=False`` (a resilience retry) pins the latest version and
        recomputes from scratch -- no cache read, no dirty-set math -- so a
        corrupt delta path cannot poison the retry."""
        if not ladder:
            entry = self.ring.latest
            with self.ring.pin(entry.version):
                inject(P_COLLECT_DISPATCH)
                acct = self._acct_begin()
                res, inc = _INCREMENTAL[kind](
                    entry.state, None, None, src,
                    dirty_threshold=self.dirty_thresholds[kind],
                    accountant=acct)
                self._acct_charge(acct)
            self._cache_store(key, entry.version, res)
            return entry, res, inc.mode
        entry = self.ring.latest
        slot = self._cache.get(key)
        prior, dirty = None, None
        # A tripped breaker quarantines the cached prior entirely: the
        # collect below sees no prior and runs the clean full path.
        use_prior = slot is not None and self._breaker_allows(kind)
        try:
            if use_prior:
                prior = slot.result
                dirty = self.ring.dirty_between(slot.version, entry.version)
                inject(P_COLLECT_DELTA)
            inject(P_COLLECT_DISPATCH)
            acct = self._acct_begin()
            res, inc = _INCREMENTAL[kind](
                entry.state, prior, dirty, src,
                dirty_threshold=self._threshold(kind), accountant=acct)
        except InjectedCrash:
            raise
        except Exception:
            # any failure while a usable prior was in play counts against
            # the kind's delta path
            if use_prior:
                self._breaker_failure(kind)
            raise
        if use_prior:
            self._breaker_success(kind, inc.mode)
        self._acct_charge(acct)
        self._note_dirty_frac(inc.dirty_fraction)
        self._cache_store(key, entry.version, res)
        return entry, res, inc.mode

    # --------------------------- batched analytics ------------------------

    def tile_view(self) -> TileView:
        """Blocked adjacency view of the latest version, built in full
        (``build_tile_view``) the first time a version is asked for and
        cached until a commit moves the ring.  The previous version's view
        is dropped before the build, so that the allocator can reuse its
        buffers where no caller holds it; a view a caller holds is never
        written."""
        entry = self.ring.latest
        if self._tiles is not None and self._tiles_version == entry.version:
            return self._tiles
        self._tiles = None
        tracer = self.telemetry.tracer if self.telemetry else None
        with maybe_span(tracer, "tile_refresh", service=self._service_name,
                        full=True):
            self._tiles = build_tile_view(entry.state)
        self._tiles_version = entry.version
        return self._tiles

    def bc_scores(self, use_kernel=None, src_chunk: Optional[int] = None):
        """Exact betweenness centrality of every vertex at the latest
        version, via the tile-sparse batched Brandes path (all sources as
        counting products; empty tiles skipped by ``count_mm_masked``).
        ``use_kernel`` as in ``semiring.count_mm`` (default: the kernel on
        a CUDA state).  ``src_chunk`` bounds the S x V scratch.  Returns
        ``(scores f32[vcap], version)``.

        Incremental across versions: the previous call's forward trees
        (level/sigma per source, cached alongside the scores) warm-start
        ``bc_batched_dense`` through the per-source level cut --
        bit-identical to the cold sweep.  Mode tallies land in
        ``bc_scores_stats``; the delta-vs-full crossover is
        ``_threshold("bc")``, so the adaptive controller reaches it.

        The sweeps run with the vertex axis in ``queries.bc_vertex_order``
        (hubs first, edgeless vertices last), against an occupancy grid of
        the reordered adjacency at ``queries.ORDER_TILE``; the results come
        back in vertex order, and the cached trees stay in vertex order.

        A refresh runs in a ``bc_scores`` span (its record: ``mode``,
        ``version``, ``n_dirty``, ``forward_levels``, ``backward_levels``,
        ``host_reads``, and, where it swept, the fields of
        ``_sweep_fields``, read in one ``host_read`` and only for a
        tracer's record) whose children are its phases: ``bc_scores.plan``,
        ``tile_refresh`` (the tile view, built in full at a new version),
        ``bc_scores.views``, ``bc_scores.operands`` (opened in
        ``queries.bc_batched_dense``), ``bc_scores.forward`` /
        ``bc_scores.backward`` (one ``*_level`` child per counting product,
        opened in ``queries.bc_sweep_ops``) and ``bc_scores.reduce``.  Every
        device-to-host read of a refresh goes through ``obs.host_read``.
        """
        entry = self.ring.latest
        params = (use_kernel, src_chunk)
        slot = self._bc_scores
        if (slot is not None and slot["version"] == entry.version
                and slot["params"] == params):
            return slot["scores"], entry.version
        tracer = self.telemetry.tracer if self.telemetry else None
        with maybe_span(tracer, "bc_scores") as sp:
            return self._bc_refresh(entry, params, slot, use_kernel,
                                    src_chunk, sp)

    def _bc_refresh(self, entry, params, slot, use_kernel, src_chunk, sp):
        """``bc_scores`` below its cache check, inside its span ``sp``."""
        state = entry.state
        mode, dirty, n_dirty, warm = "full", None, None, {}
        with child_span("bc_scores.plan"):
            if (slot is not None and slot["params"] == params
                    and tuple(slot["level"].shape) == (state.vcap,
                                                       state.vcap)):
                dirty = self.ring.dirty_between(slot["version"],
                                                entry.version)
            if dirty is not None:
                n_dirty, touched = _dirty_stats(
                    (slot["level"] >= 0).any(dim=0), dirty)
                if not touched and host_read(
                        bool, (~slot["ok"] & state.alive).any()):
                    # A resurrected source's cached tree is empty: no dirty
                    # vertex can intersect it, but its row must recompute.
                    touched = True
                if not touched:
                    mode = "unchanged"
                elif n_dirty / state.vcap <= self._threshold("bc"):
                    mode = "delta"
                    warm = dict(prior_level=slot["level"],
                                prior_sigma=slot["sigma"],
                                cut=queries.bc_level_cut(slot["level"], dirty,
                                                         state.alive))
        self.bc_scores_stats[mode] += 1
        sp.set(mode=mode, version=entry.version, n_dirty=n_dirty)
        if mode == "unchanged":
            # Churn never touched any source's forward region: every tree --
            # hence every score -- stands as-is at the new version.
            slot["version"] = entry.version
            _set_counts(sp)
            return slot["scores"], entry.version
        view = self.tile_view()
        with child_span("bc_scores.views"):
            # The sweeps run with the vertex axis in a hub-first order
            # (``queries.bc_vertex_order``), so that the products' block
            # masks skip the empty blocks; source row i is vertex order[i].
            adj_mask, _, alive = dense_views_from_tiles(state, view)
            order = queries.bc_vertex_order(adj_mask, alive)
            adj_mask = queries.permute_square(adj_mask, order)
            amask = queries.block_occupancy(adj_mask, queries.ORDER_TILE)
            srcs = torch.arange(state.vcap, dtype=torch.int32,
                                device=state.device)
            if sp.id is not None:   # a tracer's span: read for its record
                sp.set(**_sweep_fields(amask, alive, warm.get("cut"),
                                       slot["ok"] if warm else None))
            if warm:
                warm = dict(
                    prior_level=queries.permute_square(warm["prior_level"],
                                                       order),
                    prior_sigma=queries.permute_square(warm["prior_sigma"],
                                                       order),
                    cut=warm["cut"][order])
        delta, sigma, level, ok = queries.bc_batched_dense(
            adj_mask, srcs, alive[order], use_kernel=use_kernel, amask=amask,
            tile=queries.ORDER_TILE, src_chunk=src_chunk, **warm)
        with child_span("bc_scores.reduce"):
            back = torch.argsort(order)
            scores = torch.where(ok[:, None], delta, 0.0).sum(dim=0)[back]
            scores = torch.where(alive, scores, math.nan)
            level = queries.permute_square(level, back)
            sigma = queries.permute_square(sigma, back)
            ok = ok[back]
        self._bc_scores = {"version": entry.version, "params": params,
                           "scores": scores, "level": level, "sigma": sigma,
                           "ok": ok}
        _set_counts(sp)
        return scores, entry.version
