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

The reference's telemetry, resilience policy, journal, heartbeat monitor,
adaptive thresholds, circuit breaker and WAL compaction are not ported
yet (ROADMAP.md); their defaults there are all off.  Collect failures
propagate, counted in ``stats.errors``.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import queries
from repro_torch.core.graph_state import GraphState
from repro_torch.core.snapshot import ScanStats
from repro_torch.core.tiles import TileView, dense_views_from_tiles, \
    refresh_tile_view

from .incremental import (
    _dirty_stats,
    incremental_bc,
    incremental_bfs,
    incremental_sssp,
    results_equal,
)
from .scheduler import StreamScheduler
from .version_ring import PinnedSnapshot, VersionRing

_INCREMENTAL = {"bfs": incremental_bfs, "sssp": incremental_sssp,
                "bc": incremental_bc}

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


@dataclass
class ServiceStats:
    """Per-query mode tallies: unchanged + delta + full == queries (a cn
    query is counted once, by its final collect's mode).  ``queries`` and
    the mode tallies count only successful collects; a raising collect
    increments ``errors`` instead."""

    queries: int = 0
    unchanged: int = 0
    delta: int = 0
    full: int = 0
    collects: int = 0
    cn_retries: int = 0
    errors: int = 0

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
    """What ``GraphService.query`` hands back."""

    result: object          # BFSResult | SSSPResult | BCResult
    version: int            # ring version the answer is valid at
    mode: str               # "unchanged" | "delta" | "full"
    validated: bool         # True for cn-mode answers that double-collected
    scan: ScanStats = field(default_factory=ScanStats)


class BaseGraphService:
    """Shared submit()/query() plumbing.

    Subclasses implement ``_collect(kind, srcs, key) -> (entry, result,
    mode)`` -- one collect against the latest ring version, running their
    own unchanged -> delta -> full ladder -- plus ``_key``/``_check_srcs``;
    the base drives the scheduler/ring, the LRU result cache, the mode
    counters, and the PG-Icn / PG-Cn collect loops.
    """

    #: query kinds this service answers (subclass attribute).
    _kinds: Tuple[str, ...] = ()

    def _init_service(self, initial_state: GraphState, *, ring_depth: int,
                      batch_size: int, dirty_threshold: ThresholdSpec,
                      strict_order: bool, coalesce: bool, max_collects: int,
                      max_cached: int) -> None:
        self.dirty_thresholds = resolve_dirty_thresholds(
            dirty_threshold, self._kinds)
        self.ring = VersionRing(initial_state, depth=ring_depth)
        self.scheduler = StreamScheduler(
            self.ring, batch_size=batch_size, strict_order=strict_order,
            coalesce=coalesce)
        self.max_collects = max_collects
        self.max_cached = max_cached
        self.stats = ServiceStats()
        self._cache: Dict[Tuple, _CacheSlot] = {}
        self._cache_lock = threading.RLock()

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

    # ------------------------------- cache -------------------------------

    def _cache_store(self, key, version: int, result) -> None:
        # Delete-then-insert moves the key to the back of the dict so the
        # front-of-dict eviction is LRU, not FIFO.
        with self._cache_lock:
            self._cache.pop(key, None)
            self._cache[key] = _CacheSlot(version, result)
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

    def _collect(self, kind: str, srcs, key):
        """One collect at the latest ring version -> (entry, result, mode)."""
        raise NotImplementedError

    # ------------------------------ queries ------------------------------

    def query(self, kind: str, srcs=None, mode: str = "icn") -> QueryReply:
        """Answer one analytics query.

        ``kind``: one of ``self._kinds``; ``srcs``: a vertex id.
        ``mode``: ``"icn"`` (single collect) or ``"cn"`` (double collect).
        """
        if kind not in self._kinds:
            raise KeyError(f"unknown query kind {kind!r}")
        if mode not in ("icn", "cn"):
            raise ValueError(f"unknown mode {mode!r}")
        self._check_srcs(kind, srcs)
        try:
            return self._query_inner(kind, srcs, mode)
        except Exception:
            self.stats.errors += 1
            raise

    def _query_inner(self, kind: str, srcs, mode: str) -> QueryReply:
        key = self._key(kind, srcs)
        if mode == "icn":
            entry, res, qmode = self._collect(kind, srcs, key)
            # Success accounting only: a raising collect leaves queries
            # (and the mode tallies) untouched.
            self.stats.queries += 1
            self.stats.collects += 1
            self.stats.count(qmode)
            return QueryReply(res, entry.version, qmode, False,
                              ScanStats(collects=1, validated=False))
        return self._query_cn(kind, srcs, key)

    def _query_cn(self, kind: str, srcs, key) -> QueryReply:
        """PG-Cn: double-collect over ring versions until answers match.

        Between collects, one pending update batch commits (the stream's
        interrupting updates).  Two collects at the same ring version are
        equal by construction, so the loop ends as soon as the collect
        window sees no interleaved commit.
        """
        scan = ScanStats()
        v0 = self.ring.latest.version
        entry, prev_res, qmode = self._collect(kind, srcs, key)
        scan.collects = 1
        while scan.collects < self.max_collects:
            self.scheduler.commit_one()  # interrupting update, if pending
            cur_entry, cur_res, cur_mode = self._collect(kind, srcs, key)
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

    def __init__(self, initial_state: GraphState, *, ring_depth: int = 8,
                 batch_size: int = 32,
                 dirty_threshold: ThresholdSpec = None,
                 strict_order: bool = False, coalesce: bool = False,
                 max_collects: int = 16, max_cached: int = 512):
        self._init_service(
            initial_state, ring_depth=ring_depth, batch_size=batch_size,
            dirty_threshold=dirty_threshold, strict_order=strict_order,
            coalesce=coalesce, max_collects=max_collects,
            max_cached=max_cached)
        self._tiles: Optional[TileView] = None
        self._tiles_version: int = -1
        self._bc_scores: Optional[dict] = None
        self.bc_scores_stats = {"unchanged": 0, "delta": 0, "full": 0}

    # ------------------------------ queries ------------------------------

    def _key(self, kind: str, src) -> Tuple[str, int]:
        return kind, src

    def _check_srcs(self, kind: str, src) -> None:
        if src is None:
            raise ValueError(f"{kind!r} needs an explicit source vertex")

    def _collect(self, kind: str, src, key):
        """One incremental collect against the current latest ring version:
        the unchanged -> delta -> full ladder lives in
        ``engine.incremental``."""
        entry = self.ring.latest
        slot = self._cache.get(key)
        prior, dirty = None, None
        if slot is not None:
            prior = slot.result
            dirty = self.ring.dirty_between(slot.version, entry.version)
        res, inc = _INCREMENTAL[kind](
            entry.state, prior, dirty, src,
            dirty_threshold=self.dirty_thresholds[kind])
        self._cache_store(key, entry.version, res)
        return entry, res, inc.mode

    # --------------------------- batched analytics ------------------------

    def tile_view(self) -> TileView:
        """Blocked adjacency view of the latest version, kept fresh
        incrementally: each call re-derives only the tile rows the ring's
        dirty sets say moved since the last call (full rebuild when the
        span left the ring window or the vertex table grew).  The refresh
        writes into the previous view in place; the service holds only the
        returned one."""
        entry = self.ring.latest
        if self._tiles is not None and self._tiles_version == entry.version:
            return self._tiles
        dirty = None
        if self._tiles is not None:
            dirty = self.ring.dirty_between(self._tiles_version, entry.version)
        self._tiles = refresh_tile_view(entry.state, self._tiles, dirty)
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
        ``bc_scores_stats``.
        """
        entry = self.ring.latest
        params = (use_kernel, src_chunk)
        slot = self._bc_scores
        if (slot is not None and slot["version"] == entry.version
                and slot["params"] == params):
            return slot["scores"], entry.version
        state = entry.state
        mode, dirty = "full", None
        if (slot is not None and slot["params"] == params
                and tuple(slot["level"].shape) == (state.vcap, state.vcap)):
            dirty = self.ring.dirty_between(slot["version"], entry.version)
            if dirty is not None:
                n_dirty, touched = _dirty_stats(
                    (slot["level"] >= 0).any(dim=0), dirty)
                if not touched and bool((~slot["ok"] & state.alive).any()):
                    # A resurrected source's cached tree is empty: no dirty
                    # vertex can intersect it, but its row must recompute.
                    touched = True
                if not touched:
                    mode = "unchanged"
                elif n_dirty / state.vcap <= self.dirty_thresholds["bc"]:
                    mode = "delta"
        self.bc_scores_stats[mode] += 1
        if mode == "unchanged":
            # Churn never touched any source's forward region: every tree --
            # hence every score -- stands as-is at the new version.
            slot["version"] = entry.version
            return slot["scores"], entry.version
        view = self.tile_view()
        adj_mask, _, alive = dense_views_from_tiles(state, view)
        srcs = torch.arange(state.vcap, dtype=torch.int32,
                            device=state.device)
        warm = {}
        if mode == "delta":
            warm = dict(prior_level=slot["level"], prior_sigma=slot["sigma"],
                        cut=queries.bc_level_cut(slot["level"], dirty,
                                                 state.alive))
        delta, sigma, level, ok = queries.bc_batched_dense(
            adj_mask, srcs, alive, use_kernel=use_kernel, amask=view.occ,
            src_chunk=src_chunk, **warm)
        scores = torch.where(ok[:, None], delta, 0.0).sum(dim=0)
        scores = torch.where(alive, scores, math.nan)
        self._bc_scores = {"version": entry.version, "params": params,
                           "scores": scores, "level": level, "sigma": sigma,
                           "ok": ok}
        return scores, entry.version
