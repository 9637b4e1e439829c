"""ShardedGraphService: the streaming front end on a graph mesh (port of
``repro.shard.service``).

Shares :class:`repro_torch.engine.service.BaseGraphService` with the local
``GraphService`` -- updates enter through the scheduler and commit into the
version ring; queries are answered from the ring with per-``(kind,
sources)`` caches, the PG-Icn / PG-Cn collect loops, the LRU pruning, the
mode counters and every option of the base (telemetry, adaptive
thresholds, policy, breaker, journal, monitor, compaction) -- but every
collect here runs the distributed queries of ``repro_torch.shard.queries``
over the sharded tile grid, and the grid itself is maintained
incrementally per rank (``refresh_sharded_view`` re-derives only the
dirty tile rows named by the ring's dirty sets).

Each collect climbs the same *unchanged -> delta -> full* ladder as the
local engine:

  * **unchanged** -- churn since the cached answer never touched its
    reached region: the cached result stands with zero device work;
  * **delta** -- the poison / level cut runs unsharded, the recompute
    warm-starts the sharded level loop (``delta_*_sharded``).  Guarded like
    ``engine.incremental``'s ``_prior_usable``; a delta SSSP that detects a
    new negative cycle re-runs the full query for the canonical answer;
  * **full** -- the distributed fixed point.

Each collect carries the cross-rank version agreement (``result.agree``),
the ``validated`` flag of a single-collect reply (``_icn_validated``).

The view is refreshed in place and shared by every collect, so collects
run one at a time (a service lock); updates and their commits do not
take it.  On a ``DistMesh`` that leaves their order to the caller: under
the async front end (``serve.AsyncGraphService``) rank 0's dispatcher
sequences every commit and collect, and the other processes follow.

On a :class:`~repro_torch.shard.dist.DistMesh` every process runs the
same commits and queries in the same order, and each decision that reads
the clock is rank 0's, sent to every process as a few-byte control
message (``DistMesh.broadcast``, never counted as collective bytes): the
rung of each collect, whose delta-vs-full crossover the adaptive
controller moves with measured walls, and the policy's deadline before a
retry.  The breaker counts consults, not time, and a ``FaultPlan`` is
seeded, so both agree by construction.  Only rank 0 journals, runs the
heartbeat monitor and serves ``/metrics`` (``serve_metrics``); every rank
keeps its own registry.  ``recover()`` runs in every process against
rank 0's journal, after a barrier.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.core.graph_state import GraphState
from repro_torch.core.tiles import TILE
from repro_torch.engine.incremental import _dirty_stats
from repro_torch.engine.service import BaseGraphService, QueryReply  # noqa: F401
from repro_torch.engine.service import ServiceStats  # noqa: F401
from repro_torch.engine.service import ThresholdSpec
from repro_torch.obs import Telemetry
from repro_torch.obs.trace import annotate as _trace_annotate
from repro_torch.obs.trace import maybe_span
from repro_torch.resil.faults import P_COLLECT_DELTA, P_COLLECT_DISPATCH, \
    InjectedCrash, inject
from repro_torch.resil.policy import ResiliencePolicy

from . import queries as shard_queries
from .dist import DistMesh
from .tile_shard import (
    ShardedTileView,
    as_graph_mesh,
    refresh_sharded_view,
    refresh_stats,
)

_QUERIES = {"bfs": shard_queries.bfs, "sssp": shard_queries.sssp,
            "bc": shard_queries.bc_batched}
_DELTA = {"bfs": shard_queries.delta_bfs_sharded,
          "sssp": shard_queries.delta_sssp_sharded,
          "bc": shard_queries.delta_bc_sharded}


def _reached_union(kind: str, result) -> torch.Tensor:
    """bool[vcap]: union over sources of the query's reached region."""
    if kind == "bfs":
        return (result.dist >= 0).any(dim=0)
    if kind == "sssp":
        return (result.dist < torch.inf).any(dim=0)
    return (result.level >= 0).any(dim=0)


class ShardedGraphService(BaseGraphService):
    """submit()/query() front end over the sharded tile grid.

    ``mesh``: a :class:`~repro_torch.shard.GraphMesh` (or a sequence of
    devices); the snapshot lives on rank 0's device.  On a
    :class:`~repro_torch.shard.dist.DistMesh` it lives on the process's own
    device, and ``journal`` / ``monitor`` are rank 0's only (module
    docstring).  ``bc_mode`` picks
    the adjacency strategy of every BC collect, full and delta:
    ``"gather"`` all-gathers the bands per query, ``"ring"`` rotates them
    (see ``shard.queries.bc_batched``).  ``use_kernel`` as in
    ``repro_torch.core.semiring`` (None: the kernels on the card).
    """

    _kinds = ("bfs", "sssp", "bc")
    _service_name = "sharded"

    def __init__(self, initial_state: GraphState, mesh, *,
                 tile: int = TILE, use_kernel=None,
                 src_chunk: Optional[int] = None, bc_mode: str = "gather",
                 ring_depth: int = 8, batch_size: int = 32,
                 dirty_threshold: ThresholdSpec = None,
                 strict_order: bool = False,
                 coalesce: bool = False, max_collects: int = 16,
                 max_cached: int = 128,
                 telemetry: Optional[Telemetry] = None,
                 policy: Optional[ResiliencePolicy] = None,
                 journal=None, monitor=None, adaptive=None, breaker=None,
                 compact_every: Optional[int] = None):
        shard_queries._bc_kind(bc_mode, delta=False)  # validate up front
        self.mesh = as_graph_mesh(mesh)
        if (isinstance(self.mesh, DistMesh) and self.mesh.rank != 0
                and (journal is not None or monitor is not None)):
            raise ValueError(
                f"rank {self.mesh.rank}: on a DistMesh only rank 0 journals "
                "and runs the heartbeat monitor; pass journal=None and "
                "monitor=None on the other ranks")
        self.tile = tile
        self.use_kernel = use_kernel
        self.src_chunk = src_chunk
        self.bc_mode = bc_mode
        self._init_service(
            initial_state, ring_depth=ring_depth, batch_size=batch_size,
            dirty_threshold=dirty_threshold, strict_order=strict_order,
            coalesce=coalesce, max_collects=max_collects,
            max_cached=max_cached, telemetry=telemetry, policy=policy,
            journal=journal, monitor=monitor, adaptive=adaptive,
            breaker=breaker, compact_every=compact_every)
        self._view: Optional[ShardedTileView] = None
        self._view_version: int = -1
        self._collect_lock = threading.RLock()

    # ------------------------------- view --------------------------------

    def view(self) -> ShardedTileView:
        """The sharded tile grid at the latest version, refreshed per rank
        from the ring's dirty sets (full rebuild on resize / window loss).
        The refresh writes into the previous view in place."""
        with self._collect_lock:
            entry = self.ring.latest
            if self._view is not None and self._view_version == entry.version:
                return self._view
            dirty = None
            if self._view is not None:
                dirty = self.ring.dirty_between(self._view_version,
                                                entry.version)
            tracer = (self.telemetry.tracer if self.telemetry is not None
                      else None)
            rows0, disp0 = refresh_stats.rows, refresh_stats.dispatches
            with maybe_span(tracer, "tile_refresh",
                            service=self._service_name,
                            full=(self._view is None or dirty is None)) as sp:
                self._view = refresh_sharded_view(
                    entry.state, self._view, dirty, mesh=self.mesh,
                    tile=self.tile)
                sp.set(version=entry.version,
                       rows=refresh_stats.rows - rows0,
                       dispatches=refresh_stats.dispatches - disp0)
            self._view_version = entry.version
            return self._view

    # ------------------------------ queries ------------------------------

    def _key(self, kind: str, srcs) -> Tuple[str, tuple]:
        if srcs is None:
            return kind, ("all",)
        return kind, tuple(int(s) for s in
                           torch.atleast_1d(torch.as_tensor(srcs)).tolist())

    def _check_srcs(self, kind: str, srcs) -> None:
        if srcs is None and kind != "bc":
            raise ValueError(f"{kind!r} needs explicit sources")

    def _icn_validated(self, result) -> bool:
        return bool(result.agree)

    def _agree(self, value):
        """Rank 0's ``value`` on a ``DistMesh`` (a control message), else
        ``value``."""
        if isinstance(self.mesh, DistMesh):
            return self.mesh.broadcast(value)
        return value

    def serve_metrics(self, **kwargs):
        """An :class:`repro_torch.obs.expo.ExpoServer` over this service's
        telemetry (``kwargs``: ``port``, ``host``), or ``None`` on a rank
        other than 0 of a ``DistMesh``: one process serves ``/metrics``."""
        from repro_torch.obs.expo import ExpoServer

        if self.telemetry is None:
            raise ValueError("serve_metrics() needs telemetry= on the "
                             "service")
        if isinstance(self.mesh, DistMesh) and self.mesh.rank != 0:
            return None
        return ExpoServer(self.telemetry, journal=self.scheduler.journal,
                          **kwargs)

    def _delta_usable(self, kind: str, prior, state: GraphState) -> bool:
        """The sharded ``_prior_usable``: a same-vcap prior whose payload
        the delta path can certify (SSSP: no prior negative cycle).
        Per-source ``ok`` flips are fine -- a source that died poisons its
        whole tree, one that was dead re-relaxes cold, and a BC source that
        turned suspect restarts at cut 0."""
        if kind == "bc":
            return prior.level.shape[1] == state.vcap
        if prior.dist.shape[1] != state.vcap:
            return False
        return kind == "bfs" or not bool(prior.negcycle.any())

    def _revived_source(self, prior, srcs, state: GraphState) -> bool:
        """True when a source that was NOT ok at prior time is alive now:
        its cached row is empty, so no dirty vertex intersects it, yet it
        must be recomputed.  Conservative for SSSP, where ``ok`` also
        folds in the negative-cycle flag."""
        dev = prior.ok.device
        idx = (torch.arange(prior.ok.shape[0], dtype=torch.int32, device=dev)
               if srcs is None else torch.atleast_1d(torch.as_tensor(
                   srcs, dtype=torch.int32, device=dev)))
        alive_now = (state.alive[idx.clamp(0, state.vcap - 1).long()]
                     & (idx >= 0) & (idx < state.vcap))
        return bool((~prior.ok & alive_now).any())

    def _collect(self, kind: str, srcs, key, ladder: bool = True):
        """One collect against the latest ring version, climbing the
        unchanged -> delta -> full ladder (module docstring).

        ``ladder=False`` (a resilience retry) pins the latest version and
        dispatches the full distributed query directly -- no cache read, no
        dirty-set math -- so a failed delta path cannot poison the retry."""
        with self._collect_lock:
            return self._collect_locked(kind, srcs, key, ladder)

    def _collect_locked(self, kind: str, srcs, key, ladder: bool):
        if not ladder:
            entry = self.ring.latest
            with self.ring.pin(entry.version):
                res = self._full_collect(kind, srcs, entry.state)
            self._cache_store(key, entry.version, res)
            return entry, res, "full"
        entry = self.ring.latest
        state = entry.state
        slot = self._cache.get(key)
        mode, res, dirty = "full", None, None
        # A tripped breaker quarantines the cached prior: the clean full
        # path answers until half-open probes succeed.
        use_prior = slot is not None and self._breaker_allows(kind)
        try:
            if use_prior:
                prior = slot.result
                if slot.version == entry.version:
                    mode = "unchanged"
                else:
                    dirty = self.ring.dirty_between(slot.version,
                                                    entry.version)
                    union = _reached_union(kind, prior)
                    if dirty is not None and union.shape[0] == state.vcap:
                        n_dirty, touched = _dirty_stats(union, dirty)
                        frac = n_dirty / state.vcap
                        _trace_annotate(dirty=n_dirty,
                                        dirty_frac=round(frac, 6))
                        self._note_dirty_frac(frac)
                        if not touched and self._revived_source(prior, srcs,
                                                                state):
                            touched = True
                        if not touched:
                            mode = "unchanged"
                        elif (frac <= self._threshold(kind)
                              and self._delta_usable(kind, prior, state)):
                            mode = "delta"
            # The threshold reads the adaptive controller, which moves with
            # measured walls: every process takes rank 0's rung.
            mode = self._agree(mode)
            if mode == "unchanged":
                res = prior
            elif mode == "delta":
                res = self._delta_collect(kind, prior, dirty, srcs, state)
                if res is None:  # new negcycle: canonical full
                    mode = "full"
            if res is None:
                res = self._full_collect(kind, srcs, state)
        except InjectedCrash:
            raise
        except Exception:
            # conservative attribution: any failure while a usable prior
            # was in play counts against the kind's delta path
            if use_prior:
                self._breaker_failure(kind)
            raise
        if use_prior:
            self._breaker_success(kind, mode)
        self._cache_store(key, entry.version, res)
        return entry, res, mode

    def _full_collect(self, kind: str, srcs, state: GraphState):
        """Dispatch the full distributed query (the ladder's bottom rung)."""
        inject(P_COLLECT_DISPATCH)
        acct = self._acct_begin()
        res = _QUERIES[kind](
            self.view(), state, srcs,
            **(self._bc_kwargs() if kind == "bc" else {}),
            use_kernel=self.use_kernel, accountant=acct)
        self._acct_charge(acct)
        return res

    def _bc_kwargs(self) -> dict:
        return {"src_chunk": self.src_chunk, "bc_mode": self.bc_mode}

    def _delta_collect(self, kind: str, prior, dirty, srcs,
                       state: GraphState):
        """Run the distributed delta query; ``None`` = fall back to full
        (delta SSSP surfaced a negative cycle born since the prior)."""
        inject(P_COLLECT_DELTA)
        view = self.view()
        acct = self._acct_begin()
        res = _DELTA[kind](view, state, prior, dirty, srcs,
                           use_kernel=self.use_kernel, accountant=acct,
                           **(self._bc_kwargs() if kind == "bc" else {}))
        self._acct_charge(acct)
        if kind == "sssp" and bool(res.negcycle.any()):
            return None
        return res

    # --------------------------- batched analytics ------------------------

    def bc_scores(self):
        """Exact all-vertex betweenness centrality at the latest version via
        the distributed batched-Brandes path; dead slots are NaN.  Cached
        through the regular query cache (kind ``"bc"``, all sources), so a
        localized commit pays only the level-cut delta sweep.  Returns
        ``(scores f32[vcap], version)``."""
        reply = self.query("bc", None)
        state = self.ring.latest.state
        scores = torch.where(state.alive, reply.result.scores, torch.nan)
        return scores, reply.version
