"""Sharded tile grid: the ``TileView`` partitioned over a graph mesh (port
of ``repro.shard.tile_shard``).

The blocked adjacency of ``repro_torch.core.tiles`` is sharded by **tile
rows**: rank ``i`` of an ``n``-rank :class:`~.group.GraphMesh` owns a
contiguous band of source vertices -- ``Vp/n`` rows of the padded dense
weights plus the matching ``nt/n`` rows of the occupancy grid -- as
tensors on its own device.  Row sharding is the natural cut for
level-synchronous semiring queries: a frontier product against the band
is entirely local (the band's occupancy grid is exactly the ``amask`` the
masked kernels accept), and one vcap-sized collective per level merges the
partial frontiers (``repro_torch.shard.queries``).

Where the reference keeps one global ``jax.Array`` sharded ``P(axis,
None)``, the view here holds the bands themselves, one per rank; host code
reads them concatenated through ``gather_view``.

``build_sharded_view`` derives each band from a snapshot, on its rank's
device (``vcap`` padded up to a multiple of ``n * tile`` so whole tile rows
land on each rank).  ``refresh_sharded_view`` is the incremental path: the
version ring's dirty-vertex sets name the disturbed tile rows, and the
rank owning a dirty row re-derives it in place, up to ``REFRESH_BATCH``
rows of one rank in one dispatch -- a small commit costs O(row), never an
O(Vp^2) rebuild.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graph_state import INF, NOKEY, GraphState, \
    live_edge_mask, scatter_min_dense
from repro_torch.core.tiles import TILE, TileView, _tile_counts, \
    dirty_row_windows
from repro_torch.obs import CounterStruct

from .group import GraphMesh, as_graph_mesh

GRAPH_AXIS = "graph"  # the reference's axis name; a GraphMesh has one axis


def _padded_dim(vcap: int, tile: int, n_shards: int) -> int:
    chunk = tile * n_shards
    return -(-vcap // chunk) * chunk


@dataclass(frozen=True)
class ShardedTileView:
    """Row-sharded blocked adjacency snapshot.

    ``w[i]`` / ``occ[i]`` live on ``mesh.devices[i]``: rows ``[i * vp/n,
    (i+1) * vp/n)`` of the padded dense weights (f32, +inf = no edge) and
    rows ``[i * nt/n, (i+1) * nt/n)`` of the int32 occupancy grid.
    """

    w: tuple    # n x f32[Vp/n, Vp]
    occ: tuple  # n x int32[nt/n, nt]
    mesh: GraphMesh
    tile: int

    @property
    def vp(self) -> int:
        return self.w[0].shape[1]

    @property
    def n_tiles(self) -> int:
        return self.occ[0].shape[1]

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def band(self) -> int:
        """Rows of ``w`` owned by one rank."""
        return self.w[0].shape[0]

    @property
    def rows_per_shard(self) -> int:
        """Tile rows owned by one rank."""
        return self.occ[0].shape[0]


def sharded_occupancy_stats(view: ShardedTileView) -> dict:
    """Host-side summary incl. the per-rank tile-skip rates the kernels
    realise on each band."""
    bands = [o.cpu() for o in view.occ]
    occ = torch.cat(bands)
    total = int(occ.numel())
    active = int((occ > 0).sum())
    per_shard = [round(float((b == 0).float().mean()) if b.numel() else 0.0,
                       4) for b in bands]
    return {
        "tile": view.tile,
        "grid": [view.n_tiles, view.n_tiles],
        "n_shards": view.n_shards,
        "tiles_total": total,
        "tiles_active": active,
        "tile_skip_rate": (total - active) / total if total else 0.0,
        "per_shard_tile_skip_rate": per_shard,
        "live_edges": int(occ.sum()),
    }


def gather_view(view: ShardedTileView) -> TileView:
    """The sharded view as one ``TileView`` on rank 0's device (test
    oracle / debugging; O(Vp^2) copy)."""
    dev = view.mesh.devices[0]
    return TileView(torch.cat([b.to(dev) for b in view.w]),
                    torch.cat([b.to(dev) for b in view.occ]))


# ------------------------------- build ------------------------------------

def _build_band(src, dst, w, rank: int, band: int, rows: int, vp: int,
                tile: int, device: torch.device):
    """Rank ``rank``'s band from the live edges (scatter-min is order-free,
    so the band equals the matching rows of a single-device build)."""
    lo = rank * band
    own = (src >= lo) & (src < lo + band)
    s, d, ww = (x[own].to(device) for x in (src, dst, w))
    nt = vp // tile
    wb = scatter_min_dense(s - lo, d, ww, (band, vp))
    ob = _tile_counts(s // tile - rank * rows, d // tile, rows, nt)
    return wb, ob


def build_sharded_view(state: GraphState, mesh,
                       tile: int = TILE) -> ShardedTileView:
    """Full O(vcap^2 + ecap) derivation, one band per rank of ``mesh``."""
    mesh = as_graph_mesh(mesh)
    n = mesh.size
    vp = _padded_dim(state.vcap, tile, n)
    band, rows = vp // n, vp // (n * tile)
    live = live_edge_mask(state)
    src, dst, w = state.esrc[live], state.edst[live], state.ew[live]
    bands = [_build_band(src, dst, w, i, band, rows, vp, tile, dev)
             for i, dev in enumerate(mesh.devices)]
    return ShardedTileView(tuple(b[0] for b in bands),
                           tuple(b[1] for b in bands), mesh, tile)


# ------------------------------ refresh -----------------------------------

REFRESH_BATCH = 8  # max dirty tile rows of one rank re-derived per dispatch


class RefreshStats(CounterStruct):
    """Per-process tallies of ``refresh_sharded_view``: ``rows`` dirty tile
    rows refreshed, in ``dispatches`` batched re-derivations (one per row
    would be ``rows``), and ``rebuilds`` full builds.  The values are
    ``shard_refresh_*`` counters in a
    :class:`repro_torch.obs.MetricsRegistry`; benchmarks read the deltas
    around a call."""

    _FIELDS = ("rows", "dispatches", "rebuilds")
    _PREFIX = "shard_refresh_"


refresh_stats = RefreshStats()


def _batched_plan(plan, rows_per_shard: int):
    """Group the ``(row, lo, hi)`` segments by owning rank, in chunks of up
    to ``REFRESH_BATCH`` rows: ``[(rank, [(row, lo, hi), ...]), ...]``."""
    by_rank: dict = {}
    for seg in plan:
        by_rank.setdefault(seg[0] // rows_per_shard, []).append(seg)
    return [(rank, segs[i:i + REFRESH_BATCH])
            for rank, segs in sorted(by_rank.items())
            for i in range(0, len(segs), REFRESH_BATCH)]


def _refresh_rows(state: GraphState, w_band: torch.Tensor,
                  occ_band: torch.Tensor, rank: int, segs, tile: int) -> None:
    """Re-derive the tile rows ``segs`` of rank ``rank``'s band in place,
    all in one scatter: row ``k`` of the batch scatters its edge segment
    (``row_window_slab``'s derivation) into slab ``k`` of one
    ``[K * tile, Vp]`` buffer."""
    rows, nt = occ_band.shape
    vp = w_band.shape[1]
    dev = w_band.device
    lengths = np.asarray([hi - lo for _, lo, hi in segs], np.int64)
    idx = torch.as_tensor(np.concatenate(
        [np.arange(lo, hi) for _, lo, hi in segs]), device=state.device)
    es, ed, ws = (x[idx].to(dev) for x in (state.esrc, state.edst, state.ew))
    alive = state.alive.to(dev)
    vcap = alive.shape[0]
    slot = torch.repeat_interleave(
        torch.arange(len(segs), device=dev),
        torch.as_tensor(lengths, device=dev))
    live = ((es != NOKEY) & (ws < INF)
            & alive[es.clamp(0, vcap - 1).long()]
            & alive[ed.clamp(0, vcap - 1).long()])
    es, ed, ws, slot = es[live], ed[live], ws[live], slot[live]
    k = len(segs)
    slabs = scatter_min_dense(slot * tile + es % tile, ed, ws, (k * tile, vp))
    occ_rows = _tile_counts(slot, ed // tile, k, nt)
    local = torch.as_tensor([r - rank * rows for r, _, _ in segs],
                            device=dev)
    w_band.view(rows, tile, vp)[local] = slabs.view(k, tile, vp)
    occ_band[local] = occ_rows


def refresh_sharded_view(state: GraphState, prev: ShardedTileView | None,
                         dirty: torch.Tensor | None, *, mesh=None,
                         tile: int | None = None) -> ShardedTileView:
    """Incremental rebuild from a dirty-vertex set (full rebuild fallback).

    The same host-side strategy pick as ``core.tiles.refresh_tile_view``:
    no dirty tile row returns ``prev``; a few dirty rows are re-derived by
    their owning ranks (up to ``REFRESH_BATCH`` rows of one rank per
    dispatch); more than half the rows moved -- or a resize, a mesh or tile
    change, or no dirty info -- rebuilds from scratch.  The row path writes
    into ``prev``'s bands IN PLACE (where the reference donates them): the
    call CONSUMES ``prev``.  Tallies accumulate in ``refresh_stats``.
    """
    if prev is not None:
        mesh = mesh or prev.mesh
        tile = tile or prev.tile
    if mesh is None:
        raise ValueError("refresh_sharded_view needs a mesh when prev is None")
    mesh = as_graph_mesh(mesh)
    tile = tile or TILE
    if (prev is None or dirty is None
            or prev.mesh != mesh
            or prev.tile != tile
            or prev.vp != _padded_dim(state.vcap, tile, mesh.size)
            or dirty.shape[0] != state.vcap):
        refresh_stats.rebuilds += 1
        return build_sharded_view(state, mesh, tile)
    plan = dirty_row_windows(state, dirty, prev.n_tiles, tile)
    if plan is None:
        refresh_stats.rebuilds += 1
        return build_sharded_view(state, mesh, tile)
    if not plan:
        return prev
    for rank, segs in _batched_plan(plan, prev.rows_per_shard):
        _refresh_rows(state, prev.w[rank], prev.occ[rank], rank, segs, tile)
        refresh_stats.dispatches += 1
    refresh_stats.rows += len(plan)
    return ShardedTileView(prev.w, prev.occ, mesh, tile)
