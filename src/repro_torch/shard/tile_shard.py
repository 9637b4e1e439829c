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
reads them concatenated through ``gather_view``.  On a
:class:`~.dist.DistMesh` each process holds only its own rank's band and
occupancy rows (``None`` in the other ranks' slots), and ``gather_view``
and ``sharded_occupancy_stats`` gather through the process group.

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
from repro_torch.core.tiles import TILE, TileView, _tile_counts
from repro_torch.obs import CounterStruct
from repro_torch.obs.trace import host_read

from .dist import DistGroup, DistMesh
from .group import GraphMesh, as_graph_mesh

GRAPH_AXIS = "graph"  # the reference's axis name; a GraphMesh has one axis


def _padded_dim(vcap: int, tile: int, n_shards: int) -> int:
    chunk = tile * n_shards
    return -(-vcap // chunk) * chunk


def local_ranks(mesh) -> tuple:
    """The ranks whose bands this process holds: every rank of a
    :class:`~.group.GraphMesh`, this process's own of a
    :class:`~.dist.DistMesh`."""
    if isinstance(mesh, DistMesh):
        return (mesh.rank,)
    return tuple(range(mesh.size))


@dataclass(frozen=True)
class ShardedTileView:
    """Row-sharded blocked adjacency snapshot.

    ``w[i]`` / ``occ[i]`` live on ``mesh.devices[i]``: rows ``[i * vp/n,
    (i+1) * vp/n)`` of the padded dense weights (f32, +inf = no edge) and
    rows ``[i * nt/n, (i+1) * nt/n)`` of the int32 occupancy grid.  On a
    ``DistMesh`` only this process's rank's slots hold tensors; the
    others are ``None``.
    """

    w: tuple    # n x f32[Vp/n, Vp]
    occ: tuple  # n x int32[nt/n, nt]
    mesh: GraphMesh
    tile: int

    @property
    def _mine(self) -> int:
        """The first slot this process holds."""
        return local_ranks(self.mesh)[0]

    @property
    def vp(self) -> int:
        return self.w[self._mine].shape[1]

    @property
    def n_tiles(self) -> int:
        return self.occ[self._mine].shape[1]

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def band(self) -> int:
        """Rows of ``w`` owned by one rank."""
        return self.w[self._mine].shape[0]

    @property
    def rows_per_shard(self) -> int:
        """Tile rows owned by one rank."""
        return self.occ[self._mine].shape[0]


def _gathered(view: ShardedTileView, bands) -> torch.Tensor:
    """Every rank's band of ``bands`` (a slot tuple of ``view``),
    concatenated on the first local rank's device."""
    if isinstance(view.mesh, DistMesh):
        return DistGroup(view.mesh).merge(bands[view.mesh.rank])
    dev = view.mesh.devices[0]
    return torch.cat([b.to(dev) for b in bands])


def sharded_occupancy_stats(view: ShardedTileView) -> dict:
    """Host-side summary incl. the per-rank tile-skip rates the kernels
    realise on each band."""
    occ = _gathered(view, view.occ).cpu()
    bands = occ.split(view.rows_per_shard)
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
    """The sharded view as one ``TileView`` on rank 0's device (on a
    ``DistMesh``: on every process's own; test oracle / debugging; O(Vp^2)
    copy)."""
    return TileView(_gathered(view, view.w), _gathered(view, view.occ))


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
    """Full O(vcap^2 + ecap) derivation, one band per rank of ``mesh``
    (on a ``DistMesh``, this process's rank's only)."""
    mesh = as_graph_mesh(mesh)
    n = mesh.size
    vp = _padded_dim(state.vcap, tile, n)
    band, rows = vp // n, vp // (n * tile)
    live = live_edge_mask(state)
    src, dst, w = state.esrc[live], state.edst[live], state.ew[live]
    bands = [(None, None)] * n
    for i in local_ranks(mesh):
        bands[i] = _build_band(src, dst, w, i, band, rows, vp, tile,
                               mesh.devices[i])
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


def _dirty_tile_rows(dirty: torch.Tensor, nt: int, tile: int) -> torch.Tensor:
    pad = nt * tile - dirty.shape[0]
    return torch.cat([dirty, dirty.new_zeros(pad)]).view(nt, tile).any(dim=1)


def dirty_row_windows(state: GraphState, dirty: torch.Tensor, nt: int,
                      tile: int):
    """Host-side refresh plan from a dirty-vertex set.

    ``None`` means more than half the tile rows moved -- a full rebuild is
    cheaper; otherwise the (possibly empty) list of ``(row, lo, hi)``
    segments of the sorted edge table to re-derive, one per dirty tile row.
    """
    rows = host_read(torch.nonzero, _dirty_tile_rows(dirty, nt, tile)).flatten()
    if rows.numel() > nt // 2:
        return None
    if rows.numel() == 0:
        return []
    bounds = rows.to(torch.int32) * tile
    los = torch.searchsorted(state.esrc, bounds)
    his = torch.searchsorted(state.esrc, bounds + (tile - 1), right=True)
    return [(int(r), int(lo), int(hi)) for r, lo, hi in
            zip(host_read(torch.Tensor.tolist, rows),
                host_read(torch.Tensor.tolist, los),
                host_read(torch.Tensor.tolist, his))]


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
    all in one scatter: row ``k`` of the batch scatters the live edges of
    its segment of the sorted edge table into slab ``k`` of one
    ``[K * tile, Vp]`` buffer (scatter-min is order-free, so each slab
    equals the matching rows of a full build)."""
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

    The host-side plan is ``dirty_row_windows``'s: no dirty tile row
    returns ``prev``; a few dirty rows are re-derived by their owning ranks
    (up to ``REFRESH_BATCH`` rows of one rank per dispatch); more than half
    the rows moved -- or a resize, a mesh or tile change, or no dirty info
    -- rebuilds from scratch.  The row path writes into ``prev``'s bands
    IN PLACE (where the reference donates them): the call CONSUMES
    ``prev``.  Tallies accumulate in ``refresh_stats``: the rows and
    dispatches of the bands this process holds.
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
    mine = local_ranks(mesh)
    for rank, segs in _batched_plan(plan, prev.rows_per_shard):
        if rank in mine:
            _refresh_rows(state, prev.w[rank], prev.occ[rank], rank, segs,
                          tile)
            refresh_stats.dispatches += 1
            refresh_stats.rows += len(segs)
    return ShardedTileView(prev.w, prev.occ, mesh, tile)
