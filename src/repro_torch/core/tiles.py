"""Blocked adjacency view of a snapshot: dense tiles + live-edge occupancy
(port of ``repro.core.tiles``).

  * ``w``   -- the dense weight matrix padded up to a whole number of tiles
    (+inf = no edge), the operand the kernels consume;
  * ``occ`` -- the ``(Vp/T) x (Vp/T)`` int32 grid of live-edge counts per
    tile.  ``occ[i, j] == 0`` iff tile ``(i, j)`` is all-identity, the
    contract the tile-skipping kernels and the blocked plain fallbacks
    require of their ``amask``.

``build_tile_view`` derives both from scratch.  ``refresh_tile_view``
re-derives only the tile rows holding a dirty vertex: every change to the
dense matrix lives in a dirty row (an edge mutation bumps ``ecnt`` at the
edge's source, and RemV bumps the source of every incident edge it kills).
"""
from __future__ import annotations

from operator import getitem
from typing import NamedTuple

import torch

from repro_torch.obs.trace import host_read

from .graph_state import INF, NOKEY, GraphState, live_edge_mask, \
    scatter_min_dense

TILE = 128  # default tile edge


class TileView(NamedTuple):
    """Blocked adjacency snapshot: padded dense weights + tile occupancy."""

    w: torch.Tensor    # f32[Vp, Vp]   dense weights, +inf = no edge, Vp % T == 0
    occ: torch.Tensor  # int32[nt, nt] live-edge count per (src-tile, dst-tile)

    @property
    def vp(self) -> int:
        return self.w.shape[0]

    @property
    def n_tiles(self) -> int:
        return self.occ.shape[0]

    @property
    def tile(self) -> int:
        return self.vp // self.occ.shape[0]


def _padded_dim(vcap: int, tile: int) -> int:
    return -(-vcap // tile) * tile


def active_tile_mask(view: TileView) -> torch.Tensor:
    """bool[nt, nt]: tiles holding at least one live edge."""
    return view.occ > 0


def occupancy_stats(view: TileView) -> dict:
    """Host-side summary: how much of the tile grid the kernels can skip."""
    occ = view.occ.cpu()
    total = int(occ.numel())
    active = int((occ > 0).sum())
    return {
        "tile": view.tile,
        "grid": [view.n_tiles, view.n_tiles],
        "tiles_total": total,
        "tiles_active": active,
        "tile_skip_rate": (total - active) / total if total else 0.0,
        "live_edges": int(occ.sum()),
    }


def _tile_counts(rows: torch.Tensor, cols: torch.Tensor, nr: int,
                 nc: int) -> torch.Tensor:
    """int32[nr, nc] histogram of (row, col) pairs (integer adds: exact in
    any order)."""
    flat = rows.long() * nc + cols.long()
    out = torch.zeros((nr * nc,), dtype=torch.int32, device=rows.device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out.view(nr, nc)


def build_tile_view(state: GraphState, tile: int = TILE) -> TileView:
    """Full O(vcap^2 + ecap) derivation of the blocked view from a snapshot."""
    vp = _padded_dim(state.vcap, tile)
    nt = vp // tile
    live = live_edge_mask(state)
    src = host_read(getitem, state.esrc, live)
    dst = host_read(getitem, state.edst, live)
    w = scatter_min_dense(src, dst, host_read(getitem, state.ew, live),
                          (vp, vp))
    occ = _tile_counts(src // tile, dst // tile, nt, nt)
    return TileView(w, occ)


def row_window_slab(esrc: torch.Tensor, edst: torch.Tensor,
                    ew: torch.Tensor, alive: torch.Tensor, r: int, lo: int,
                    hi: int, *, tile: int, vp: int, nt: int):
    """Re-derive global tile row ``r``: scatter-min its live edges into a
    fresh identity ``tile x vp`` slab (bit-identical to the full build --
    min is order-free) plus the matching ``1 x nt`` occupancy row.

    O(row) instead of O(graph) because the edge table is sorted by
    ``(src, dst)``: row ``r``'s edges are the contiguous segment
    ``[lo, hi)`` (host-computed by searchsorted).  The reference scans a
    power-of-two window around it so one compiled program covers many
    rows; eager PyTorch takes the exact segment.
    """
    vcap = alive.shape[0]
    es, ed, ws = esrc[lo:hi], edst[lo:hi], ew[lo:hi]
    live = ((es != NOKEY) & (ws < INF)
            & alive[es.clamp(0, vcap - 1).long()]
            & alive[ed.clamp(0, vcap - 1).long()])
    in_row = live & (es // tile == r)
    src, dst = host_read(getitem, es, in_row), host_read(getitem, ed, in_row)
    slab = scatter_min_dense(src - r * tile, dst,
                             host_read(getitem, ws, in_row), (tile, vp))
    occ_row = _tile_counts(torch.zeros_like(dst), dst // tile, 1, nt)
    return slab, occ_row


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


def refresh_tile_view(state: GraphState, prev: TileView | None,
                      dirty: torch.Tensor | None,
                      tile: int = TILE) -> TileView:
    """Incremental rebuild from a dirty-vertex set (full rebuild fallback).

    ``dirty`` must cover every vertex whose out-edge list or liveness
    changed since ``prev`` was derived (a superset only costs time) -- the
    version ring's ``dirty_between`` provides exactly that.  No dirty tile
    row returns ``prev`` as-is; a few dirty rows re-derive only those rows;
    more than half the rows moved, a resized vertex table, or no dirty
    info rebuilds in full.

    The row path writes into ``prev.w`` / ``prev.occ`` IN PLACE (where the
    reference donates the buffers): the call CONSUMES ``prev``, and the
    caller holds only the returned view afterwards, as
    ``GraphService.tile_view`` does.
    """
    if (prev is None or dirty is None
            or prev.vp != _padded_dim(state.vcap, tile)
            or prev.tile != tile  # same vp, different grid: occ would corrupt
            or dirty.shape[0] != state.vcap):
        return build_tile_view(state, tile)
    plan = dirty_row_windows(state, dirty, prev.n_tiles, tile)
    if plan is None:
        return build_tile_view(state, tile)
    w, occ = prev.w, prev.occ
    for r, lo, hi in plan:
        slab, occ_row = row_window_slab(
            state.esrc, state.edst, state.ew, state.alive, r, lo, hi,
            tile=tile, vp=w.shape[0], nt=occ.shape[0])
        w[r * tile:(r + 1) * tile] = slab
        occ[r:r + 1] = occ_row
    return TileView(w, occ)


def dense_views_from_tiles(state: GraphState, view: TileView):
    """TileView -> (adj mask, weights, alive) shaped like ``dense_views``.

    Slices the padding back off; the batched queries re-pad internally and
    the occupancy grid stays aligned because padding restores the same Vp.
    """
    w = view.w[:state.vcap, :state.vcap]
    return w < INF, w, state.alive
