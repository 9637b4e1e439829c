"""Blocked adjacency view of a snapshot: dense tiles + live-edge occupancy
(port of ``repro.core.tiles``).

  * ``w``   -- the dense weight matrix padded up to a whole number of tiles
    (+inf = no edge), the operand the kernels consume;
  * ``occ`` -- the ``(Vp/T) x (Vp/T)`` int32 grid of live-edge counts per
    tile.  ``occ[i, j] == 0`` iff tile ``(i, j)`` is all-identity, the
    contract the tile-skipping kernels and the blocked plain fallbacks
    require of their ``amask``.

``build_tile_view`` derives both from a snapshot, in one fill and one
scatter; ``dense_views_from_tiles`` reads the dense views off a view.
"""
from __future__ import annotations

from operator import getitem
from typing import NamedTuple

import torch

from repro_torch.obs.trace import host_read

from .graph_state import INF, GraphState, live_edge_mask, scatter_min_dense

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


def dense_views_from_tiles(state: GraphState, view: TileView):
    """TileView -> (adj mask, weights, alive) shaped like ``dense_views``.

    Slices the padding back off; the batched queries re-pad internally and
    the occupancy grid stays aligned because padding restores the same Vp.
    """
    w = view.w[:state.vcap, :state.vcap]
    return w < INF, w, state.alive
