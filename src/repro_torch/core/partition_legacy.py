"""LEGACY distributed graph engine: round-robin *edge* sharding (port of
``repro.core.partition_legacy``).

Superseded by the sharded tile-grid engine (``repro_torch.shard``, fronted
by ``core.partition.make_distributed_query``), which shards the tile rows
instead.  Kept as the independent cross-implementation ORACLE of the
distributed tests (two decompositions agreeing on the same snapshot) -- do
not grow new features here.  No kernel runs here.

The decomposition:

  * **edges are split** over the ranks of a graph mesh: each rank owns
    ``ecap / n`` contiguous slots of the sorted edge table (a contiguous
    key range, like one Ligra partition);
  * **vertex arrays are replicated**, so every rank validates liveness
    locally;
  * each BFS/SSSP level does local edge-parallel work then ONE collective
    of a vcap-sized vector (``pmax`` of int8 hits, the f32 min-merge) --
    collective bytes per query O(levels x vcap), independent of E.
"""
from __future__ import annotations

import torch

from .graph_state import INF, NOKEY, GraphState
from .queries import _scatter_any, _scatter_min, _set_at


def _edge_views(alive, esrc, edst, ew):
    vcap = alive.shape[0]
    live = (esrc != NOKEY) & (ew < INF)
    srcc = torch.where(live, esrc.clamp(0, vcap - 1), 0).long()
    dstc = torch.where(live, edst.clamp(0, vcap - 1), 0).long()
    return live & alive[srcc] & alive[dstc], srcc, dstc


def _src_ok(alive, src):
    vcap = alive.shape[0]
    return alive[src.clamp(0, vcap - 1).long()] & (src >= 0) & (src < vcap)


def _bfs_sharded(g, alive, ecnt, esrc, edst, ew, src):
    """Distributed BFS over this rank's edges: per level the ONLY
    collective is a pmax of an int8[vcap] hit mask; the BFS-tree parents
    are reconstructed after the fixed point with one edge-parallel pass and
    one int32 min-merge."""
    vcap = alive.shape[0]
    live, srcc, dstc = _edge_views(alive, esrc, edst, ew)
    reached = _set_at(torch.zeros((vcap,), dtype=torch.bool,
                                  device=alive.device), src,
                      _src_ok(alive, src))
    dist = torch.where(reached, 0, -1).to(torch.int32)
    frontier, lvl = reached, 0
    while bool(frontier.any()) and lvl < vcap:
        act = live & frontier[srcc]
        hit_local = _scatter_any(vcap, dstc, act).to(torch.int8)
        newly = (g.pmax(hit_local) > 0) & ~reached  # one int8 pmax a level
        dist = torch.where(newly, lvl + 1, dist)
        reached, frontier, lvl = reached | newly, newly, lvl + 1
    # parents: any tree edge dist[dst] == dist[src] + 1, min-src tie-break
    tree_e = live & (dist[dstc] == dist[srcc] + 1) & (dist[srcc] >= 0)
    par_local = _scatter_min(vcap, dstc, torch.where(
        tree_e, srcc.to(torch.int32), NOKEY), NOKEY)
    parent = -g.pmax(-par_local)
    parent = torch.where(reached & (dist > 0), parent, NOKEY)
    return reached, dist, parent, torch.where(reached, ecnt, 0)


def _sssp_sharded(g, alive, ecnt, esrc, edst, ew, src):
    """Distributed Bellman-Ford over this rank's edges: per pass one f32
    min-merge; ``negcycle`` from one more pass."""
    vcap = alive.shape[0]
    live, srcc, dstc = _edge_views(alive, esrc, edst, ew)
    w = torch.where(live, ew, INF)
    ok = _src_ok(alive, src)
    dist = _set_at(torch.full((vcap,), INF, device=alive.device), src,
                   torch.where(ok, 0.0, INF))

    def relax(d):
        cand_local = _scatter_min(vcap, dstc, torch.where(
            live, d[srcc] + w, INF), INF)
        return torch.minimum(d, -g.pmax(-cand_local))  # global min-merge

    changed, it = True, 0
    while changed and it < vcap:
        nd = relax(dist)
        changed = bool((nd < dist).any())
        dist, it = nd, it + 1
    negcycle = (relax(dist) < dist).any()
    reached = dist < INF
    return reached, dist, negcycle, torch.where(reached, ecnt, 0)


def shard_edges(state: GraphState, n_shards: int) -> GraphState:
    """Pad the edge table so ``ecap`` divides evenly across ranks."""
    rem = (-state.ecap) % n_shards
    if rem == 0:
        return state
    pad = lambda x, v: torch.cat([x, x.new_full((rem,), v)])  # noqa: E731
    return state._replace(esrc=pad(state.esrc, NOKEY),
                          edst=pad(state.edst, NOKEY),
                          ew=pad(state.ew, INF))


_IN_LAYOUTS = ("replicated", "replicated", "split", "split", "split",
               "replicated")


def make_distributed_query(mesh, query: str = "bfs"):
    """The edge-sharded distributed query for ``mesh``: ``(fn, in_layouts,
    out_layouts)`` with ``fn(alive, ecnt, esrc, edst, ew, src)``; the edge
    arrays are split over the ranks (``ecap`` a multiple of the rank count:
    ``shard_edges``), the vertex arrays and the outputs replicated."""
    from repro_torch.shard.queries import _launch
    from repro_torch.shard.tile_shard import as_graph_mesh

    gmesh = as_graph_mesh(mesh)
    body = {"bfs": _bfs_sharded, "sssp": _sssp_sharded}[query]
    layouts = (_IN_LAYOUTS, ("replicated",) * 4)

    def fn(alive, ecnt, esrc, edst, ew, src):
        src = torch.as_tensor(src, dtype=torch.int32, device=alive.device)
        return _launch(gmesh, body, layouts,
                       (alive, ecnt, esrc, edst, ew, src))[0]

    return fn, layouts[0], layouts[1]


def distributed_query_specs(vcap: int, ecap: int, mesh):
    """The arguments of the legacy fn, allocated nowhere (see
    ``partition.distributed_query_specs``)."""
    from repro_torch.shard.queries import ArgSpec
    from repro_torch.shard.tile_shard import as_graph_mesh

    n = as_graph_mesh(mesh).size
    ecap_p = ecap + ((-ecap) % n)
    spec = ArgSpec
    return (
        spec((vcap,), torch.bool, "replicated", (vcap,)),
        spec((vcap,), torch.int32, "replicated", (vcap,)),
        spec((ecap_p,), torch.int32, "split", (ecap_p // n,)),
        spec((ecap_p,), torch.int32, "split", (ecap_p // n,)),
        spec((ecap_p,), torch.float32, "split", (ecap_p // n,)),
        spec((), torch.int32, "replicated", ()),
    )
