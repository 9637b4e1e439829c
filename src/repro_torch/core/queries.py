"""The graph queries: BFS, SSSP (+negative-cycle check), BC (port of
``repro.core.queries``).

Non-recursive traversals become *edge-parallel frontier fixed points*:

  * BFS  -- boolean frontier expansion (scatter-or per level);
  * SSSP -- Bellman-Ford relax to fixed point; the loop's own exit state is
            the paper's CHECKNEGCYCLE;
  * BC   -- Brandes: forward level/sigma counting, backward dependency
            accumulation per level.

Each ``lax.while_loop`` of the reference is a Python loop here whose
condition the host reads once per pass.  The COO queries scatter over the
live edges only: a dead slot's contribution is the scatter's identity in
the reference, so skipping it changes nothing.

Float sums are deterministic: sigma and the BC dependency are summed per
vertex by ``torch.segment_reduce`` over edges grouped by that vertex, in a
fixed order, never by atomics in an order that changes from run to run.
That is what lets a delta BC answer equal a fresh ``bc_dependencies``
bit for bit on the card.

The lane forms (``bfs_lanes``, ``sssp_lanes``, ``bc_dependencies_lanes``)
answer L single-source queries in one loop, the counterpart of the
reference's ``jax.vmap`` over its while loops (``repro.serve.batch``): one
sequence of ops over ``L * vcap`` outputs per pass and one host read per
pass for every lane, each lane bit-identical to its single-source call.

The batched-dense variants run the sources at once as semiring products
(``semiring.py`` / ``repro_torch.kernels``): ``bfs_batched_dense`` one
boolean product per level, ``sssp_batched_dense`` one min-plus product per
relax pass, ``bc_batched_dense`` counting products per level.  Each loop
reads its condition on the host once per level or pass, and each
``*_batched_ops`` form takes the product as an abstract function, so a
caller can observe or replace it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import semiring
from .graph_state import INF, NOKEY, GraphState, densify, live_edge_mask
from .tiles import dense_views_from_tiles


class BFSResult(NamedTuple):
    ok: torch.Tensor        # bool[]  source was alive
    reached: torch.Tensor   # bool[vcap]
    dist: torch.Tensor      # int32[vcap]  (-1 = unreached)
    parent: torch.Tensor    # int32[vcap]  (NOKEY = none; BFS-tree edges)


class SSSPResult(NamedTuple):
    ok: torch.Tensor        # bool[]  source alive and no negative cycle
    negcycle: torch.Tensor  # bool[]
    dist: torch.Tensor      # f32[vcap]  (+inf = unreachable)
    parent: torch.Tensor    # int32[vcap]


class BCResult(NamedTuple):
    ok: torch.Tensor        # bool[]
    delta: torch.Tensor     # f32[vcap]  dependencies delta(s|v) of source s
    sigma: torch.Tensor     # f32[vcap]  shortest-path counts from s
    level: torch.Tensor     # int32[vcap]


class LiveEdges(NamedTuple):
    """The live edges of a snapshot, in the table's (src, dst) order."""

    src: torch.Tensor   # int64[E]
    dst: torch.Tensor   # int64[E]
    w: torch.Tensor     # f32[E]


def live_edges(state: GraphState) -> LiveEdges:
    live = live_edge_mask(state)
    return LiveEdges(state.esrc[live].long(), state.edst[live].long(),
                     state.ew[live])


def _src_ok(state: GraphState, src: torch.Tensor) -> torch.Tensor:
    vcap = state.vcap
    return state.alive[src.clamp(0, vcap - 1).long()] & (src >= 0) \
        & (src < vcap)


def _as_src(state: GraphState, src) -> torch.Tensor:
    return torch.as_tensor(src, dtype=torch.int32, device=state.device)


def _set_at(base: torch.Tensor, src: torch.Tensor,
            value: torch.Tensor) -> torch.Tensor:
    """``base.at[src].set(value, mode="drop")`` for a scalar ``src``: the
    write happens only when ``src`` is in range (no host sync)."""
    out = base.clone()
    n = base.shape[0]
    idx = src.clamp(0, n - 1).long()
    out[idx] = torch.where((src >= 0) & (src < n), value.to(base.dtype),
                           out[idx])
    return out


def _pick(ok: torch.Tensor, yes, no) -> torch.Tensor:
    return torch.where(ok, torch.tensor(yes, device=ok.device),
                       torch.tensor(no, device=ok.device))


def _scatter_min(n: int, index: torch.Tensor, vals: torch.Tensor,
                 fill) -> torch.Tensor:
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, index, vals, "amin")


def _scatter_any(n: int, index: torch.Tensor, flags: torch.Tensor):
    out = torch.zeros((n,), dtype=torch.int32, device=flags.device)
    return out.index_add_(0, index, flags.to(torch.int32)) > 0


class _Segments(NamedTuple):
    """Edges grouped by one endpoint, for deterministic per-vertex sums."""

    order: torch.Tensor | None  # gather order (None: already grouped)
    lengths: torch.Tensor       # int64[vcap] edges per vertex

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        if self.order is not None:
            vals = vals[self.order]
        return torch.segment_reduce(vals, "sum", lengths=self.lengths)


def _segments(index: torch.Tensor, vcap: int, grouped: bool) -> _Segments:
    order = None if grouped else torch.sort(index, stable=True).indices
    return _Segments(order, torch.bincount(index, minlength=vcap))


#: lane rows of a lane segment sum start on this many elements (128 bytes)
_LANE_ALIGN = 32


class _LaneSegments(NamedTuple):
    """``_Segments.sum`` for every row of ``vals[L, E]`` in one reduction.

    The rows are laid end to end, lane-major, and each row is padded by one
    extra segment to a multiple of ``_LANE_ALIGN`` elements.  Every (lane,
    vertex) segment then holds the same values in the same order, at the
    same address alignment, as that vertex's segment of the single-source
    sum: the card's segmented reduction chooses its load path from the
    alignment of a segment's start, and with it the order of the float sum.
    """

    order: torch.Tensor | None
    lengths: torch.Tensor       # int64[L * (vcap + 1)]
    pad: int

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        if self.order is not None:
            vals = vals[:, self.order]
        if self.pad:
            vals = torch.nn.functional.pad(vals, (0, self.pad))
        L = vals.shape[0]
        out = torch.segment_reduce(vals.reshape(-1), "sum",
                                   lengths=self.lengths)
        return out.view(L, -1)[:, :-1]


def _lane_segments(seg: _Segments, lanes: int, n_edges: int) -> _LaneSegments:
    pad = -n_edges % _LANE_ALIGN
    lengths = torch.cat([seg.lengths, seg.lengths.new_tensor([pad])])
    return _LaneSegments(seg.order, lengths.repeat(lanes), pad)


def _lane_index(index: torch.Tensor, lanes: int, vcap: int) -> torch.Tensor:
    """Flat ``lane * vcap + index`` targets (int64 ``[lanes * E]``), so one
    scatter over ``lanes * vcap`` outputs serves every lane."""
    off = torch.arange(lanes, device=index.device) * vcap
    return (off[:, None] + index[None, :]).reshape(-1)


def _set_rows(base: torch.Tensor, srcs: torch.Tensor,
              value: torch.Tensor) -> torch.Tensor:
    """``_set_at`` per row: row ``i`` gets ``value[i]`` at ``srcs[i]`` when
    that source is in range."""
    out = base.clone()
    n = base.shape[1]
    rows = torch.arange(base.shape[0], device=base.device)
    idx = srcs.clamp(0, n - 1).long()
    out[rows, idx] = torch.where((srcs >= 0) & (srcs < n),
                                 value.to(base.dtype), out[rows, idx])
    return out


# --------------------------------- BFS -----------------------------------

def bfs(state: GraphState, src) -> BFSResult:
    src = _as_src(state, src)
    vcap = state.vcap
    e = live_edges(state)
    ok = _src_ok(state, src)

    reached = _set_at(torch.zeros((vcap,), dtype=torch.bool,
                                  device=state.device), src, ok)
    dist = torch.where(reached, 0, -1).to(torch.int32)
    parent = torch.full((vcap,), NOKEY, dtype=torch.int32,
                        device=state.device)
    frontier, lvl = reached, 0
    while lvl < vcap and bool(frontier.any()):
        act = frontier[e.src]
        hit = _scatter_any(vcap, e.dst, act)
        newly = hit & ~reached
        cand_par = _scatter_min(vcap, e.dst, torch.where(
            act, e.src.to(torch.int32), NOKEY), NOKEY)
        parent = torch.where(newly, cand_par, parent)
        dist = torch.where(newly, lvl + 1, dist)
        reached = reached | newly
        frontier, lvl = newly, lvl + 1
    return BFSResult(ok, reached, dist, parent)


def bfs_lanes(state: GraphState, srcs) -> BFSResult:
    """``bfs`` from each of ``srcs`` (``int32[L]``) at once: every field
    gains a leading lane axis and lane ``i`` equals ``bfs(state, srcs[i])``
    bit for bit.

    One pass computes every lane and keeps a finished lane's carry as it
    was (what ``jax.vmap`` of the reference's ``lax.while_loop`` does); the
    host reads whether any lane is still active once per pass.
    """
    srcs = _as_src(state, srcs)
    vcap, L, dev = state.vcap, srcs.shape[0], state.device
    e = live_edges(state)
    ok = _src_ok(state, srcs)
    idx = _lane_index(e.dst, L, vcap)
    e_src = e.src.to(torch.int32)

    reached = _set_rows(torch.zeros((L, vcap), dtype=torch.bool, device=dev),
                        srcs, ok)
    dist = torch.where(reached, 0, -1).to(torch.int32)
    parent = torch.full((L, vcap), NOKEY, dtype=torch.int32, device=dev)
    frontier = reached
    lvl = torch.zeros((L,), dtype=torch.int32, device=dev)
    active = frontier.any(dim=1) & (lvl < vcap)
    while bool(active.any()):
        act = frontier[:, e.src]
        hit = _scatter_any(L * vcap, idx, act.reshape(-1)).view(L, vcap)
        newly = hit & ~reached & active[:, None]
        cand_par = _scatter_min(L * vcap, idx, torch.where(
            act, e_src, NOKEY).reshape(-1), NOKEY).view(L, vcap)
        parent = torch.where(newly, cand_par, parent)
        dist = torch.where(newly, lvl[:, None] + 1, dist)
        reached = reached | newly
        frontier = torch.where(active[:, None], newly, frontier)
        lvl = lvl + active.to(torch.int32)
        active = frontier.any(dim=1) & (lvl < vcap)
    return BFSResult(ok, reached, dist, parent)


# --------------------------------- SSSP ----------------------------------

def _relax_once(dist, e: LiveEdges, vcap: int):
    cand = _scatter_min(vcap, e.dst, dist[e.src] + e.w, INF)
    return torch.minimum(dist, cand)


def relax_fixpoint(dist0: torch.Tensor, e: LiveEdges, vcap: int):
    """Bellman-Ford label-correcting fixed point from admissible upper bounds.

    Returns ``(dist, changed-at-exit, iterations)``.  Shared by ``sssp``
    and the engine's delta queries (``repro_torch.engine.incremental``) so
    their bit-identical guarantee rests on one relax pass.
    """
    dist, changed, it = dist0, True, 0
    while changed and it < vcap:
        nd = _relax_once(dist, e, vcap)
        changed = bool((nd < dist).any())
        dist, it = nd, it + 1
    return dist, changed, it


def sssp(state: GraphState, src) -> SSSPResult:
    src = _as_src(state, src)
    vcap = state.vcap
    e = live_edges(state)
    ok_src = _src_ok(state, src)
    dist0 = _set_at(torch.full((vcap,), INF, device=state.device), src,
                    _pick(ok_src, 0.0, INF))

    dist, changed, _ = relax_fixpoint(dist0, e, vcap)
    # CHECKNEGCYCLE for free: the fixed point only exits still-changed when
    # the vcap-th pass improved something, i.e. iff a negative cycle is
    # reachable.
    negcycle = torch.tensor(changed, device=state.device)
    parent = sssp_tree_parents(state, dist[None], src[None])[0]
    return SSSPResult(ok_src & ~negcycle, negcycle, dist, parent)


def relax_fixpoint_lanes(dist0: torch.Tensor, e: LiveEdges, vcap: int):
    """``relax_fixpoint`` for each row of ``dist0`` (``f32[L, vcap]``).

    Returns ``(dist, changed-at-exit bool[L], iterations int32[L])``; row
    ``i`` runs exactly the passes the single-source loop would, at most
    ``vcap``, and a row that stopped keeps its distances unchanged.
    """
    L, dev = dist0.shape[0], dist0.device
    idx = _lane_index(e.dst, L, vcap)
    dist = dist0
    changed = torch.ones((L,), dtype=torch.bool, device=dev)
    it = torch.zeros((L,), dtype=torch.int32, device=dev)
    active = changed & (it < vcap)
    while bool(active.any()):
        cand = _scatter_min(L * vcap, idx, (dist[:, e.src] + e.w).reshape(-1),
                            INF).view(L, vcap)
        nd = torch.minimum(dist, cand)
        changed = torch.where(active, (nd < dist).any(dim=1), changed)
        dist = torch.where(active[:, None], nd, dist)
        it = it + active.to(torch.int32)
        active = changed & (it < vcap)
    return dist, changed, it


def sssp_lanes(state: GraphState, srcs) -> SSSPResult:
    """``sssp`` from each of ``srcs`` at once (see ``bfs_lanes``); each
    lane's ``negcycle`` is its own relax loop's exit state."""
    srcs = _as_src(state, srcs)
    vcap, L = state.vcap, srcs.shape[0]
    e = live_edges(state)
    ok_src = _src_ok(state, srcs)
    dist0 = _set_rows(torch.full((L, vcap), INF, device=state.device), srcs,
                      _pick(ok_src, 0.0, INF))
    dist, negcycle, _ = relax_fixpoint_lanes(dist0, e, vcap)
    parent = sssp_tree_parents(state, dist, srcs)
    return SSSPResult(ok_src & ~negcycle, negcycle, dist, parent)


# ---------------------------------- BC -----------------------------------

def _bc_coo_sweep(e: LiveEdges, vcap: int, level0, sigma0, front0, lvl0: int):
    """Brandes forward + backward over COO edges from a (possibly warm) start.

    Shared body of ``bc_dependencies`` (cold start: source frontier at
    level 0) and the engine's level-cut ``delta_bc`` (warm start: the prior
    forward tree above the cut, frontier at ``cut - 1``).  Warm starts give
    bit-identical results because the loop state at pass ``lvl0`` equals
    the cold run's state at that pass, and every sum is deterministic.
    """
    by_dst = _segments(e.dst, vcap, grouped=False)
    by_src = _segments(e.src, vcap, grouped=True)  # the table is src-sorted

    level, sigma, frontier, lvl = level0, sigma0, front0, lvl0
    while lvl < vcap and bool(frontier.any()):
        act = frontier[e.src]
        hit = _scatter_any(vcap, e.dst, act)
        newly = hit & (level < 0)
        adds = by_dst.sum(torch.where(act, sigma[e.src], 0.0))
        sigma = torch.where(newly, adds, sigma)
        level = torch.where(newly, lvl + 1, level)
        frontier, lvl = newly, lvl + 1

    # Backward phase: delta[u] += sum over tree edges (u,w) at level l->l+1
    # of sigma[u]/sigma[w] * (1 + delta[w]), from the deepest level down.
    sig_src = sigma[e.src]
    sig_dst = torch.where(sigma[e.dst] > 0, sigma[e.dst], 1.0)
    lev_src, lev_dst = level[e.src], level[e.dst]
    delta = torch.zeros((vcap,), dtype=torch.float32, device=sigma.device)
    for l in range(int(level.max()), -1, -1):
        on_lvl = (lev_src == l) & (lev_dst == l + 1)
        contrib = torch.where(on_lvl, sig_src / sig_dst * (1.0 + delta[e.dst]),
                              0.0)
        delta = delta + by_src.sum(contrib)
    delta = torch.where(level == 0, 0.0, delta)  # source contributes nothing
    return level, sigma, delta


def bc_dependencies(state: GraphState, src) -> BCResult:
    """Brandes single-source dependency accumulation delta(src | .)."""
    src = _as_src(state, src)
    vcap = state.vcap
    ok = _src_ok(state, src)
    level0 = _set_at(torch.full((vcap,), -1, dtype=torch.int32,
                                device=state.device), src, _pick(ok, 0, -1))
    sigma0 = _set_at(torch.zeros((vcap,), device=state.device), src,
                     _pick(ok, 1.0, 0.0))
    level, sigma, delta = _bc_coo_sweep(live_edges(state), vcap, level0,
                                        sigma0, level0 == 0, 0)
    return BCResult(ok, delta, sigma, level)


def _bc_coo_sweep_lanes(e: LiveEdges, vcap: int, level0, sigma0, front0,
                        lvl0: torch.Tensor):
    """``_bc_coo_sweep`` for each row of ``level0``/``sigma0``/``front0``
    (``[L, vcap]``), row ``i`` resuming at its own pass ``lvl0[i]``.

    The forward loop keeps a finished lane's carry as it was.  The backward
    loop runs from the deepest level of any lane and adds to a lane only
    from its own deepest level down, so each lane sums the same terms in the
    same order as the single-source sweep (``_LaneSegments``).
    """
    L, dev = level0.shape[0], level0.device
    n_edges = e.src.shape[0]
    by_dst = _lane_segments(_segments(e.dst, vcap, grouped=False), L, n_edges)
    by_src = _lane_segments(_segments(e.src, vcap, grouped=True), L, n_edges)
    idx = _lane_index(e.dst, L, vcap)

    level, sigma, frontier, lvl = level0, sigma0, front0, lvl0
    active = frontier.any(dim=1) & (lvl < vcap)
    while bool(active.any()):
        act = frontier[:, e.src]
        hit = _scatter_any(L * vcap, idx, act.reshape(-1)).view(L, vcap)
        newly = hit & (level < 0) & active[:, None]
        adds = by_dst.sum(torch.where(act, sigma[:, e.src], 0.0))
        sigma = torch.where(newly, adds, sigma)
        level = torch.where(newly, lvl[:, None] + 1, level)
        frontier = torch.where(active[:, None], newly, frontier)
        lvl = lvl + active.to(torch.int32)
        active = frontier.any(dim=1) & (lvl < vcap)

    sig_src = sigma[:, e.src]
    sig_dst = torch.where(sigma[:, e.dst] > 0, sigma[:, e.dst], 1.0)
    lev_src, lev_dst = level[:, e.src], level[:, e.dst]
    deepest = level.amax(dim=1)
    delta = torch.zeros((L, vcap), dtype=torch.float32, device=dev)
    for l in range(int(deepest.max()), -1, -1):
        on_lvl = (lev_src == l) & (lev_dst == l + 1)
        contrib = torch.where(
            on_lvl, sig_src / sig_dst * (1.0 + delta[:, e.dst]), 0.0)
        delta = torch.where((deepest >= l)[:, None],
                            delta + by_src.sum(contrib), delta)
    delta = torch.where(level == 0, 0.0, delta)  # source contributes nothing
    return level, sigma, delta


def bc_dependencies_lanes(state: GraphState, srcs) -> BCResult:
    """``bc_dependencies`` from each of ``srcs`` at once (see
    ``bfs_lanes``), bit for bit, ``delta`` included."""
    srcs = _as_src(state, srcs)
    vcap, L, dev = state.vcap, srcs.shape[0], state.device
    ok = _src_ok(state, srcs)
    level0 = _set_rows(torch.full((L, vcap), -1, dtype=torch.int32,
                                  device=dev), srcs, _pick(ok, 0, -1))
    sigma0 = _set_rows(torch.zeros((L, vcap), device=dev), srcs,
                       _pick(ok, 1.0, 0.0))
    level, sigma, delta = _bc_coo_sweep_lanes(
        live_edges(state), vcap, level0, sigma0, level0 == 0,
        torch.zeros((L,), dtype=torch.int32, device=dev))
    return BCResult(ok, delta, sigma, level)


def bc_level_cut(prior_level: torch.Tensor, dirty: torch.Tensor,
                 alive: torch.Tensor) -> torch.Tensor:
    """Shallowest forward level a dirty set can have poisoned, per source.

    ``prior_level`` is ``int32[vcap]`` (one source) or ``int32[S, vcap]``
    (batched; ``dirty``/``alive`` broadcast over sources).  Levels strictly
    below the returned cut are untouched: a dirty vertex at prior level
    ``l`` can disturb levels ``>= l + 1`` through its out-edges, or level
    ``l`` itself only by dying.  Untouched sources get a cut past every
    level (pure reuse); a cut of 0 means the source itself is suspect.
    """
    reached = prior_level >= 0
    d = dirty & reached
    died = d & ~alive
    big = prior_level.shape[-1] + 1  # deeper than any level
    c1 = torch.where(died, prior_level, big).amin(dim=-1)
    c2 = torch.where(d, prior_level + 1, big).amin(dim=-1)
    return torch.minimum(c1, c2).to(torch.int32)


# ------------------------ traversal-tree parents ---------------------------

def _tree_parents(state: GraphState, tree: torch.Tensor, e: LiveEdges,
                  srcs: torch.Tensor) -> torch.Tensor:
    """Min-source parent over ``tree`` edges (``bool[S, E]``), per row."""
    S = tree.shape[0]
    vals = torch.where(tree, e.src.to(torch.int32)[None, :], NOKEY)
    parent = torch.full((S, state.vcap), NOKEY, dtype=torch.int32,
                        device=state.device)
    parent.scatter_reduce_(1, e.dst[None, :].expand(S, -1), vals, "amin")
    rows = torch.arange(S, device=state.device)
    parent[rows, srcs.clamp(0, state.vcap - 1).long()] = NOKEY
    return parent


def bfs_tree_parents(state: GraphState, dist: torch.Tensor,
                     srcs: torch.Tensor) -> torch.Tensor:
    """Canonical BFS-tree parents from final distances, batched over sources.

    ``dist`` is ``int32[S, vcap]`` (-1 unreached); returns ``int32[S, vcap]``
    parents identical to per-source ``bfs``: the min-source over tree edges
    ``dist[u] + 1 == dist[v]`` reproduces the per-level min-source
    candidate.
    """
    e = live_edges(state)
    distf = torch.where(dist >= 0, dist.float(), INF)
    tree = ((distf[:, e.src] + 1.0 == distf[:, e.dst])
            & (distf[:, e.src] < INF))
    parent = _tree_parents(state, tree, e, srcs)
    return torch.where(dist >= 0, parent, NOKEY)


def sssp_tree_parents(state: GraphState, dist: torch.Tensor,
                      srcs: torch.Tensor) -> torch.Tensor:
    """Tight-edge parents from final distances, batched over sources: any
    tight edge ``dist[v] == dist[u] + w(u, v)``, min source id as
    tie-break."""
    e = live_edges(state)
    tree = ((dist[:, e.dst] == dist[:, e.src] + e.w)
            & (dist[:, e.src] < INF))
    return _tree_parents(state, tree, e, srcs)


def bc_map(state: GraphState, v, sources) -> torch.Tensor:
    """Per-source Brandes baseline: ``bc_dependencies`` of each source in
    turn, summed (the reference's ``lax.map``).  Kept as the oracle and
    baseline of ``bc``'s batched path."""
    vc = int(torch.as_tensor(v).clamp(0, state.vcap - 1))
    total = torch.zeros((), dtype=torch.float32, device=state.device)
    for s in torch.as_tensor(sources, dtype=torch.int32).reshape(-1).tolist():
        r = bc_dependencies(state, s)
        total = total + torch.where(r.ok, r.delta[vc], 0.0)
    return total


def bc(state: GraphState, v, sources=None, *, method: str = "batched",
       use_kernel=None, tile_view=None,
       src_chunk: int | None = None) -> torch.Tensor:
    """Betweenness centrality of ``v``: sum_s delta(s|v).

    ``sources`` defaults to every vertex slot (dead sources contribute 0).
    The default ``method="batched"`` runs the sources at once as semiring
    products (``bc_batched_dense``); ``method="map"`` is the per-source
    baseline ``bc_map``.  ``tile_view`` supplies the dense weights plus the
    tile-occupancy mask so the products skip empty tiles (the masked
    kernel); without it the products are dense (the dense kernel).
    ``src_chunk`` bounds the S x V scratch.
    """
    dev = state.device
    v = torch.as_tensor(v, dtype=torch.int32, device=dev)
    if sources is None:
        sources = torch.arange(state.vcap, dtype=torch.int32, device=dev)
    sources = torch.as_tensor(sources, dtype=torch.int32, device=dev)
    vc = v.clamp(0, state.vcap - 1).long()
    ok = state.alive[vc]
    if method == "map":
        return torch.where(ok, bc_map(state, v, sources), math.nan)
    if method != "batched":
        raise ValueError(f"unknown bc method {method!r}")
    tile = 128
    if tile_view is not None:
        adj_mask, _, alive = dense_views_from_tiles(state, tile_view)
        amask, tile = tile_view.occ, tile_view.tile
    else:
        adj_mask, _, alive = dense_views(state)
        amask = None
    delta, _, _, src_ok = bc_batched_dense(
        adj_mask, sources, alive, use_kernel=use_kernel, amask=amask,
        tile=tile, src_chunk=src_chunk)
    vals = torch.where(src_ok, delta[:, vc], 0.0)
    return torch.where(ok, vals.sum(), math.nan)


def dense_views(state: GraphState):
    """Snapshot -> (adjacency mask, dense weights, alive) for batched queries."""
    w = densify(state)
    return w < INF, w, state.alive


# ------------------------ dense batched BFS / SSSP -------------------------
# The sources at once as semiring products: the card's arithmetic path, and
# the "static parallel analytics" (Ligra-style) baseline of the paper's
# study.

def _source_rows(srcs: torch.Tensor, alive: torch.Tensor, V: int):
    """``one_hot(srcs) * alive[srcs]``: f32 [S, V] with a 1 at each live
    in-range source (an out-of-range source gives a zero row, as
    ``jax.nn.one_hot`` does)."""
    srcs = torch.as_tensor(srcs, device=alive.device).long()
    srcc = srcs.clamp(0, V - 1)
    ok = alive[srcc] & (srcs >= 0) & (srcs < V)
    rows = torch.zeros((srcs.shape[0], V), dtype=torch.float32,
                       device=alive.device)
    return rows.scatter_(1, srcc[:, None], ok[:, None].float())


def bfs_batched_ops(mm, srcs: torch.Tensor, alive: torch.Tensor, V: int):
    """Multi-source BFS over an abstract boolean product ``mm(front)``
    (``front @ A > 0`` as f32 {0,1} for the live adjacency ``A``).
    Returns ``dist`` int32 [S, V] (-1 = unreached)."""
    front = _source_rows(srcs, alive, V)
    dist = torch.where(front > 0, 0, -1).to(torch.int32)
    lvl = 0
    while lvl < V and bool((front > 0).any()):
        newly = (mm(front) > 0) & (dist < 0)
        dist = torch.where(newly, lvl + 1, dist)
        front, lvl = newly.float(), lvl + 1
    return dist


def bfs_batched_dense(adj_mask: torch.Tensor, srcs: torch.Tensor,
                      alive: torch.Tensor, use_kernel=None,
                      amask: torch.Tensor | None = None, tile: int = 128):
    """Multi-source BFS over a dense adjacency mask.  Returns dist[S, V].

    One ``bool_mm`` of the frontier against the live adjacency per level.
    ``amask``: optional tile-occupancy grid of the adjacency (see
    ``repro_torch.core.tiles``) -- empty tiles are skipped by the product.
    ``use_kernel`` as in ``semiring.bool_mm``.
    """
    V = adj_mask.shape[0]
    a = (adj_mask & alive[:, None] & alive[None, :]).float()
    mm = semiring.bool_mm_against(a, use_kernel=use_kernel, amask=amask,
                                  tile=tile)
    return bfs_batched_ops(mm, srcs, alive, V)


def sssp_batched_ops(mm, srcs: torch.Tensor, alive: torch.Tensor, V: int):
    """Multi-source Bellman-Ford over an abstract min-plus product
    ``mm(dist)`` (``min_k dist[:, k] + W[k, :]`` for the live weights).
    Returns ``(dist f32 [S, V], negcycle bool [S])``.

    The paper's CHECKNEGCYCLE comes from the loop's own exit state: row s
    of the per-source ``changed`` vector is still True at exit only when
    the V-th relax pass improved that source's distances, which happens
    iff a negative cycle is reachable from s.
    """
    dist = torch.where(_source_rows(srcs, alive, V) > 0, 0.0, INF)
    changed = torch.ones((dist.shape[0],), dtype=torch.bool,
                         device=alive.device)
    it = 0
    while it < V and bool(changed.any()):
        nd = torch.minimum(dist, mm(dist))
        changed = (nd < dist).any(dim=1)
        dist, it = nd, it + 1
    return dist, changed


def sssp_batched_dense(w_dense: torch.Tensor, srcs: torch.Tensor,
                       alive: torch.Tensor, use_kernel=None,
                       amask: torch.Tensor | None = None, tile: int = 128):
    """Multi-source Bellman-Ford over dense weights.  Returns
    ``(dist[S, V], negcycle[S])``.

    One ``minplus_mm`` of the distances against the live weights per relax
    pass, at most V passes.  ``amask`` and ``use_kernel`` as in
    ``bfs_batched_dense``.
    """
    V = w_dense.shape[0]
    big = torch.where(alive[:, None] & alive[None, :], w_dense, INF)
    mm = semiring.minplus_mm_against(big, use_kernel=use_kernel, amask=amask,
                                     tile=tile)
    return sssp_batched_ops(mm, srcs, alive, V)


# ------------------------- batched Brandes (BC) ---------------------------

def bc_sweep_ops(fwd_mm, bwd_mm, srcs: torch.Tensor, alive: torch.Tensor,
                 V: int, prior_level=None, prior_sigma=None, cut=None,
                 sync_any=None, sync_max=None):
    """One forward+backward Brandes sweep over *abstract* semiring products.

    The sweep only calls ``fwd_mm(x)`` (``x @ A`` for the frontier-masked
    sigma ``x: f32[S, V]``) and ``bwd_mm(g)`` (``g @ A^T`` for the
    dependency flow).  Levels and sigma are exact integers in f32 (< 2^24),
    so they are bit-identical across providers; only ``delta`` sees f32
    reassociation.

    ``prior_level``/``prior_sigma``/``cut`` warm-start the forward sweep per
    source (the level-cut delta-BC path): levels strictly below ``cut[s]``
    are reused and source ``s`` resumes from its frontier at ``cut[s] - 1``;
    a cut of 0 restarts that source cold, a cut past every level reuses
    its whole tree.  Each row's state at its resume pass equals the cold
    run's, so levels/sigma -- and the full backward sweep -- reproduce the
    cold call bit for bit.

    ``sync_any`` / ``sync_max`` (default: identity) merge the host-side
    loop controls -- the forward loop's "more levels" flag and the deepest
    level -- across whatever the products span.  A provider whose products
    contain collectives (the sharded ring, ``repro_torch.shard.queries``)
    must run its level loops in lock-step on every rank, so it passes
    reductions over the ranks here; a rank's extra iterations are exact
    no-ops (empty frontiers add zeros, flows of absent levels are zero).
    """
    if sync_any is None:
        sync_any = lambda p: p  # noqa: E731
    if sync_max is None:
        sync_max = lambda x: x  # noqa: E731
    S = srcs.shape[0]
    dev = alive.device
    srcc = srcs.clamp(0, V - 1).long()
    ok = alive[srcc] & (srcs >= 0) & (srcs < V)
    cold_front = torch.zeros((S, V), dtype=torch.float32, device=dev)
    cold_front.scatter_(1, srcc[:, None], ok[:, None].float())
    level = torch.where(cold_front > 0, 0, -1).to(torch.int32)
    sigma = cold_front
    lvl = torch.zeros((S,), dtype=torch.int32, device=dev)
    if prior_level is not None:
        cut = torch.as_tensor(cut, dtype=torch.int32, device=dev).expand(S)
        # A now-ok source whose prior tree is EMPTY (dead when the prior
        # was computed, resurrected since) looks untouched to the level
        # cut but must restart cold.
        rows = torch.arange(S, device=dev)
        revived = ok & (prior_level[rows, srcc] < 0)
        cut = torch.where(revived, 0, cut)
        warm = (cut >= 1)[:, None]
        keep = warm & (prior_level >= 0) & (prior_level < cut[:, None])
        level = torch.where(warm, torch.where(keep, prior_level, -1), level)
        sigma = torch.where(warm, torch.where(keep, prior_sigma, 0.0), sigma)
        lvl = (cut - 1).clamp(min=0)
    front = level == lvl[:, None]

    # Forward phase: one counting product per level does both jobs --
    # frontier sigma is >= 1 on every frontier vertex and counts are exact
    # integers, so adds > 0 is precisely the frontier hit.
    while sync_any(bool(front.any()) and bool((lvl < V).any())):
        adds = fwd_mm(torch.where(front, sigma, 0.0))
        newly = (adds > 0) & (level < 0)
        sigma = torch.where(newly, adds, sigma)
        level = torch.where(newly, lvl[:, None] + 1, level)
        front, lvl = newly, lvl + 1

    # Backward phase, deepest level first: pulling the flow of the level
    # below across edges is a counting product against A^T.
    sig_safe = torch.where(sigma > 0, sigma, 1.0)
    delta = torch.zeros_like(sigma)
    for l in range(sync_max(int(level.max())) - 1, -1, -1):
        g = torch.where(level == l + 1, (1.0 + delta) / sig_safe, 0.0)
        pulled = bwd_mm(g)
        delta = delta + torch.where(level == l, sigma * pulled, 0.0)
    delta = torch.where(level == 0, 0.0, delta)  # sources contribute nothing
    return delta, sigma, level, ok


def bc_batched_dense(adj_mask: torch.Tensor, srcs: torch.Tensor,
                     alive: torch.Tensor, use_kernel=None,
                     amask: torch.Tensor | None = None, tile: int = 128,
                     src_chunk: int | None = None,
                     prior_level: torch.Tensor | None = None,
                     prior_sigma: torch.Tensor | None = None,
                     cut: torch.Tensor | None = None,
                     sync_any=None, sync_max=None):
    """Multi-source Brandes as level-synchronous counting products.

    Forward: per level one ``count_mm`` of the frontier sigma against the
    adjacency ``A`` (levels + shortest-path counts).  Backward: per level
    one ``count_mm`` of the dependency flow against ``A^T``.  Levels and
    sigma match per-source ``bc_dependencies`` bit-exactly; delta agrees
    up to float summation order.

    Returns ``(delta[S,V], sigma[S,V], level[S,V], ok[S])``.

    ``amask``: optional tile-occupancy grid of the adjacency -- both sweeps
    skip empty tiles (the transposed sweep uses the transposed grid).
    ``use_kernel`` as in ``semiring.count_mm``.  ``src_chunk``: process
    the source axis in chunks (the tail may be ragged); per-source results
    do not depend on the chunking.  ``prior_level``/``prior_sigma``/``cut``
    select the level-cut warm start, ``sync_any``/``sync_max`` the
    lock-step hooks (see ``bc_sweep_ops``).
    """
    a = (adj_mask & alive[:, None] & alive[None, :]).float()
    at = a.t().contiguous()  # transposed once per call, not per level
    amask_t = None if amask is None else amask.t().contiguous()
    # both operands and their block masks are prepared once per call
    fwd_mm = semiring.count_mm_against(a, use_kernel=use_kernel, amask=amask,
                                       tile=tile)
    bwd_mm = semiring.count_mm_against(at, use_kernel=use_kernel,
                                       amask=amask_t, tile=tile)
    return bc_batched_ops(fwd_mm, bwd_mm, srcs, alive, a.shape[0],
                          src_chunk=src_chunk, prior_level=prior_level,
                          prior_sigma=prior_sigma, cut=cut,
                          sync_any=sync_any, sync_max=sync_max)


def bc_batched_ops(fwd_mm, bwd_mm, srcs: torch.Tensor, alive: torch.Tensor,
                   V: int, *, src_chunk: int | None = None,
                   prior_level: torch.Tensor | None = None,
                   prior_sigma: torch.Tensor | None = None,
                   cut: torch.Tensor | None = None,
                   sync_any=None, sync_max=None):
    """The chunked batched-Brandes loop over abstract semiring products:
    one full forward+backward ``bc_sweep_ops`` per source chunk, each
    chunk's results written into preallocated ``[S, V]`` outputs.
    ``sync_any``/``sync_max`` reach every chunk's sweep."""
    S = srcs.shape[0]
    warm = prior_level is not None
    if warm:
        if prior_sigma is None or cut is None:
            raise ValueError("warm start needs prior_level, prior_sigma "
                             "and cut together")
        cut = torch.as_tensor(cut, dtype=torch.int32,
                              device=alive.device).expand(S)
    if src_chunk is None or src_chunk >= S:
        return bc_sweep_ops(fwd_mm, bwd_mm, srcs, alive, V,
                            prior_level, prior_sigma, cut,
                            sync_any, sync_max)
    if src_chunk < 1:
        raise ValueError(f"src_chunk must be >= 1, got {src_chunk}")
    dev = alive.device
    delta = torch.empty((S, V), dtype=torch.float32, device=dev)
    sigma = torch.empty((S, V), dtype=torch.float32, device=dev)
    level = torch.empty((S, V), dtype=torch.int32, device=dev)
    ok = torch.empty((S,), dtype=torch.bool, device=dev)
    for lo in range(0, S, src_chunk):
        part = slice(lo, lo + src_chunk)
        out = bc_sweep_ops(fwd_mm, bwd_mm, srcs[part], alive, V,
                           prior_level[part] if warm else None,
                           prior_sigma[part] if warm else None,
                           cut[part] if warm else None,
                           sync_any, sync_max)
        for dst, src in zip((delta, sigma, level, ok), out):
            dst[part] = src
    return delta, sigma, level, ok
