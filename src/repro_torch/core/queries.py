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

The batched-dense variants run the sources at once as semiring products
(``semiring.py`` / ``repro_torch.kernels``).  ``bc_batched_dense`` is
ported; ``bfs_batched_dense`` and ``sssp_batched_dense`` wait for their
kernels (ROADMAP.md).
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


def bc(state: GraphState, v, sources=None, *, use_kernel=None,
       tile_view=None, src_chunk: int | None = None) -> torch.Tensor:
    """Betweenness centrality of ``v``: sum_s delta(s|v).

    ``sources`` defaults to every vertex slot (dead sources contribute 0).
    The sources run at once as semiring products (``bc_batched_dense``;
    the reference's per-source ``method="map"`` baseline is not ported).
    ``tile_view`` supplies the dense weights plus the tile-occupancy mask so
    the products skip empty tiles (the masked kernel); without it the
    products are dense (the dense kernel).  ``src_chunk`` bounds the
    S x V scratch.
    """
    dev = state.device
    v = torch.as_tensor(v, dtype=torch.int32, device=dev)
    if sources is None:
        sources = torch.arange(state.vcap, dtype=torch.int32, device=dev)
    sources = torch.as_tensor(sources, dtype=torch.int32, device=dev)
    vc = v.clamp(0, state.vcap - 1).long()
    ok = state.alive[vc]
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


# ------------------------- batched Brandes (BC) ---------------------------

def bc_sweep_ops(fwd_mm, bwd_mm, srcs: torch.Tensor, alive: torch.Tensor,
                 V: int, prior_level=None, prior_sigma=None, cut=None):
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
    """
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
    while bool(front.any()) and bool((lvl < V).any()):
        adds = fwd_mm(torch.where(front, sigma, 0.0))
        newly = (adds > 0) & (level < 0)
        sigma = torch.where(newly, adds, sigma)
        level = torch.where(newly, lvl[:, None] + 1, level)
        front, lvl = newly, lvl + 1

    # Backward phase, deepest level first: pulling the flow of the level
    # below across edges is a counting product against A^T.
    sig_safe = torch.where(sigma > 0, sigma, 1.0)
    delta = torch.zeros_like(sigma)
    for l in range(int(level.max()) - 1, -1, -1):
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
                     cut: torch.Tensor | None = None):
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
    select the level-cut warm start (see ``bc_sweep_ops``).
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
                          prior_sigma=prior_sigma, cut=cut)


def bc_batched_ops(fwd_mm, bwd_mm, srcs: torch.Tensor, alive: torch.Tensor,
                   V: int, *, src_chunk: int | None = None,
                   prior_level: torch.Tensor | None = None,
                   prior_sigma: torch.Tensor | None = None,
                   cut: torch.Tensor | None = None):
    """The chunked batched-Brandes loop over abstract semiring products:
    one full forward+backward ``bc_sweep_ops`` per source chunk, each
    chunk's results written into preallocated ``[S, V]`` outputs."""
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
                            prior_level, prior_sigma, cut)
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
                           cut[part] if warm else None)
        for dst, src in zip((delta, sigma, level, ok), out):
            dst[part] = src
    return delta, sigma, level, ok
