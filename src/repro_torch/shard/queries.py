"""Distributed tile-sparse queries: BFS / SSSP / BC over the sharded grid
(port of ``repro.shard.queries``).

Each query runs one per-rank body on every rank of the graph mesh
(:meth:`~.group.ThreadGroup.run`, the counterpart of the reference's
``shard_map`` program).  Per level a rank does **local** tile-skipping
semiring work against its band of the
:class:`~repro_torch.shard.tile_shard.ShardedTileView` -- the masked
``bool_mm`` / ``minplus_mm`` / ``count_mm`` products of
``repro_torch.core.semiring`` (the Hopper kernels on the card), with the
band's occupancy grid as ``amask`` -- followed by ONE vcap-sized collective
merging the partial frontiers:

  * BFS   -- int8 ``pmax`` of the per-band frontier hits (S x Vp bytes a
             level); the product is ``bool_mm_masked`` at
             ``[S, band] x [band, Vp]`` with mask ``[nt/n, nt]``;
  * SSSP  -- f32 min-merge (``-pmax(-x)``) of the per-band relax candidates
             (4 x S x Vp bytes a level); ``minplus_mm_masked`` at the same
             band shape;
  * BC    -- the **source axis** is sharded instead, each rank running the
             chunked batched-Brandes sweep over its own S/n sources, with one
             final psum merging the per-vertex scores.  ``bc_mode`` picks how
             a rank sees the adjacency: ``"gather"`` all-gathers the row
             bands once per query (the full grid per rank, no per-level
             collective; ``count_mm_masked`` at ``[chunk, Vp] x [Vp, Vp]``),
             ``"ring"`` keeps only the rank's own band and rotates the bands
             around the mesh (``ppermute``), one revolution per product,
             partial products accumulating (forward, ``[chunk, band] x
             [band, Vp]``, mask ``[nt/n, nt]``) or assembling (backward,
             ``[chunk, Vp] x [Vp, band]`` on the transposed band, mask
             ``[nt, nt/n]``) between hops (``_ring_mms``).

Every query returns ``agree``: true iff every rank computed from the same
committed ``version`` (psum-validated, as in the reference).

Results are bit-identical to the single-device batched path on the same
snapshot: BFS levels are exact integers; the SSSP min-merge is order-free;
BC levels/sigma are exact integer counts.  Only BC ``delta`` and the
scores reassociate across ranks.

**Delta queries** (``delta_bfs_sharded`` / ``delta_sssp_sharded`` /
``delta_bc_sharded``): the stale-region analysis runs unsharded on rank 0's
device (per-vertex work with no collective: the engine's ``_poison`` for
SSSP, the level cut ``bc_level_cut`` for BFS and BC), and the recompute
warm-starts the sharded level loop.  Every delta result is bit-identical to
the full sharded recompute and to the local engine's delta path.

Tensors that the reference keeps replicated on every device are copied to
every rank's device (``_share``; a no-op on one card), and the per-rank
outputs come back to rank 0's device, where the snapshot is expected to
live.  On a :class:`~.dist.DistMesh` (one process per rank) everything is
this process's: each process passes its own replicated inputs and its own
band, runs its rank's body once (:class:`~.dist.DistGroup`), keeps its own
replicated outputs, and receives the split outputs from every rank (a
merge counted in the group's ``moved``, not in its collective bytes); the
unsharded helper math then runs in every process on the same inputs.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import semiring
from repro_torch.core.graph_state import INF, GraphState
from repro_torch.core.queries import (
    _scatter_any,
    _set_rows,
    bc_batched_dense,
    bc_batched_ops,
    bc_level_cut,
    bfs_tree_parents,
    live_edges,
    sssp_tree_parents,
)
from repro_torch.obs.profile import _tensors

from .dist import DistGroup, DistMesh
from .group import ThreadGroup
from .tile_shard import ShardedTileView, local_ranks


class ShardedBFSResult(NamedTuple):
    ok: torch.Tensor        # bool[S]      source was alive
    dist: torch.Tensor      # int32[S, V]  (-1 = unreached)
    parent: torch.Tensor    # int32[S, V]  (NOKEY = none; == queries.bfs parents)
    val_ecnt: torch.Tensor  # int32[V]     validation vector (reached ecnt)
    agree: torch.Tensor     # bool[]       all ranks saw the same version


class ShardedSSSPResult(NamedTuple):
    ok: torch.Tensor        # bool[S]  source alive and no negative cycle
    negcycle: torch.Tensor  # bool[S]
    dist: torch.Tensor      # f32[S, V]  (+inf = unreachable)
    parent: torch.Tensor    # int32[S, V]
    val_ecnt: torch.Tensor  # int32[V]
    agree: torch.Tensor     # bool[]


class ShardedBCResult(NamedTuple):
    ok: torch.Tensor        # bool[S]
    delta: torch.Tensor     # f32[S, V]   dependencies
    sigma: torch.Tensor     # f32[S, V]
    level: torch.Tensor     # int32[S, V]
    scores: torch.Tensor    # f32[V]      sum_s delta[s, v] over ok sources
    val_ecnt: torch.Tensor  # int32[V]
    agree: torch.Tensor     # bool[]


def _version_agree(g: ThreadGroup, version) -> torch.Tensor:
    v = int(version)
    same = int(v == g.pmax(v))
    return torch.tensor(g.psum(same) == g.psum(1), device=g.device)


def _pad_cols(x: torch.Tensor, vp: int, value) -> torch.Tensor:
    return F.pad(x, (0, vp - x.shape[-1]), value=value)


def _band_views(g: ThreadGroup, w_local, alive):
    """Per-rank operand prep: padded alive, the band's first row, and the
    band's alive-masked adjacency."""
    band, vp = w_local.shape
    alivep = _pad_cols(alive, vp, False)
    lo = g.axis_index() * band
    edge = ((w_local < INF) & alivep[lo:lo + band, None]
            & alivep[None, :])
    return alivep, lo, edge


def _src_ok(alivep, srcs, vcap: int) -> torch.Tensor:
    vp = alivep.shape[0]
    return alivep[srcs.clamp(0, vp - 1).long()] & (srcs >= 0) & (srcs < vcap)


def _cold_srcs(alive, srcs, vp: int):
    """Per-rank source prep of the cold bodies: the one-hot source
    positions of the ok sources, bool[S, Vp]."""
    ok = _src_ok(_pad_cols(alive, vp, False), srcs, alive.shape[0])
    at_src = torch.arange(vp, device=alive.device)[None, :] == srcs[:, None]
    return at_src & ok[:, None]


# ------------------------------ BFS / SSSP ---------------------------------

def _bfs_body(g, w_local, occ_local, alive, ecnt, srcs, version, *, tile,
              use_kernel):
    """Cold BFS == the warm loop started from the one-hot source frontier
    at pass 0, so the full and delta paths cannot drift apart."""
    src_hot = _cold_srcs(alive, srcs, w_local.shape[1])
    dist0 = torch.where(src_hot, 0, -1).to(torch.int32)
    lvl0 = torch.zeros(srcs.shape, dtype=torch.int32, device=srcs.device)
    return _bfs_delta_body(g, w_local, occ_local, alive, ecnt, srcs, version,
                           dist0, lvl0, tile=tile, use_kernel=use_kernel)


def _sssp_body(g, w_local, occ_local, alive, ecnt, srcs, version, *, tile,
               use_kernel):
    """Cold Bellman-Ford == the warm re-relax from the one-hot sources; the
    pass-0 activity seed is the source columns."""
    src_hot = _cold_srcs(alive, srcs, w_local.shape[1])
    dist0 = torch.where(src_hot, 0.0, INF)
    ok, changed, dist, val_ecnt, agree = _sssp_delta_body(
        g, w_local, occ_local, alive, ecnt, srcs, version, dist0,
        (dist0 < INF).any(dim=0), tile=tile, use_kernel=use_kernel)
    return ok & ~changed, changed, dist, val_ecnt, agree


def _bfs_delta_body(g, w_local, occ_local, alive, ecnt, srcs, version,
                    dist0, lvl0, *, tile, use_kernel):
    """Warm-started BFS: the bool/pmax level loop resumed mid-way.

    ``dist0`` (int32[S, Vp]) carries each source's prior levels strictly
    above its level cut (-1 elsewhere) and ``lvl0[S]`` the resume pass
    (``cut - 1``; 0 for cold rows, ``vcap`` for untouched rows, which run
    no pass).  The loop condition is read off replicated state, so every
    rank runs the same passes; a rank whose band rows hold no frontier
    vertex skips its product (exactly zero) but still joins the pmax.  One
    host read a level (the condition and the band's frontier together).
    """
    vp = w_local.shape[1]
    vcap = alive.shape[0]
    S = srcs.shape[0]
    band = w_local.shape[0]
    alivep, lo, edge = _band_views(g, w_local, alive)
    mm = semiring.bool_mm_against(edge.float(), use_kernel=use_kernel,
                                  amask=occ_local, tile=tile)
    ok = _src_ok(alivep, srcs, vcap)
    dist, lvl = dist0, lvl0
    front = dist0 == lvl0[:, None]
    while True:
        fk = front[:, lo:lo + band]
        more, fk_any = torch.stack([front.any() & (lvl < vcap).any(),
                                    fk.any()]).tolist()
        if not more:
            break
        part = (mm(fk.float()) if fk_any
                else torch.zeros((S, vp), device=dist.device))
        hit = g.pmax(part.to(torch.int8)) > 0  # one int8 pmax a level
        newly = hit & (dist < 0)
        dist = torch.where(newly, lvl[:, None] + 1, dist)
        front, lvl = newly, lvl + 1
    reached_any = (dist[:, :vcap] >= 0).any(dim=0)
    val_ecnt = torch.where(reached_any, ecnt, 0)
    return ok, dist, val_ecnt, _version_agree(g, version)


def _sssp_delta_body(g, w_local, occ_local, alive, ecnt, srcs, version,
                     dist0, active0, *, tile, use_kernel):
    """Warm-started min-plus fixed point: delta SSSP's re-relax.

    ``dist0`` (f32[S, Vp]) carries admissible upper bounds; ``active0``
    (bool[Vp]) the pass-0 activity seed.  A band whose rows hold no active
    vertex contributes +inf without running its product but still joins
    the min-merge; after pass 0 activity is exactly the vertices the
    previous min-merge improved, which every rank derives identically from
    the replicated distances.  Exit-changed == negative cycle.
    """
    band, vp = w_local.shape
    vcap = alive.shape[0]
    S = srcs.shape[0]
    alivep, lo, edge = _band_views(g, w_local, alive)
    big_local = torch.where(edge, w_local, INF)
    mm = semiring.minplus_mm_against(big_local, use_kernel=use_kernel,
                                     amask=occ_local, tile=tile)
    ok = _src_ok(alivep, srcs, vcap)
    dist, act, it = dist0, active0, 0
    changed = torch.ones((S,), dtype=torch.bool, device=dist.device)
    while it < vcap:
        more, act_any = torch.stack([changed.any(),
                                     act[lo:lo + band].any()]).tolist()
        if not more:
            break
        cand = (mm(dist[:, lo:lo + band]) if act_any
                else torch.full((S, vp), INF, device=dist.device))
        cand = -g.pmax(-cand)  # one f32 min-merge a level
        nd = torch.minimum(dist, cand)
        improved = nd < dist
        dist, changed, act = nd, improved.any(dim=1), improved.any(dim=0)
        it += 1
    reached_any = (dist[:, :vcap] < INF).any(dim=0)
    val_ecnt = torch.where(reached_any, ecnt, 0)
    return ok, changed, dist, val_ecnt, _version_agree(g, version)


# ---------------------------------- BC -------------------------------------

def _bc_operands(g, w_local, occ_local, alive):
    """All-gather the row bands once per query: the per-chunk sweep then
    runs on the full grid, as on one device."""
    alivep = _pad_cols(alive, w_local.shape[1], False)
    return alivep, g.all_gather(w_local), g.all_gather(occ_local)


def _bc_finish(g, level, delta, ok, ecnt, vcap: int):
    part = torch.where(ok[:, None], delta, 0.0).sum(dim=0)
    scores = g.psum(part)[:vcap]
    reached_any = g.psum((level[:, :vcap] >= 0).any(dim=0)
                         .to(torch.int32)) > 0
    return scores, torch.where(reached_any, ecnt, 0)


def _bc_body(g, w_local, occ_local, alive, ecnt, srcs_local, version, *,
             tile, use_kernel, src_chunk, **warm):
    """Gather-mode BC (``warm``: the delta's ``prior_level`` /
    ``prior_sigma`` / ``cut``)."""
    vcap = alive.shape[0]
    alivep, w_full, occ_full = _bc_operands(g, w_local, occ_local, alive)
    delta, sigma, level, ok = bc_batched_dense(
        w_full < INF, srcs_local, alivep, use_kernel=use_kernel,
        amask=occ_full, tile=tile, src_chunk=src_chunk, **warm)
    del w_full
    scores, val_ecnt = _bc_finish(g, level, delta, ok, ecnt, vcap)
    return (ok, delta, sigma, level, scores, val_ecnt,
            _version_agree(g, version))


def _warm_start(alive, vp: int, dirty, prior_level, prior_sigma) -> dict:
    """The level-cut warm start of a rank's own sources (no collective: a
    source's forward tree is local state)."""
    alivep = _pad_cols(alive, vp, False)
    cut = bc_level_cut(prior_level, _pad_cols(dirty, vp, False), alivep)
    return dict(prior_level=prior_level, prior_sigma=prior_sigma, cut=cut)


def _bc_delta_body(g, w_local, occ_local, alive, ecnt, srcs_local, version,
                   dirty, prior_level, prior_sigma, *, tile, use_kernel,
                   src_chunk):
    """Level-cut delta BC, source axis sharded like ``_bc_body``."""
    return _bc_body(g, w_local, occ_local, alive, ecnt, srcs_local, version,
                    tile=tile, use_kernel=use_kernel, src_chunk=src_chunk,
                    **_warm_start(alive, w_local.shape[1], dirty,
                                  prior_level, prior_sigma))


# ------------------------------- BC: ring ----------------------------------

def _ring_mms(g, a_local, occ_local, *, tile, use_kernel):
    """SUMMA-style semiring-product providers over a rotating band ring.

    Each rank ever holds its own band plus the one a hop delivers.  Per
    product the ring makes one revolution -- ``n`` partial products, ``n -
    1`` hops -- each step computing the held band's tile-skipping partial
    and then passing the band (f32) and its occupancy band (int32, the
    masks) to the next rank; the last partial needs no hop.

      * ``fwd_mm(x)``: holding band ``b``, the contribution to ``x @ A`` is
        ``x[:, rows(b)] @ A[rows(b), :]``: partials ACCUMULATE (exact for
        the integer sigma counts, so the order is invisible to them).
      * ``bwd_mm(gr)``: the contribution to ``gr @ A^T`` is the full-k
        product ``gr @ A[rows(b), :].T``, output columns ``rows(b)``:
        partials ASSEMBLE by column block.

    Collective bytes per rotation: ``band x Vp x 4 + (nt/n) x nt x 4``.
    Each band's two products are prepared once per query, when the band
    first arrives, keyed by band index: the kernels' operand forms (split
    planes, coarsened masks) are made n times per query per rank, not once
    per level and hop.  Every rank must call the providers the same number
    of times; the sweep's ``sync_any`` / ``sync_max`` hooks keep the level
    loops in lock-step (``_ring_sync``).
    """
    band, vp = a_local.shape
    n, i = g.size(), g.axis_index()
    perm = [(j, (j + 1) % n) for j in range(n)]
    prepared = {}

    def product(b, ab, ob, backward: bool):
        """Band ``b``'s prepared ``x @ A[rows(b)]`` (or, ``backward``,
        ``x @ A[rows(b)].T``)."""
        if (b, backward) not in prepared:
            a, m = (ab.t(), ob.t()) if backward else (ab, ob)
            prepared[b, backward] = semiring.count_mm_against(
                a, use_kernel=use_kernel, amask=m, tile=tile)
        return prepared[b, backward]

    def revolve(combine, init):
        ab, ob, acc = a_local, occ_local, init
        for t in range(n - 1):
            acc = combine((i - t) % n, ab, ob, acc)
            ab, ob = g.ppermute((ab, ob), perm)
        return combine((i - n + 1) % n, ab, ob, acc)

    def fwd_mm(x):
        def combine(b, ab, ob, acc):
            return acc + product(b, ab, ob, False)(
                x[:, b * band:(b + 1) * band])

        return revolve(combine, torch.zeros((x.shape[0], vp),
                                            device=x.device))

    def bwd_mm(gr):
        def combine(b, ab, ob, out):
            out[:, b * band:(b + 1) * band] = product(b, ab, ob, True)(gr)
            return out

        return revolve(combine, torch.zeros((gr.shape[0], vp),
                                            device=gr.device))

    return fwd_mm, bwd_mm


def _ring_sync(g) -> dict:
    """Lock-step hooks for ``bc_sweep_ops``: the level loops continue until
    EVERY rank's source chunk is done -- one pmax of a host flag a forward
    level, one of the deepest level a chunk -- and a rank's extra
    iterations are exact no-ops."""
    return dict(sync_any=lambda p: bool(g.pmax(bool(p))),
                sync_max=lambda x: g.pmax(int(x)))


def _bc_ring_body(g, w_local, occ_local, alive, ecnt, srcs_local, version,
                  *, tile, use_kernel, src_chunk, **warm):
    """Ring-mode ``_bc_body``: the identical chunked sweep
    (``bc_batched_ops``) fed by rotated bands instead of a gathered
    matrix."""
    vp = w_local.shape[1]
    vcap = alive.shape[0]
    alivep, _, edge = _band_views(g, w_local, alive)
    fwd_mm, bwd_mm = _ring_mms(g, edge.float(), occ_local, tile=tile,
                               use_kernel=use_kernel)
    delta, sigma, level, ok = bc_batched_ops(
        fwd_mm, bwd_mm, srcs_local, alivep, vp, src_chunk=src_chunk,
        **warm, **_ring_sync(g))
    scores, val_ecnt = _bc_finish(g, level, delta, ok, ecnt, vcap)
    return (ok, delta, sigma, level, scores, val_ecnt,
            _version_agree(g, version))


def _bc_delta_ring_body(g, w_local, occ_local, alive, ecnt, srcs_local,
                        version, dirty, prior_level, prior_sigma, *, tile,
                        use_kernel, src_chunk):
    """Ring-mode ``_bc_delta_body``: the same per-rank level cuts
    warm-starting the ring sweep."""
    return _bc_ring_body(g, w_local, occ_local, alive, ecnt, srcs_local,
                         version, tile=tile, use_kernel=use_kernel,
                         src_chunk=src_chunk,
                         **_warm_start(alive, w_local.shape[1], dirty,
                                       prior_level, prior_sigma))


# ------------------------------ entry points -------------------------------

_KINDS = ("bfs", "sssp", "bc", "bc_ring", "bfs_delta", "sssp_delta",
          "bc_delta", "bc_delta_ring")

#: ``bc_mode`` knob -> the (full, delta) kinds it selects.
BC_MODES = {"gather": ("bc", "bc_delta"),
            "ring": ("bc_ring", "bc_delta_ring")}

# Argument / output layouts (the reference's PartitionSpecs):
BAND = "band"              # one tensor per rank (the view's bands)
REPLICATED = "replicated"  # the same tensor on every rank
SPLIT = "split"            # split along axis 0 over the ranks (BC sources)


class ArgSpec(NamedTuple):
    """One argument of a distributed program, allocated nowhere: its global
    shape and type, its layout, and the shape each rank holds."""

    shape: tuple
    dtype: torch.dtype
    layout: str
    rank_shape: tuple


def _bc_kind(bc_mode: str, delta: bool) -> str:
    if bc_mode not in BC_MODES:
        raise ValueError(f"unknown bc_mode {bc_mode!r}; "
                         f"supported modes: {', '.join(sorted(BC_MODES))}")
    return BC_MODES[bc_mode][1 if delta else 0]


def query_shardings(mesh, kind: str):
    """``(in_layouts, out_layouts)`` of ``query_fn(mesh, kind, ...)``: per
    argument and output, ``"band"`` (one tensor per rank), ``"replicated"``
    or ``"split"`` (split along axis 0 over the ranks)."""
    del mesh  # every 1-D mesh has the same layouts
    b, r, s = BAND, REPLICATED, SPLIT
    if kind in ("bc", "bc_ring"):
        return (b, b, r, r, s, r), (s, s, s, s, r, r, r)
    if kind in ("bc_delta", "bc_delta_ring"):
        return (b, b, r, r, s, r, r, s, s), (s, s, s, s, r, r, r)
    if kind == "bfs_delta":
        return (b, b, r, r, r, r, r, r), (r,) * 4
    if kind == "sssp_delta":
        return (b, b, r, r, r, r, r, r), (r,) * 5
    if kind not in ("bfs", "sssp"):
        raise ValueError(f"unknown query kind {kind!r}; "
                         f"supported kinds: {', '.join(_KINDS)}")
    return (b, b, r, r, r, r), (r,) * (4 if kind == "bfs" else 5)


_BODIES = {"bfs": _bfs_body, "sssp": _sssp_body,
           "bfs_delta": _bfs_delta_body, "sssp_delta": _sssp_delta_body,
           "bc": _bc_body, "bc_ring": _bc_ring_body,
           "bc_delta": _bc_delta_body, "bc_delta_ring": _bc_delta_ring_body}


def _share(mesh, a, layout: str, rank: int):
    """Rank ``rank``'s share of one argument, by its layout, on its
    device (a replicated tensor is the same tensor on a rank that shares
    its device)."""
    if layout == BAND:
        return a[rank]
    dev = mesh.devices[rank]
    if layout == SPLIT:
        part = a.shape[0] // mesh.size
        return a[rank * part:(rank + 1) * part].to(dev)
    return a.to(dev)


def _launch(mesh, body, layouts, args):
    """Run ``body`` on every rank this process holds with its share of
    ``args``; returns ``(outputs, the group)``: on a ``GraphMesh`` rank
    0's replicated outputs and the split ones concatenated on rank 0's
    device, where the unsharded helper math (tree parents, the delta
    poison and cuts) then runs once; on a ``DistMesh`` this process's
    replicated outputs and the split ones merged from every process."""
    in_l, out_l = layouts
    n = mesh.size
    if len(args) != len(in_l):
        raise ValueError(f"{len(args)} arguments for {len(in_l)} layouts")
    rank_args = [None] * n
    for r in local_ranks(mesh):
        rank_args[r] = tuple(_share(mesh, a, lay, r)
                             for a, lay in zip(args, in_l))
    if isinstance(mesh, DistMesh):
        group = DistGroup(mesh)
        mine = group.run(body, rank_args)[mesh.rank]
        return tuple(o if lay == REPLICATED else group.merge(o)
                     for o, lay in zip(mine, out_l)), group
    group = ThreadGroup(mesh)
    outs = group.run(body, rank_args)
    host = mesh.devices[0]
    merged = tuple(
        outs[0][k] if lay == REPLICATED
        else torch.cat([o[k].to(host) for o in outs])
        for k, lay in enumerate(out_l))
    return merged, group


@lru_cache(maxsize=None)
def _program(mesh, kind: str, tile: int, use_kernel, src_chunk):
    if kind not in _BODIES:
        raise ValueError(f"unknown query kind {kind!r}; "
                         f"supported kinds: {', '.join(_KINDS)}")
    kw = dict(tile=tile, use_kernel=use_kernel)
    if kind.startswith("bc"):
        kw["src_chunk"] = src_chunk
    return partial(_BODIES[kind], **kw), query_shardings(mesh, kind)


def query_fn(mesh, kind: str, tile: int, use_kernel=None,
             src_chunk: int | None = None):
    """The distributed program for ``kind`` on ``mesh``.

    Signature: ``fn(w, occ, alive, ecnt, srcs, version, *extras)`` --
    ``w``/``occ`` a ``ShardedTileView``'s bands, ``srcs`` replicated for
    bfs/sssp and split over the ranks for the bc kinds (its length must
    divide by the rank count; the host wrappers pad with -1).  The
    ``*_ring`` bc kinds share the bc signatures and differ only in how the
    adjacency reaches each rank.  Extras: ``bfs_delta`` ``dist0[S, Vp]``
    and ``lvl0[S]``; ``sssp_delta`` ``dist0[S, Vp]`` and ``active0[Vp]``;
    ``bc_delta(_ring)`` the dirty mask and the prior ``level``/``sigma``
    (split over the ranks).  ``use_kernel`` as in
    ``repro_torch.core.semiring`` (None: the kernels on a CUDA tensor).
    """
    fn = counted_query_fn(mesh, kind, tile, use_kernel, src_chunk)
    return lambda *args: fn(*args)[0]


def counted_query_fn(mesh, kind: str, tile: int, use_kernel=None,
                     src_chunk: int | None = None):
    """``query_fn``'s program returning ``(outputs, {op: bytes})``: the
    collective bytes its group counted (one rank's share; this process's
    on a ``DistMesh``)."""
    body, layouts = _program(mesh, kind, tile, use_kernel, src_chunk)

    def fn(*args):
        outs, group = _launch(mesh, body, layouts, args)
        return outs, dict(group.bytes)
    return fn


def _srcs_array(state: GraphState, srcs, n_shards: int = 1,
                pad_to_shards: bool = False) -> torch.Tensor:
    srcs = torch.atleast_1d(torch.as_tensor(srcs, dtype=torch.int32,
                                            device=state.device))
    if pad_to_shards:
        rem = (-srcs.shape[0]) % n_shards
        if rem:
            srcs = torch.cat([srcs, srcs.new_full((rem,), -1)])
    return srcs


def _dispatch(accountant, kind: str, view: ShardedTileView, prog, args,
              use_kernel, src_chunk=None):
    """Run the program; with an accountant, deposit its cost
    (``_account``)."""
    body, layouts = prog
    if accountant is None:
        return _launch(view.mesh, body, layouts, args)[0]
    groups = []

    def call(*a):
        outs, group = _launch(view.mesh, body, layouts, a)
        groups.append(group)
        return outs

    key = ("shard_query", kind, view.mesh.devices, view.tile, use_kernel,
           src_chunk) + tuple((tuple(t.shape), str(t.dtype))
                              for t in _tensors(args))
    outs = accountant.call(key, call, *args)
    _account(accountant, groups[0])
    return outs


def _account(accountant, group) -> None:
    """Overlay this call's collective bytes on the cost the accountant
    deposited: the group counted them as they ran (per op name, one
    rank's share), where the reference parses them off the compiled
    program once per signature.  Memory is measured once per signature
    (``repro_torch.obs.cost``); the bytes are this call's.  A
    ``DistGroup`` adds what its transport moved (``moved``)."""
    extra = ({"moved": dict(group.moved)} if isinstance(group, DistGroup)
             else {})
    accountant.last = dict(accountant.last,
                           collective_bytes=sum(group.bytes.values()),
                           collectives=dict(group.bytes), **extra)


def bfs(view: ShardedTileView, state: GraphState, srcs, *,
        use_kernel=None, accountant=None) -> ShardedBFSResult:
    """Distributed multi-source BFS; ``dist`` is sliced back to ``vcap``.

    ``parent`` is reconstructed from the final distances on the COO edge
    table (``bfs_tree_parents``), identical to per-source ``queries.bfs``.
    """
    srcs = _srcs_array(state, srcs)
    prog = _program(view.mesh, "bfs", view.tile, use_kernel, None)
    args = (view.w, view.occ, state.alive, state.ecnt, srcs, state.version)
    ok, dist, val_ecnt, agree = _dispatch(accountant, "bfs", view, prog,
                                          args, use_kernel)
    dist = dist[:, :state.vcap]
    parent = bfs_tree_parents(state, dist, srcs)
    return ShardedBFSResult(ok, dist, parent, val_ecnt, agree)


def sssp(view: ShardedTileView, state: GraphState, srcs, *,
         use_kernel=None, accountant=None) -> ShardedSSSPResult:
    """Distributed multi-source Bellman-Ford with negative-cycle flags;
    ``parent`` follows ``queries.sssp`` (``sssp_tree_parents``)."""
    srcs = _srcs_array(state, srcs)
    prog = _program(view.mesh, "sssp", view.tile, use_kernel, None)
    args = (view.w, view.occ, state.alive, state.ecnt, srcs, state.version)
    ok, neg, dist, val_ecnt, agree = _dispatch(accountant, "sssp", view,
                                               prog, args, use_kernel)
    dist = dist[:, :state.vcap]
    parent = sssp_tree_parents(state, dist, srcs)
    return ShardedSSSPResult(ok, neg, dist, parent, val_ecnt, agree)


def _bc_result(out, n_srcs: int, vcap: int) -> ShardedBCResult:
    ok, delta, sigma, level, scores, val_ecnt, agree = out
    return ShardedBCResult(ok[:n_srcs], delta[:n_srcs, :vcap],
                           sigma[:n_srcs, :vcap], level[:n_srcs, :vcap],
                           scores, val_ecnt, agree)


def bc_batched(view: ShardedTileView, state: GraphState, srcs=None, *,
               use_kernel=None, src_chunk: int | None = None,
               bc_mode: str = "gather", accountant=None) -> ShardedBCResult:
    """Distributed batched Brandes, source axis split over the ranks.

    ``srcs`` defaults to every vertex slot; it is padded with -1 up to a
    multiple of the rank count (dead padding contributes nothing) and the
    padding is sliced back off.  ``bc_mode``: ``"gather"`` (one all-gather
    of the bands a query; the full grid per rank) or ``"ring"`` (band
    rotation; one band per rank plus the one in flight).  Levels/sigma are
    bit-identical across modes; delta/scores agree to f32 summation order.
    """
    kind = _bc_kind(bc_mode, delta=False)
    if srcs is None:
        srcs = torch.arange(state.vcap, dtype=torch.int32,
                            device=state.device)
    n_srcs = torch.atleast_1d(torch.as_tensor(srcs)).shape[0]
    srcs = _srcs_array(state, srcs, view.n_shards, pad_to_shards=True)
    prog = _program(view.mesh, kind, view.tile, use_kernel, src_chunk)
    args = (view.w, view.occ, state.alive, state.ecnt, srcs, state.version)
    return _bc_result(_dispatch(accountant, kind, view, prog, args,
                                use_kernel, src_chunk), n_srcs, state.vcap)


# ------------------------------ delta queries -------------------------------

def _sssp_delta_dist0(state: GraphState, prior_dist, prior_parent, dirty,
                      srcs, vp: int):
    """The poison step of the sharded delta SSSP, batched over sources.

    Runs the engine's ``_poison`` (pointer doubling over the prior parent
    tree + one weight-checked edge re-probe; a lane per source) and
    returns the warm start ``dist0[S, vp]`` -- surviving prior distances,
    +inf elsewhere, source re-pinned to 0 -- and ``active0[vp]``, the
    pass-0 activity seed: dirty rows finite for some source, and rows with
    a live out-edge from a finite vertex into the ``dist0 == INF`` region.
    """
    from repro_torch.engine.incremental import _poison

    vcap, S = state.vcap, srcs.shape[0]
    reached = prior_dist < INF
    poison = _poison(state, prior_parent, reached, prior_dist,
                     dirty.expand(S, -1), check_weight=True)
    ok = _src_ok(state.alive, srcs, vcap)
    dist0 = _set_rows(torch.where(reached & ~poison, prior_dist, INF), srcs,
                      torch.where(ok, 0.0, INF))
    e = live_edges(state)
    gap = ((dist0[:, e.src] < INF) & (dist0[:, e.dst] == INF)).any(dim=0)
    finite_any = (dist0 < INF).any(dim=0)
    active0 = (dirty & finite_any) | _scatter_any(vcap, e.src, gap)
    return _pad_cols(dist0, vp, INF), _pad_cols(active0, vp, False)


def _bfs_delta_state0(state: GraphState, prior_dist, dirty, srcs, vp: int):
    """The cut step of the sharded delta BFS, batched over sources.

    BFS levels are a forward tree, so the delta reuses the level cut of
    delta BC (``bc_level_cut``): levels strictly above a source's
    shallowest dirty level are unchanged; the loop resumes from the cut
    frontier on the boolean formulation.  A now-ok source with an EMPTY
    prior row (dead at prior time, resurrected since) restarts cold.
    Returns the warm levels and the per-source resume pass (``cut - 1``;
    0 for a cold restart, ``vcap`` = no pass for an untouched source).
    """
    vcap = state.vcap
    cut = bc_level_cut(prior_dist, dirty, state.alive)
    ok = _src_ok(state.alive, srcs, vcap)
    rows = torch.arange(srcs.shape[0], device=srcs.device)
    revived = ok & (prior_dist[rows, srcs.clamp(0, vcap - 1).long()] < 0)
    cut = torch.where(revived, 0, cut)
    ids = torch.arange(vcap, device=srcs.device)
    cold = torch.where((ids[None, :] == srcs[:, None]) & ok[:, None], 0, -1)
    usable = cut >= 1
    keep = usable[:, None] & (prior_dist >= 0) & (prior_dist < cut[:, None])
    dist0 = torch.where(usable[:, None],
                        torch.where(keep, prior_dist, -1), cold)
    lvl0 = torch.where(usable, torch.clamp(cut - 1, max=vcap), 0)
    return (_pad_cols(dist0.to(torch.int32), vp, -1),
            lvl0.to(torch.int32))


def delta_bfs_sharded(view: ShardedTileView, state: GraphState,
                      prior: ShardedBFSResult, dirty, srcs, *,
                      use_kernel=None, accountant=None) -> ShardedBFSResult:
    """Distributed delta BFS: level cut unsharded, warm loop on the mesh.

    ``prior`` must be a result for the SAME ``srcs`` at an earlier version
    whose accumulated dirty set is ``dirty``.  Bit-identical to the full
    sharded ``bfs`` on this snapshot and to the engine's ``delta_bfs``.
    """
    srcs = _srcs_array(state, srcs)
    dist0, lvl0 = _bfs_delta_state0(state, prior.dist, dirty, srcs,
                                    vp=view.vp)
    prog = _program(view.mesh, "bfs_delta", view.tile, use_kernel, None)
    args = (view.w, view.occ, state.alive, state.ecnt, srcs, state.version,
            dist0, lvl0)
    ok, dist, val_ecnt, agree = _dispatch(accountant, "bfs_delta", view,
                                          prog, args, use_kernel)
    dist = dist[:, :state.vcap]
    parent = bfs_tree_parents(state, dist, srcs)
    return ShardedBFSResult(ok, dist, parent, val_ecnt, agree)


def delta_sssp_sharded(view: ShardedTileView, state: GraphState,
                       prior: ShardedSSSPResult, dirty, srcs, *,
                       use_kernel=None,
                       accountant=None) -> ShardedSSSPResult:
    """Distributed delta Bellman-Ford: poison unsharded, re-relax sharded.

    The prior must be negative-cycle-free; on detection in the NEW graph
    the caller re-runs the full query, whose partially-relaxed distances
    are the canonical answer.  Bit-identical to the full sharded ``sssp``
    and to the engine's ``delta_sssp``.
    """
    srcs = _srcs_array(state, srcs)
    dist0, active0 = _sssp_delta_dist0(state, prior.dist, prior.parent,
                                       dirty, srcs, vp=view.vp)
    prog = _program(view.mesh, "sssp_delta", view.tile, use_kernel, None)
    args = (view.w, view.occ, state.alive, state.ecnt, srcs, state.version,
            dist0, active0)
    ok, changed, dist, val_ecnt, agree = _dispatch(
        accountant, "sssp_delta", view, prog, args, use_kernel)
    dist = dist[:, :state.vcap]
    parent = sssp_tree_parents(state, dist, srcs)
    return ShardedSSSPResult(ok & ~changed, changed, dist, parent,
                             val_ecnt, agree)


def delta_bc_sharded(view: ShardedTileView, state: GraphState,
                     prior: ShardedBCResult, dirty, srcs=None, *,
                     use_kernel=None, src_chunk: int | None = None,
                     bc_mode: str = "gather",
                     accountant=None) -> ShardedBCResult:
    """Distributed level-cut delta BC, sources split as in ``bc_batched``.

    Each rank cuts its own sources' cached forward trees at the shallowest
    dirty level and resumes the chunked sweep.  Bit-identical to the full
    sharded ``bc_batched`` in the same ``bc_mode`` on this snapshot, scores
    included.
    """
    kind = _bc_kind(bc_mode, delta=True)
    if srcs is None:
        srcs = torch.arange(state.vcap, dtype=torch.int32,
                            device=state.device)
    n_srcs = torch.atleast_1d(torch.as_tensor(srcs)).shape[0]
    srcs = _srcs_array(state, srcs, view.n_shards, pad_to_shards=True)
    vcap, S, vp = state.vcap, srcs.shape[0], view.vp
    # Re-pad the cached prior to the program's [S, Vp] shape: padding
    # sources carry an empty tree, padding columns are never reached.
    level = torch.full((S, vp), -1, dtype=torch.int32, device=state.device)
    level[:n_srcs, :vcap] = prior.level
    sigma = torch.zeros((S, vp), dtype=torch.float32, device=state.device)
    sigma[:n_srcs, :vcap] = prior.sigma
    prog = _program(view.mesh, kind, view.tile, use_kernel, src_chunk)
    args = (view.w, view.occ, state.alive, state.ecnt, srcs, state.version,
            dirty, level, sigma)
    return _bc_result(_dispatch(accountant, kind, view, prog, args,
                                use_kernel, src_chunk), n_srcs, vcap)


def validate_incremental_sharded(view: ShardedTileView, state: GraphState,
                                 srcs, result, kind: str, *,
                                 use_kernel=None,
                                 src_chunk: int | None = None,
                                 bc_mode: str = "gather") -> bool:
    """``cmp_tree``-style check for the sharded delta paths: bit-equality
    of every result field against a fresh full distributed collect on the
    same snapshot (a ring delta validates against a ring full collect)."""
    from repro_torch.engine.incremental import results_equal

    if kind == "bc":
        fresh = bc_batched(view, state, srcs, use_kernel=use_kernel,
                           src_chunk=src_chunk, bc_mode=bc_mode)
    else:
        fresh = {"bfs": bfs, "sssp": sssp}[kind](view, state, srcs,
                                                 use_kernel=use_kernel)
    return results_equal(result, fresh)
