"""Delta-driven BFS / SSSP / BC from a prior result + dirty set (port of
``repro.engine.incremental``).

Given a prior result and the dirty-vertex set accumulated since it was
computed (``engine.version_ring``), the delta queries:

  1. **Poison** the stale region: a cached distance is invalid iff some
     edge on its cached shortest path may have changed.  Every edge
     mutation bumps ``ecnt`` at the edge's *source*, so the path through
     ``v`` is suspect exactly when an ancestor of ``v`` in the prior tree
     has a dirty parent-edge source (or ``v`` died).  Poison propagates
     down the parent tree by pointer doubling -- ``ceil(log2 vcap)``
     gathers.
  2. **Re-relax** from the surviving frontier: clean distances are
     admissible upper bounds, so the label-correcting fixed point converges
     to the exact answer in ~(affected-region diameter) passes.
  3. **Fall back** to full recompute when the dirty region is too large
     (``dirty_threshold``), when the cached result is unusable, or when the
     caller has no dirty info.

The cheap *unchanged* test -- no dirty vertex intersects the prior reached
region -- returns the prior result with zero passes.
``validate_incremental`` checks that an answer is bit-identical to a fresh
collect on the same snapshot.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.graph_state import INF, NOKEY, GraphState, \
    find_edge_slots
from repro_torch.core.queries import (
    BCResult,
    BFSResult,
    SSSPResult,
    _as_src,
    _bc_coo_sweep,
    _bc_coo_sweep_lanes,
    _pick,
    _set_at,
    _set_rows,
    _src_ok,
    bc_dependencies,
    bc_level_cut,
    bfs,
    bfs_tree_parents,
    live_edges,
    relax_fixpoint,
    relax_fixpoint_lanes,
    sssp,
    sssp_tree_parents,
)
from repro_torch.obs.cost import account_call
from repro_torch.obs.trace import annotate as _trace_annotate
from repro_torch.obs.trace import host_read


@dataclass
class IncrementalStats:
    """How one incremental query was answered."""

    mode: str               # "unchanged" | "delta" | "full"
    dirty_count: int = 0
    dirty_fraction: float = 0.0


def _poison(state: GraphState, prior_parent: torch.Tensor,
            prior_reached: torch.Tensor, prior_distf: torch.Tensor,
            dirty: torch.Tensor, check_weight: bool) -> torch.Tensor:
    """bool[L, vcap]: per lane, vertices whose cached distance can no
    longer be trusted (priors and dirty masks are ``[L, vcap]``; the
    single-source queries pass one lane).

    Seeds: reached vertices that died, and vertices whose parent edge is
    actually gone.  A dirty parent only *suspects* the edge, so the new
    state is re-probed: if edge ``(parent[v], v)`` is still live with the
    same weight (ignored for BFS) the cached path survives.  Poison then
    closes downward over the prior tree by pointer doubling.  The edge probe
    and the doubling run on flat ``lane * vcap + v`` indices, so each step
    is one op for every lane.
    """
    L, vcap = prior_parent.shape
    dev = state.device
    parc = prior_parent.clamp(0, vcap - 1).long()
    has_par = (prior_parent != NOKEY) & prior_reached
    suspect = has_par & dirty.gather(1, parc)
    self_id = torch.arange(vcap, dtype=torch.int32, device=dev).expand(L, -1)
    qu = torch.where(suspect, parc.to(torch.int32), NOKEY)
    qv = torch.where(suspect, self_id, NOKEY)
    slot, _, edge_ok = find_edge_slots(state, qu.reshape(-1), qv.reshape(-1))
    slot, edge_ok = slot.view(L, vcap), edge_ok.view(L, vcap)
    if check_weight:
        edge_ok = edge_ok & (state.ew[slot]
                             == prior_distf - prior_distf.gather(1, parc))
    poison = (prior_reached & ~state.alive) | (suspect & ~edge_ok)
    poison = poison.reshape(-1)
    # Ancestor pointer: parent where one exists, else self (fixed point).
    off = torch.arange(L, device=dev)[:, None] * vcap
    anc = (torch.where(has_par, parc, self_id.long()) + off).reshape(-1)
    for _ in range(max(1, int(math.ceil(math.log2(max(vcap, 2)))))):
        poison = poison | poison[anc]
        anc = anc[anc]
    # With zero-weight edges the tight-edge parent "tree" can hold cycles,
    # which poison along parents never escapes; such chains never reach a
    # (parentless) root, so their cached distances are unverifiable.
    return (poison | has_par.reshape(-1)[anc]).view(L, vcap)


def _dirty_stats(prior_reached: torch.Tensor, dirty: torch.Tensor):
    """(dirty count, query touched) in one device-to-host read.

    ``touched``: any dirty vertex intersects the prior reached region --
    every mutation that can change the answer dirties a *reached* vertex.
    """
    both = torch.stack([dirty.sum(), (dirty & prior_reached).any().long()])
    n_dirty, touched = host_read(torch.Tensor.tolist, both)
    return int(n_dirty), bool(touched)


# --------------------------------- BFS -----------------------------------

def delta_bfs(state: GraphState, prior: BFSResult, dirty: torch.Tensor,
              src) -> BFSResult:
    """Recompute BFS on ``state`` reusing ``prior``; bit-identical to
    ``queries.bfs(state, src)`` for any dirty set covering the changes."""
    src = torch.as_tensor(src, dtype=torch.int32, device=state.device)
    vcap = state.vcap
    e = live_edges(state)
    ok = _src_ok(state, src)

    priorf = prior.dist.float()
    poison = _poison(state, prior.parent[None], prior.reached[None],
                     priorf[None], dirty[None], check_weight=False)[0]
    keep = prior.reached & ~poison
    dist0 = _set_at(torch.where(keep, priorf, INF), src, _pick(ok, 0.0, INF))
    distf, _, _ = relax_fixpoint(dist0, e._replace(w=torch.ones_like(e.w)),
                                 vcap)

    reached = distf < INF
    dist = torch.where(reached, distf, -1.0).to(torch.int32)
    parent = bfs_tree_parents(state, dist[None], src[None])[0]
    return BFSResult(ok, reached, dist, parent)


# --------------------------------- SSSP ----------------------------------

def delta_sssp(state: GraphState, prior: SSSPResult, dirty: torch.Tensor,
               src) -> SSSPResult:
    """Delta Bellman-Ford; bit-identical to ``queries.sssp`` absent negative
    cycles (on detection the wrapper re-runs the full query)."""
    src = torch.as_tensor(src, dtype=torch.int32, device=state.device)
    vcap = state.vcap
    e = live_edges(state)
    ok_src = _src_ok(state, src)

    prior_reached = prior.dist < INF
    poison = _poison(state, prior.parent[None], prior_reached[None],
                     prior.dist[None], dirty[None], check_weight=True)[0]
    keep = prior_reached & ~poison
    dist0 = _set_at(torch.where(keep, prior.dist, INF), src,
                    _pick(ok_src, 0.0, INF))
    dist, changed, _ = relax_fixpoint(dist0, e, vcap)
    negcycle = torch.tensor(changed, device=state.device)
    parent = sssp_tree_parents(state, dist[None], src[None])[0]
    return SSSPResult(ok_src & ~negcycle, negcycle, dist, parent)


# ---------------------------------- BC -----------------------------------

def delta_bc(state: GraphState, prior: BCResult, dirty: torch.Tensor,
             src) -> BCResult:
    """Level-cut delta Brandes: recompute BC dependencies reusing ``prior``.

    Level sets are built level by level from the out-edge lists of the
    previous level's vertices, so everything strictly above the shallowest
    dirty level is untouched (``bc_level_cut``): reuse the cached forward
    levels/sigma there, resume the forward sweep from the cut's frontier,
    and re-run the backward sweep in full.  Bit-identical to
    ``bc_dependencies(state, src)``.  Callers gate on ``cut >= 1``.
    """
    cut = bc_level_cut(prior.level, dirty, state.alive)
    return _delta_bc_at_cut(state, prior, int(cut), src)


def _delta_bc_at_cut(state: GraphState, prior: BCResult, cut: int,
                     src) -> BCResult:
    """``delta_bc`` with the cut already computed (``incremental_bc`` reads
    it once for its host-side gate)."""
    src = torch.as_tensor(src, dtype=torch.int32, device=state.device)
    ok = _src_ok(state, src)
    keep = (prior.level >= 0) & (prior.level < cut)
    level0 = torch.where(keep, prior.level, -1)
    sigma0 = torch.where(keep, prior.sigma, 0.0)
    level, sigma, delta = _bc_coo_sweep(live_edges(state), state.vcap,
                                        level0, sigma0, level0 == cut - 1,
                                        cut - 1)
    return BCResult(ok, delta, sigma, level)


# ------------------------------ lane forms --------------------------------
# L delta queries at once, each with its own prior, dirty mask or cut and
# source (``repro_torch.serve.batch``'s delta rung; the reference vmaps the
# single-source functions).  Lane i equals the single-source call on lane
# i's inputs bit for bit.

def delta_bfs_lanes(state: GraphState, prior: BFSResult, dirty: torch.Tensor,
                    srcs) -> BFSResult:
    """``delta_bfs`` per lane: ``prior`` fields and ``dirty`` are stacked
    ``[L, vcap]``, ``srcs`` is ``int32[L]``."""
    srcs = _as_src(state, srcs)
    e = live_edges(state)
    ok = _src_ok(state, srcs)
    priorf = prior.dist.float()
    poison = _poison(state, prior.parent, prior.reached, priorf, dirty,
                     check_weight=False)
    keep = prior.reached & ~poison
    dist0 = _set_rows(torch.where(keep, priorf, INF), srcs,
                      _pick(ok, 0.0, INF))
    distf, _, _ = relax_fixpoint_lanes(
        dist0, e._replace(w=torch.ones_like(e.w)), state.vcap)
    reached = distf < INF
    dist = torch.where(reached, distf, -1.0).to(torch.int32)
    return BFSResult(ok, reached, dist, bfs_tree_parents(state, dist, srcs))


def delta_sssp_lanes(state: GraphState, prior: SSSPResult,
                     dirty: torch.Tensor, srcs) -> SSSPResult:
    """``delta_sssp`` per lane (see ``delta_bfs_lanes``); a lane's
    ``negcycle`` is its own relax loop's exit state."""
    srcs = _as_src(state, srcs)
    e = live_edges(state)
    ok_src = _src_ok(state, srcs)
    prior_reached = prior.dist < INF
    poison = _poison(state, prior.parent, prior_reached, prior.dist, dirty,
                     check_weight=True)
    keep = prior_reached & ~poison
    dist0 = _set_rows(torch.where(keep, prior.dist, INF), srcs,
                      _pick(ok_src, 0.0, INF))
    dist, negcycle, _ = relax_fixpoint_lanes(dist0, e, state.vcap)
    parent = sssp_tree_parents(state, dist, srcs)
    return SSSPResult(ok_src & ~negcycle, negcycle, dist, parent)


def delta_bc_at_cut_lanes(state: GraphState, prior: BCResult, cuts,
                          srcs) -> BCResult:
    """``_delta_bc_at_cut`` per lane: ``cuts`` is ``int32[L]`` and each
    lane resumes its forward sweep at its own ``cut - 1`` (every cut
    ``>= 1``, the callers' gate)."""
    srcs = _as_src(state, srcs)
    cuts = torch.as_tensor(cuts, dtype=torch.int32, device=state.device)
    ok = _src_ok(state, srcs)
    keep = (prior.level >= 0) & (prior.level < cuts[:, None])
    level0 = torch.where(keep, prior.level, -1)
    sigma0 = torch.where(keep, prior.sigma, 0.0)
    level, sigma, delta = _bc_coo_sweep_lanes(
        live_edges(state), state.vcap, level0, sigma0,
        level0 == (cuts - 1)[:, None], cuts - 1)
    return BCResult(ok, delta, sigma, level)


# ----------------------------- host wrappers ------------------------------

def _prior_usable(state: GraphState, prior, prior_ok) -> bool:
    return (prior is not None and bool(prior_ok)
            and prior.dist.shape[0] == state.vcap)


def _acct_key(kind: str, state: GraphState) -> tuple:
    """Cost signature of a local query: the reference's (the table
    capacities) plus the device, whose cost differs."""
    return ("local", kind, state.vcap, state.ecap, state.device.type)


def _full(kind, fn, state, src, accountant, stats):
    return account_call(accountant, _acct_key(kind, state), fn, state,
                        src), stats


def incremental_bfs(state: GraphState, prior: Optional[BFSResult],
                    dirty: Optional[torch.Tensor], src, *,
                    dirty_threshold: float = 0.25, accountant=None):
    """BFS on ``state`` reusing ``prior`` where possible.

    Returns ``(BFSResult, IncrementalStats)``; the result is always exactly
    what ``queries.bfs(state, src)`` would return.  With an ``accountant``
    (``repro_torch.obs.cost``) the cost of whichever call produced the
    answer is deposited in ``accountant.last`` -- the *unchanged* shortcut
    runs none and deposits nothing.
    """
    if dirty is None or not _prior_usable(state, prior,
                                          prior.ok if prior else False):
        return _full("bfs", bfs, state, src, accountant,
                     IncrementalStats("full"))
    n_dirty, touched = _dirty_stats(prior.reached, dirty)
    frac = n_dirty / state.vcap
    _trace_annotate(dirty=n_dirty, dirty_frac=round(frac, 6))
    stats = IncrementalStats("delta", n_dirty, frac)
    # Unchanged beats the threshold check: churn confined outside the
    # query's reached region leaves the cached answer valid.
    if not touched:
        stats.mode = "unchanged"
        return prior, stats
    if frac > dirty_threshold:
        stats.mode = "full"
        return _full("bfs", bfs, state, src, accountant, stats)
    return account_call(accountant, _acct_key("bfs_delta", state), delta_bfs,
                        state, prior, dirty, src), stats


def incremental_sssp(state: GraphState, prior: Optional[SSSPResult],
                     dirty: Optional[torch.Tensor], src, *,
                     dirty_threshold: float = 0.25, accountant=None):
    """SSSP analogue of ``incremental_bfs``."""
    if dirty is None or not _prior_usable(state, prior,
                                          prior.ok if prior else False):
        return _full("sssp", sssp, state, src, accountant,
                     IncrementalStats("full"))
    n_dirty, touched = _dirty_stats(prior.dist < INF, dirty)
    frac = n_dirty / state.vcap
    _trace_annotate(dirty=n_dirty, dirty_frac=round(frac, 6))
    stats = IncrementalStats("delta", n_dirty, frac)
    if not touched:
        stats.mode = "unchanged"
        return prior, stats
    if frac > dirty_threshold:
        stats.mode = "full"
        return _full("sssp", sssp, state, src, accountant, stats)
    res = account_call(accountant, _acct_key("sssp_delta", state),
                       delta_sssp, state, prior, dirty, src)
    if bool(res.negcycle):
        # Negative cycle: the full query's non-converged distances depend
        # on relaxation order; rerun it so callers see the canonical answer.
        stats.mode = "full"
        return _full("sssp", sssp, state, src, accountant, stats)
    return res, stats


def incremental_bc(state: GraphState, prior: Optional[BCResult],
                   dirty: Optional[torch.Tensor], src, *,
                   dirty_threshold: float = 0.25, accountant=None):
    """BC dependencies with the unchanged -> delta -> full ladder.

    Churn that never touches the prior forward region (``level >= 0``)
    cannot move any shortest path from ``src``.  A touched region runs the
    level-cut delta when the cut is below the source (``cut >= 1``) and the
    dirty fraction is within ``dirty_threshold``; otherwise full recompute.
    """
    usable = (prior is not None and bool(prior.ok)
              and prior.level.shape[0] == state.vcap)
    if dirty is None or not usable:
        return _full("bc", bc_dependencies, state, src, accountant,
                     IncrementalStats("full"))
    n_dirty, touched = _dirty_stats(prior.level >= 0, dirty)
    frac = n_dirty / state.vcap
    _trace_annotate(dirty=n_dirty, dirty_frac=round(frac, 6))
    stats = IncrementalStats("delta", n_dirty, frac)
    if not touched:
        stats.mode = "unchanged"
        return prior, stats
    if frac > dirty_threshold:
        stats.mode = "full"
        return _full("bc", bc_dependencies, state, src, accountant, stats)
    cut = int(bc_level_cut(prior.level, dirty, state.alive))
    if cut < 1:
        stats.mode = "full"
        return _full("bc", bc_dependencies, state, src, accountant, stats)
    return account_call(accountant, _acct_key("bc_delta", state),
                        _delta_bc_at_cut, state, prior, cut, src), stats


# ------------------------------ validation --------------------------------

def results_equal(a, b) -> bool:
    """CMPTREE over result tuples: region, tree, and payload all equal."""
    return all(x.shape == y.shape and x.dtype == y.dtype
               and bool(torch.equal(x, y)) for x, y in zip(a, b))


def validate_incremental(state: GraphState, src, result, kind: str) -> bool:
    """``cmp_tree``-style check: does ``result`` match a fresh collect on
    the same snapshot (``queries.bfs``/``sssp``/``bc_dependencies``)?"""
    fresh = {"bfs": bfs, "sssp": sssp, "bc": bc_dependencies}[kind](state, src)
    return results_equal(result, fresh)
