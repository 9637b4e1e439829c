"""Compatible-query batching: N pinned queries, one dispatch (port of
``repro.serve.batch``).

The dispatcher groups admitted requests by ``(kind, version)`` and this
module turns each group into at most two calls:

  * the **full** rung runs the lane form of the single-source query
    (``queries.bfs_lanes`` / ``sssp_lanes`` / ``bc_dependencies_lanes``)
    over the stacked sources -- N concurrent BFS queries at version ``v``
    cost one sequence of ops and one host read per level instead of N;
  * the **delta** rung runs the lane form of the engine's delta queries
    (``incremental.delta_bfs_lanes`` / ``delta_sssp_lanes`` /
    ``delta_bc_at_cut_lanes``) over stacked ``(prior, dirty, src)`` lanes:
    each lane carries its own prior and its own accumulated dirty mask (BC:
    its own level cut), so requests cached at *different* earlier versions
    still share the dispatch.

Per-lane answers are bit-identical to the sequential single-source calls:
a lane form runs its loop while *any* lane is active and keeps each
finished lane's carry unchanged -- what ``jax.vmap`` of the reference's
``lax.while_loop`` does -- so a lane that converged early keeps exactly
the value the single-source loop would have produced.

Classification (which rung a request rides) reuses the ladder's own
pieces -- ``ring.dirty_between``, ``_dirty_stats``, the per-kind threshold
consult, ``bc_level_cut`` -- so the batched ladder demotes on exactly the
same evidence as ``engine.incremental``'s sequential one.

Lane stacks are padded up to the next power of two (replicating lane 0,
whose extra output rows are dropped), as in the reference, so a service
sees at most ``log2(max_batch) + 1`` lane counts per kind and rung.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import queries
from repro_torch.core.graph_state import INF
from repro_torch.engine.incremental import (
    _dirty_stats,
    delta_bc_at_cut_lanes,
    delta_bfs_lanes,
    delta_sssp_lanes,
)

__all__ = ["Lane", "classify_local", "dispatch_local_group", "pad_pow2"]

#: full rungs: the state shared, the source axis stacked.
_VFULL = {
    "bfs": queries.bfs_lanes,
    "sssp": queries.sssp_lanes,
    "bc": queries.bc_dependencies_lanes,
}

#: delta rungs: the state shared; prior / dirty-or-cut / source stacked.
_VDELTA = {
    "bfs": delta_bfs_lanes,
    "sssp": delta_sssp_lanes,
    "bc": delta_bc_at_cut_lanes,
}

#: reached-region mask of a cached local result, per kind (the unchanged
#: test: dirty & reached empty => the cached answer stands).
_REACHED = {
    "bfs": lambda r: r.reached,
    "sssp": lambda r: r.dist < INF,
    "bc": lambda r: r.level >= 0,
}


def pad_pow2(n: int) -> int:
    """Smallest power of two >= n (lane-count bucketing)."""
    size = 1
    while size < n:
        size *= 2
    return size


@dataclass
class Lane:
    """One request's slice of a batched dispatch."""

    index: int              # position in the dispatcher's group
    src: int
    mode: str               # "unchanged" | "delta" | "full"
    prior: object = None    # cached result (unchanged/delta lanes)
    dirty: object = None    # accumulated dirty mask (delta bfs/sssp)
    cut: Optional[int] = None   # warm-start level cut (delta bc)
    dirty_frac: Optional[float] = None


def classify_local(service, kind: str, src: int, version: int,
                   state) -> Lane:
    """Which rung does this request ride?  Mirrors the gates of
    ``engine.incremental.incremental_*`` (prior usability, the unchanged
    shortcut, the threshold consult, BC's level-cut floor), so a batched
    query demotes on the same evidence as a sequential one.

    A cached slot *newer* than ``version`` (stored by a later group or by
    the sequential path while this request waited) cannot serve an older
    version: the lane runs full.  The reference asks the ring for the
    reversed span there, which raises and sends the whole group to the
    per-request fallback.

    On the card the slot may have been stored by another thread whose
    stream is still computing it: the current stream waits for the slot's
    event before anything here or in the lane work reads the prior.
    """
    with service._cache_lock:
        slot = service._cache.get((kind, src))
    if slot is None or not service._breaker_allows(kind):
        return Lane(0, src, "full")
    if slot.ready is not None:
        slot.ready.wait()
    prior = slot.result
    usable = bool(prior.ok) and (
        prior.level.shape[0] == state.vcap if kind == "bc"
        else prior.dist.shape[0] == state.vcap)
    if not usable or slot.version > version:
        return Lane(0, src, "full")
    if slot.version == version:
        return Lane(0, src, "unchanged", prior=prior)
    dirty = service.ring.dirty_between(slot.version, version)
    if dirty is None:
        return Lane(0, src, "full")
    n_dirty, touched = _dirty_stats(_REACHED[kind](prior), dirty)
    frac = n_dirty / state.vcap
    if not touched:
        return Lane(0, src, "unchanged", prior=prior, dirty_frac=frac)
    if frac > service._threshold(kind):
        return Lane(0, src, "full", dirty_frac=frac)
    if kind == "bc":
        cut = int(queries.bc_level_cut(prior.level, dirty, state.alive))
        if cut < 1:
            return Lane(0, src, "full", dirty_frac=frac)
        return Lane(0, src, "delta", prior=prior, cut=cut, dirty_frac=frac)
    return Lane(0, src, "delta", prior=prior, dirty=dirty, dirty_frac=frac)


def _stack_pad(items: List, pad: int):
    """Stack tensors (or result tuples of tensors, field by field) along a
    new leading lane axis, with lane 0 repeated ``pad`` more times (the
    padding lanes' outputs are dropped by the caller)."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(items) + [first] * pad)
    return type(first)(*(_stack_pad([it[k] for it in items], pad)
                         for k in range(len(first))))


def _unstack(batched, n: int) -> List:
    """Lane ``i``'s result, for the first ``n`` (unpadded) lanes: views of
    the batched outputs."""
    return [type(batched)(*(x[i] for x in batched)) for i in range(n)]


def _lane_srcs(lanes: List[Lane], pad: int, device) -> torch.Tensor:
    srcs = [ln.src for ln in lanes]
    return torch.tensor(srcs + srcs[:1] * pad, dtype=torch.int32,
                        device=device)


def dispatch_local_group(service, kind: str, state,
                         lanes: List[Lane]) -> Tuple[List, Dict[str, int]]:
    """Run one ``(kind, version)`` group's device work.

    Returns ``(results, dispatch_sizes)`` where ``results[i]`` answers
    ``lanes[i]`` and ``dispatch_sizes`` maps rung name -> lane count for
    each call that actually ran.  Lanes may be *reclassified*
    ``delta -> full`` on the way (a delta SSSP that surfaced a negative
    cycle re-runs full for the canonical answer, exactly the
    ``incremental_sssp`` contract) -- callers must read ``lane.mode``
    after this returns.
    """
    results: List = [None] * len(lanes)
    sizes: Dict[str, int] = {}
    full_lanes = [ln for ln in lanes if ln.mode == "full"]
    delta_lanes = [ln for ln in lanes if ln.mode == "delta"]
    for ln in lanes:
        if ln.mode == "unchanged":
            results[ln.index] = ln.prior

    if delta_lanes:
        n = len(delta_lanes)
        pad = pad_pow2(n) - n
        srcs = _lane_srcs(delta_lanes, pad, state.device)
        priors = _stack_pad([ln.prior for ln in delta_lanes], pad)
        if kind == "bc":
            cuts = [ln.cut for ln in delta_lanes]
            out = _VDELTA[kind](state, priors, cuts + cuts[:1] * pad, srcs)
        else:
            dirt = _stack_pad([ln.dirty for ln in delta_lanes], pad)
            out = _VDELTA[kind](state, priors, dirt, srcs)
        sizes["delta"] = n
        # one host read for every lane's negative-cycle flag
        neg = out.negcycle[:n].tolist() if kind == "sssp" else [False] * n
        for ln, res, cycle in zip(delta_lanes, _unstack(out, n), neg):
            if cycle:
                # Born-since-prior negative cycle: the full query's
                # partially-relaxed distances are the canonical answer.
                ln.mode = "full"
                full_lanes.append(ln)
            else:
                results[ln.index] = res

    if full_lanes:
        n = len(full_lanes)
        out = _VFULL[kind](state, _lane_srcs(full_lanes, pad_pow2(n) - n,
                                             state.device))
        sizes["full"] = n
        for ln, res in zip(full_lanes, _unstack(out, n)):
            results[ln.index] = res

    return results, sizes
