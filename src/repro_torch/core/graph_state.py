"""Versioned, fixed-capacity dynamic-graph state (port of
``repro.core.graph_state``).

The layout is the reference's, field for field and dtype for dtype, so the
arrays compare equal to JAX's:

  * ``alive[v]`` / ``ecnt[v]`` -- the direct-indexed vertex table (liveness
    and the per-vertex edge version counter);
  * ``esrc`` / ``edst`` / ``ew`` -- ONE lexicographically sorted
    ``(src, dst)`` key array with slack capacity ``ecap``; a removed edge
    keeps its slot with ``weight = +inf`` (the paper's logical removal) and
    empty slots carry ``(NOKEY, NOKEY)``, which sorts last;
  * ``version`` -- bumped once per committed batch.

Storage is int32 as in the reference; indices are widened to int64 only
where torch indexes with them.  Every function returns a new state; none
writes into its input.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# Sentinel for empty edge slots / invalid vertex ids.  Must be the maximum
# int32 so empty slots sort after every real key.
NOKEY: int = 2**31 - 1
# Weight tombstone: logically-removed edge (and "no edge" in dense form).
INF = math.inf


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    The port's entry points default to ``"cuda"``: on a machine without
    CUDA they raise here instead of quietly building state on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available on this machine; pass "
            "device='cpu' to run on the CPU")
    return dev


class GraphState(NamedTuple):
    """A committed snapshot of the dynamic graph. All fields are tensors."""

    alive: torch.Tensor    # bool[vcap]   vertex liveness
    ecnt: torch.Tensor     # int32[vcap]  per-vertex edge version counter
    esrc: torch.Tensor     # int32[ecap]  source vertex id (NOKEY = empty slot)
    edst: torch.Tensor     # int32[ecap]  destination vertex id
    ew: torch.Tensor       # f32[ecap]    weight; +inf = logically removed
    version: torch.Tensor  # int32[] scalar

    @property
    def vcap(self) -> int:
        return self.alive.shape[0]

    @property
    def ecap(self) -> int:
        return self.esrc.shape[0]

    @property
    def device(self) -> torch.device:
        return self.alive.device


def make_graph(vcap: int, ecap: int, *, device="cuda") -> GraphState:
    """An empty graph with capacity for ``vcap`` vertices and ``ecap`` edges."""
    dev = resolve_device(device)
    return GraphState(
        alive=torch.zeros((vcap,), dtype=torch.bool, device=dev),
        ecnt=torch.zeros((vcap,), dtype=torch.int32, device=dev),
        esrc=torch.full((ecap,), NOKEY, dtype=torch.int32, device=dev),
        edst=torch.full((ecap,), NOKEY, dtype=torch.int32, device=dev),
        ew=torch.full((ecap,), INF, dtype=torch.float32, device=dev),
        version=torch.zeros((), dtype=torch.int32, device=dev),
    )


def state_from_numpy(alive, ecnt, esrc, edst, ew, version, *,
                     device="cuda") -> GraphState:
    """Build the port's state from the six reference fields as numpy arrays.

    The arguments are ``repro.core.GraphState``'s fields in order, so
    ``state_from_numpy(*map(np.asarray, jax_state), device=...)`` carries a
    JAX snapshot across and both packages compute on the same graph.
    """
    dev = resolve_device(device)
    return GraphState(
        alive=torch.tensor(np.asarray(alive, np.bool_), device=dev),
        ecnt=torch.tensor(np.asarray(ecnt, np.int32), device=dev),
        esrc=torch.tensor(np.asarray(esrc, np.int32), device=dev),
        edst=torch.tensor(np.asarray(edst, np.int32), device=dev),
        ew=torch.tensor(np.asarray(ew, np.float32), device=dev),
        version=torch.tensor(np.asarray(version, np.int32), device=dev),
    )


def state_to_numpy(state: GraphState) -> GraphState:
    """The state's fields as host numpy arrays (a ``GraphState`` of arrays,
    in the reference's field order and dtypes)."""
    return GraphState(*(t.detach().cpu().numpy() for t in state))


# ---------------------------------------------------------------------------
# Sorted-pair search: the vectorized BST descent.
# ---------------------------------------------------------------------------

def _pair_key(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """int64 key whose order is the lexicographic order of int32 pairs."""
    return (src.to(torch.int64) << 32) + (dst.to(torch.int64) + 2**31)


def pair_searchsorted(esrc: torch.Tensor, edst: torch.Tensor,
                      qu: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """Leftmost index where ``(esrc, edst) >= (qu, qv)``, vectorized over q.

    ``(esrc, edst)`` must be lexicographically sorted (empty slots = NOKEY
    sort last).  The reference runs a fixed-step binary search on the int32
    pairs; here the pairs fold into an order-preserving int64 key and
    ``torch.searchsorted`` does the descent.  Returns int64 indices.
    """
    return torch.searchsorted(_pair_key(esrc, edst), _pair_key(qu, qv))


def find_edge_slots(state: GraphState, qu: torch.Tensor, qv: torch.Tensor):
    """Locate edge keys. Returns ``(idx, key_present, live)``.

    ``key_present``: the key occupies a slot (live or tombstoned).
    ``live``: key present AND not logically removed AND both endpoints alive.
    """
    idx = pair_searchsorted(state.esrc, state.edst, qu, qv)
    idxc = idx.clamp(0, state.ecap - 1)
    key_present = ((state.esrc[idxc] == qu) & (state.edst[idxc] == qv)
                   & (qu != NOKEY))
    quc = qu.clamp(0, state.vcap - 1).long()
    qvc = qv.clamp(0, state.vcap - 1).long()
    live = (key_present & (state.ew[idxc] < INF) & state.alive[quc]
            & state.alive[qvc])
    return idxc, key_present, live


# ---------------------------------------------------------------------------
# Derived views & maintenance.
# ---------------------------------------------------------------------------

def live_edge_mask(state: GraphState) -> torch.Tensor:
    """bool[ecap]: slots holding a live (unmarked, endpoints-alive) edge."""
    src_ok = state.alive[state.esrc.clamp(0, state.vcap - 1).long()]
    dst_ok = state.alive[state.edst.clamp(0, state.vcap - 1).long()]
    return (state.esrc != NOKEY) & (state.ew < INF) & src_ok & dst_ok


def num_vertices(state: GraphState) -> torch.Tensor:
    return state.alive.sum(dtype=torch.int32)


def num_edges(state: GraphState) -> torch.Tensor:
    return live_edge_mask(state).sum(dtype=torch.int32)


def used_slots(state: GraphState) -> torch.Tensor:
    """Occupied slots (live + tombstones)."""
    return (state.esrc != NOKEY).sum(dtype=torch.int32)


def compact(state: GraphState) -> GraphState:
    """Physically remove tombstoned edges (the paper's unlink/"helping").

    A stable sort by the removed-flag keeps live entries in lexicographic
    order and pushes tombstones (converted to empty slots) to the end.
    """
    removed = (state.ew >= INF) | (state.esrc == NOKEY)
    order = torch.sort(removed.to(torch.int8), stable=True).indices
    rem = removed[order]
    return state._replace(
        esrc=torch.where(rem, NOKEY, state.esrc[order]),
        edst=torch.where(rem, NOKEY, state.edst[order]),
        ew=torch.where(rem, INF, state.ew[order]))


def grow_edges(state: GraphState, factor: int = 2) -> GraphState:
    """Reallocate the edge table with more slack (the paper's RESIZE grow)."""
    extra = state.ecap * (factor - 1)
    dev = state.device
    return state._replace(
        esrc=torch.cat([state.esrc, torch.full((extra,), NOKEY,
                                               dtype=torch.int32, device=dev)]),
        edst=torch.cat([state.edst, torch.full((extra,), NOKEY,
                                               dtype=torch.int32, device=dev)]),
        ew=torch.cat([state.ew, torch.full((extra,), INF,
                                           dtype=torch.float32, device=dev)]))


def grow_vertices(state: GraphState, factor: int = 2) -> GraphState:
    """Reallocate the vertex table (RESIZE grow for the hash table)."""
    extra = state.vcap * (factor - 1)
    dev = state.device
    return state._replace(
        alive=torch.cat([state.alive, torch.zeros((extra,), dtype=torch.bool,
                                                  device=dev)]),
        ecnt=torch.cat([state.ecnt, torch.zeros((extra,), dtype=torch.int32,
                                                device=dev)]))


def scatter_min_dense(rows: torch.Tensor, cols: torch.Tensor,
                      vals: torch.Tensor, shape) -> torch.Tensor:
    """f32 matrix of ``shape`` filled with +inf, then ``out[r, c] =
    min(out[r, c], v)`` for every triple: the reference's
    ``.at[].min(mode="drop")``.

    Callers pass only in-range triples (they mask instead of relying on
    drop semantics: on CUDA an out-of-range index is a device assert).
    """
    nr, nc = shape
    out = torch.full((nr * nc,), INF, dtype=torch.float32, device=vals.device)
    flat = rows.long() * nc + cols.long()
    out.scatter_reduce_(0, flat, vals, "amin")
    return out.view(nr, nc)


def densify(state: GraphState) -> torch.Tensor:
    """Dense weight matrix ``W[f32, vcap x vcap]``; +inf = no edge."""
    live = live_edge_mask(state)
    return scatter_min_dense(state.esrc[live], state.edst[live],
                             state.ew[live], (state.vcap, state.vcap))


def from_edge_list(vcap: int, ecap: int, src, dst, w=None, *,
                   device="cuda") -> GraphState:
    """Build a committed graph from host edge arrays (bulk load)."""
    dev = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if w is None:
        w = np.ones_like(src, np.float32)
    w = np.asarray(w, np.float32)
    # dedup, keep last weight
    keys = src.astype(np.int64) * np.int64(vcap) + dst.astype(np.int64)
    order = np.argsort(keys, kind="stable")
    keys, src, dst, w = keys[order], src[order], dst[order], w[order]
    last = np.ones(len(keys), bool)
    last[:-1] = keys[:-1] != keys[1:]
    src, dst, w = src[last], dst[last], w[last]
    n = len(src)
    if n > ecap:
        raise ValueError(f"edge capacity {ecap} < {n} edges")
    esrc = np.full((ecap,), NOKEY, np.int32)
    edst = np.full((ecap,), NOKEY, np.int32)
    ew = np.full((ecap,), np.inf, np.float32)
    esrc[:n], edst[:n], ew[:n] = src, dst, w
    alive = np.zeros((vcap,), bool)
    alive[np.unique(np.concatenate([src, dst]))] = True
    return state_from_numpy(alive, np.zeros((vcap,), np.int32), esrc, edst,
                            ew, np.int32(0), device=dev)
