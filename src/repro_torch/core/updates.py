"""Batched, vectorized ADT operations (port of ``repro.core.updates``).

``apply_batch`` applies a fixed-size array of operations in one vectorized
step and bumps ``version`` -- the commit is the batch's linearization
boundary.  Within a batch:

    1. vertex ops (PUTV / REMV) linearize first, in index order;
    2. edge ops (PUTE / REME) linearize next, in index order;
    3. reads (GETV / GETE) linearize at the end of the batch.

Intra-batch chains on one key resolve with sequential semantics via a
sorted segment walk: an op's precondition depends only on its immediate
predecessor in the (key, index)-sorted order.

Every scatter the reference writes with ``mode="drop"`` is an explicitly
masked write here: on CUDA an out-of-range index is a device assert, not
a no-op.  The reference's ``lexsort`` becomes one stable sort on an
order-preserving int64 key (the batch index breaks ties by stability).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .graph_state import (
    INF,
    NOKEY,
    GraphState,
    _pair_key,
    compact,
    find_edge_slots,
    grow_edges,
    pair_searchsorted,
    resolve_device,
    used_slots,
)

# Operation kinds.
NOP, PUTV, REMV, PUTE, REME, GETV, GETE = range(7)


class OpBatch(NamedTuple):
    kind: torch.Tensor   # int32[B]
    u: torch.Tensor      # int32[B]
    v: torch.Tensor      # int32[B]  (unused for vertex ops)
    w: torch.Tensor      # f32[B]    (PutE weight)


class OpResults(NamedTuple):
    ok: torch.Tensor     # bool[B]  boolean return of each op
    val: torch.Tensor    # f32[B]   weight return of edge ops (INF where n/a)


def make_batch(ops: Sequence[Tuple], size: int | None = None, *,
               device="cuda") -> OpBatch:
    """Host helper: list of (kind, u[, v[, w]]) tuples -> padded OpBatch."""
    dev = resolve_device(device)
    size = size or len(ops)
    kind = np.zeros((size,), np.int32)
    u = np.full((size,), NOKEY, np.int32)
    v = np.full((size,), NOKEY, np.int32)
    w = np.full((size,), np.inf, np.float32)
    for i, op in enumerate(ops):
        kind[i] = op[0]
        if len(op) > 1:
            u[i] = op[1]
        if len(op) > 2:
            v[i] = op[2]
        if len(op) > 3:
            w[i] = op[3]
    return OpBatch(*(torch.as_tensor(x, device=dev) for x in (kind, u, v, w)))


def _prev(arr: torch.Tensor, fill) -> torch.Tensor:
    rolled = torch.roll(arr, 1)
    rolled[0] = fill
    return rolled


def _next(arr: torch.Tensor, fill) -> torch.Tensor:
    rolled = torch.roll(arr, -1)
    rolled[-1] = fill
    return rolled


def _scatter(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """``base.at[where(mask, idx, OOB)].set(vals, mode="drop")`` with the
    drop made explicit; indices under ``mask`` are distinct."""
    out = base.clone()
    out[idx[mask].long()] = vals[mask]
    return out


def apply_batch(state: GraphState, ops: OpBatch):
    """Apply one op batch. Returns ``(new_state, OpResults, overflow)``.

    ``overflow`` (a bool tensor) is True when appended edges did not fit in
    the slack; the caller must ``compact``/``grow_edges`` and retry (see
    ``apply_ops``).  The input state is never written.
    """
    vcap, ecap = state.vcap, state.ecap
    dev = state.device
    B = ops.kind.shape[0]
    idxs = torch.arange(B, dtype=torch.int32, device=dev)

    ok_out = torch.zeros((B,), dtype=torch.bool, device=dev)
    val_out = torch.full((B,), INF, dtype=torch.float32, device=dev)

    # ---------------- Phase 1: vertex ops -------------------------------
    isv = (ops.kind == PUTV) | (ops.kind == REMV)
    vkey = torch.where(isv & (ops.u >= 0) & (ops.u < vcap), ops.u, NOKEY)
    perm = torch.sort(vkey, stable=True).indices
    sk, skind = vkey[perm], ops.kind[perm]
    first = sk != _prev(sk, -1)
    pre_alive = state.alive[sk.clamp(0, vcap - 1).long()] & (sk != NOKEY)
    prev_is_put = _prev(skind, NOP) == PUTV
    present_before = torch.where(first, pre_alive, prev_is_put)
    okv = torch.where(skind == PUTV, ~present_before, present_before) \
        & (sk != NOKEY)
    ok_sorted = torch.zeros((B,), dtype=torch.bool, device=dev)
    ok_sorted[perm] = okv
    ok_out = torch.where(isv, ok_sorted, ok_out)

    is_last = sk != _next(sk, -1)
    alive2 = _scatter(state.alive, sk, skind == PUTV,
                      is_last & (sk != NOKEY))

    # vertices successfully removed at any point in the batch: their incident
    # edges are invalidated (fresh empty edge-list on re-add, as in the paper).
    remv_succ = okv & (skind == REMV)
    had_remv = torch.zeros((vcap,), dtype=torch.bool, device=dev)
    had_remv[sk[remv_succ].long()] = True

    esrcc = state.esrc.clamp(0, vcap - 1).long()
    edstc = state.edst.clamp(0, vcap - 1).long()
    kill = (state.esrc != NOKEY) & (state.ew < INF) & (
        had_remv[esrcc] | had_remv[edstc])
    ew2 = torch.where(kill, INF, state.ew)
    ecnt2 = state.ecnt.clone().index_add_(0, esrcc, kill.to(torch.int32))

    # ---------------- Phase 2: edge ops ---------------------------------
    ise = (ops.kind == PUTE) | (ops.kind == REME)
    in_range = (ops.u >= 0) & (ops.u < vcap) & (ops.v >= 0) & (ops.v < vcap)
    valid = (ise & in_range & alive2[ops.u.clamp(0, vcap - 1).long()]
             & alive2[ops.v.clamp(0, vcap - 1).long()])
    ku = torch.where(valid, ops.u, NOKEY)
    kv = torch.where(valid, ops.v, NOKEY)
    perm_e = torch.sort(_pair_key(ku, kv), stable=True).indices
    su, sv = ku[perm_e], kv[perm_e]
    skind_e, sw = ops.kind[perm_e], ops.w[perm_e]

    first_e = (su != _prev(su, -1)) | (sv != _prev(sv, -1))
    slot = pair_searchsorted(state.esrc, state.edst, su, sv)
    slotc = slot.clamp(0, ecap - 1)
    key_present = ((state.esrc[slotc] == su) & (state.edst[slotc] == sv)
                   & (su != NOKEY))
    pre_live = key_present & (ew2[slotc] < INF)
    pre_w = torch.where(pre_live, ew2[slotc], INF)

    prev_put = _prev(skind_e, NOP) == PUTE
    prev_w = _prev(sw, INF)
    pres_before = torch.where(first_e, pre_live, prev_put)
    w_before = torch.where(first_e, pre_w, torch.where(prev_put, prev_w, INF))

    is_pute = skind_e == PUTE
    # Invalid ops (NOKEY-keyed) must not chain presence to one another.
    pres_before = pres_before & (su != NOKEY)
    ok_e = (su != NOKEY) & torch.where(
        is_pute, ~pres_before | (w_before != sw), pres_before)
    ret_e = torch.where(pres_before, w_before, INF)
    ok_e_out = torch.zeros((B,), dtype=torch.bool, device=dev)
    ok_e_out[perm_e] = ok_e
    ret_out = torch.full((B,), INF, dtype=torch.float32, device=dev)
    ret_out[perm_e] = ret_e
    ok_out = torch.where(ise, ok_e_out, ok_out)
    val_out = torch.where(ise, ret_out, val_out)

    # ecnt: one bump per successful out-edge-list mutation at the source.
    # (rows that fail add 0, so their clamped index is harmless)
    ecnt3 = ecnt2.clone().index_add_(0, su.clamp(0, vcap - 1).long(),
                                     ok_e.to(torch.int32))

    # Final state per key = last op of each segment.
    is_last_e = (su != _next(su, -1)) | (sv != _next(sv, -1))
    last_mask = is_last_e & (su != NOKEY)

    # In-place finals (key already occupies a slot, live or tombstoned).
    inplace = last_mask & key_present
    ew3 = _scatter(ew2, slot, torch.where(is_pute, sw, INF), inplace)

    # Appends: final PutE on a key with no slot.  ``su`` is sorted, so the
    # compressed append list stays sorted.
    app = last_mask & is_pute & ~key_present
    app_rank = torch.cumsum(app.to(torch.int32), 0) - 1
    cu = _scatter(torch.full((B,), NOKEY, dtype=torch.int32, device=dev),
                  app_rank, su, app)
    cv = _scatter(torch.full((B,), NOKEY, dtype=torch.int32, device=dev),
                  app_rank, sv, app)
    cw = _scatter(torch.full((B,), INF, dtype=torch.float32, device=dev),
                  app_rank, sw, app)
    n_app = app.sum(dtype=torch.int32)
    overflow = used_slots(state) + n_app > ecap

    # Merge-scatter: shift old entries right past their insertion points.
    pos = pair_searchsorted(state.esrc, state.edst, cu, cv)
    slots = torch.arange(ecap, dtype=torch.int64, device=dev)
    dest_old = slots + torch.searchsorted(pos, slots, right=True)
    keep_old = dest_old < ecap
    esrc3 = _scatter(torch.full((ecap,), NOKEY, dtype=torch.int32,
                                device=dev), dest_old, state.esrc, keep_old)
    edst3 = _scatter(torch.full((ecap,), NOKEY, dtype=torch.int32,
                                device=dev), dest_old, state.edst, keep_old)
    ew4 = _scatter(torch.full((ecap,), INF, dtype=torch.float32, device=dev),
                   dest_old, ew3, keep_old)
    dest_new = pos + idxs.long()
    put_new = (cu != NOKEY) & (dest_new < ecap)
    esrc3 = _scatter(esrc3, dest_new, cu, put_new)
    edst3 = _scatter(edst3, dest_new, cv, put_new)
    ew4 = _scatter(ew4, dest_new, cw, put_new)

    new_state = GraphState(
        alive=alive2, ecnt=ecnt3, esrc=esrc3, edst=edst3, ew=ew4,
        version=state.version + 1)

    # ---------------- Phase 3: reads (GETV / GETE) ----------------------
    isgv = ops.kind == GETV
    isge = ops.kind == GETE
    gv_ok = alive2[ops.u.clamp(0, vcap - 1).long()] & in_range
    _, _, ge_live = find_edge_slots(new_state, torch.where(isge, ops.u, NOKEY),
                                    torch.where(isge, ops.v, NOKEY))
    ge_slot = pair_searchsorted(esrc3, edst3, ops.u, ops.v)
    ge_w = torch.where(ge_live, ew4[ge_slot.clamp(0, ecap - 1)], INF)
    ok_out = torch.where(isgv, gv_ok, ok_out)
    ok_out = torch.where(isge, ge_live, ok_out)
    val_out = torch.where(isge, ge_w, val_out)

    return new_state, OpResults(ok_out, val_out), overflow


def apply_ops(state: GraphState, ops: Sequence[Tuple],
              batch_size: int | None = None):
    """Host convenience: apply ops with automatic compact/grow on overflow.

    On overflow: ``compact``, and -- when even a tombstone-free table cannot
    hold one append per batch slot -- ``grow_edges`` before the single
    retry, which then cannot overflow again.
    """
    batch = make_batch(ops, batch_size, device=state.device)
    B = int(batch.kind.shape[0])
    while True:
        new_state, res, overflow = apply_batch(state, batch)
        if not bool(overflow):
            return new_state, res
        state = compact(state)
        while int(used_slots(state)) + B > state.ecap:
            state = grow_edges(state)


# ------------------------- dirty-set helpers ----------------------------
# ``ecnt[u]`` is bumped on every successful mutation of u's out-edges
# (including RemV-driven incident-edge invalidation, which bumps the
# *source* of every killed edge), so the ecnt delta covers every edge
# change; the alive delta covers vertex insertion/removal.

def dirty_vertices(prev: GraphState, new: GraphState) -> torch.Tensor:
    """bool[vcap]: vertices whose edge list or liveness changed prev -> new.

    Both states must share ``vcap`` (use ``dirty_vertices_padded`` across a
    ``grow_vertices`` boundary).
    """
    return (prev.ecnt != new.ecnt) | (prev.alive != new.alive)


def dirty_vertices_padded(prev: GraphState, new: GraphState) -> torch.Tensor:
    """``dirty_vertices`` tolerant of vertex-table growth between commits.

    Vertices that exist only in ``new`` are dirty iff alive or touched
    (their prev-side ecnt/alive are taken as zero/False).
    """
    if prev.vcap == new.vcap:
        return dirty_vertices(prev, new)
    if prev.vcap > new.vcap:
        raise ValueError("vertex table shrank between commits")
    pad = new.vcap - prev.vcap
    dev = prev.device
    grown = prev._replace(
        alive=torch.cat([prev.alive, torch.zeros((pad,), dtype=torch.bool,
                                                 device=dev)]),
        ecnt=torch.cat([prev.ecnt, torch.zeros((pad,), dtype=torch.int32,
                                               device=dev)]))
    return dirty_vertices(grown, new)


# ------------------------- standalone reads -----------------------------

def get_v(state: GraphState, u) -> torch.Tensor:
    u = torch.as_tensor(u, dtype=torch.int32, device=state.device)
    return (state.alive[u.clamp(0, state.vcap - 1).long()] & (u >= 0)
            & (u < state.vcap))


def get_e(state: GraphState, u, v):
    u = torch.as_tensor(u, dtype=torch.int32, device=state.device)
    v = torch.as_tensor(v, dtype=torch.int32, device=state.device)
    idx, _, live = find_edge_slots(state, u, v)
    return live, torch.where(live, state.ew[idx], INF)
