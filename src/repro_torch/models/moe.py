"""Mixture-of-Experts (port of ``repro.models.moe``) with real expert
parallelism on a mesh of processes.

Two implementations behind one ``moe()`` entry point:

  * ``moe_shard_map`` -- used whenever a mesh with (data, model) axes is
    installed and the sizes divide (the reference's conditions).  Experts
    are sharded over ``data`` (EP) and each expert's FFN over ``model``
    (TP); each process holds its block of the expert stacks and runs the
    reference's ``shard_map`` body on its own tokens: they travel to their
    expert's owner row in per-destination capacity buckets through an
    ``all_to_all`` over ``data``, run through the owner's experts, and
    return through the reverse ``all_to_all``; the TP partial outputs
    merge with one ``psum`` over ``model``.  All payload movement is
    ``take_rows`` (a gather both ways).
  * the dense capacity dispatch (scatter into [E, C, d]), used on one
    process and, on a mesh, where the sizes do not divide (then over the
    whole batch, its expert blocks gathered).

Both drop (token, expert) pairs beyond capacity and return the
Switch-style load-balance loss, which training adds to its loss and
serving ignores.  On the mesh that loss is computed per data row (over
the row's tokens) and averaged over the rows, as the reference's
``pmean`` does: it is not the dense path's loss of the whole batch, so
the two paths agree only where nothing drops and the batch is one row.
Within ``drop_tally()`` each dispatch also counts the pairs it dropped.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import sharding_ctx as sc
from .config import ModelConfig
from .layers import FSDP, TP, _init
from .sharding_ctx import P


# The dropped-pair counts of this process's dispatches, where a caller asks
# for them (``drop_tally``); None otherwise.
_DROPS = None


@contextlib.contextmanager
def drop_tally():
    """Within ``with``: a list that gets, for each MoE dispatch of this
    process, the (token, expert) pairs it dropped at capacity as a device
    scalar (no host read): the dense dispatch's overfull buckets, or the
    mesh's outbound row buckets and its owner-side expert buffers."""
    global _DROPS
    old, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = old


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": _init(gen, (d, e), torch.float32),  # f32 whatever the dtype
        "wi": _init(gen, (e, d, ff), cfg.dtype),
        "wg": _init(gen, (e, d, ff), cfg.dtype),
        "wo": _init(gen, (e, ff, d), cfg.dtype, scale=ff ** -0.5),
    }


def moe_specs(cfg: ModelConfig) -> dict:
    # Experts over the data axis (EP), expert-FFN hidden over model (TP).
    return {"router": P(None, None), "wi": P(FSDP, None, TP),
            "wg": P(FSDP, None, TP), "wo": P(FSDP, TP, None)}


def route(xt: torch.Tensor, router: torch.Tensor, k: int,
          with_aux: bool = True):
    """Top-k experts of each token, in descending probability, their gates
    renormalised to sum to 1, and the load-balance loss ``E * sum_e
    mean(probs[:, e]) * (share of tokens whose first choice is e)`` (None
    without ``with_aux``).  The router runs in float32.  The shares are
    counted with a scatter of ones, exact in float32 and with no host read
    (``F.one_hot`` reads the ids' range back)."""
    t, e = xt.shape[0], router.shape[1]
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    aux = None
    if with_aux:
        first = torch.zeros(e, device=xt.device).scatter_add_(
            0, idx[:, 0], torch.ones(t, device=xt.device)) / t
        aux = e * torch.sum(probs.mean(dim=0) * first)
    return gate / gate.sum(dim=-1, keepdim=True), idx, aux


def positions_in_bucket(bucket_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its bucket, in element order: the
    reference's exclusive cumsum of the one-hot matrix, computed as a
    stable sort (elements of one bucket keep their order) minus the index
    where each bucket starts.  The [N, E] cumsum down the rows runs one
    thread per column on the GPU (14.7 ms per layer on an H100 at
    N = 65536, E = 32); a sort and a search over N elements do not."""
    ids = bucket_ids.long()
    sorted_ids, order = torch.sort(ids, stable=True)
    rank = (torch.arange(ids.numel(), device=ids.device)
            - torch.searchsorted(sorted_ids, sorted_ids))
    return torch.empty_like(rank).scatter_(0, order, rank)


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig, with_aux: bool = True,
        path=None):
    """x: [B, S, d] -> (out [B, S, d], load-balance loss, a float32 scalar,
    or None without ``with_aux``).  On a mesh ``x`` is this process's
    block of the batch and ``p``'s expert stacks its blocks (``path``:
    where they sit in the parameter tree); see the module docstring."""
    mesh = sc.live_mesh()
    if mesh is None:
        return moe_dense(p, x, cfg, with_aux)
    sizes = mesh.sizes
    b = x.shape[0] * math.prod(sizes[a] for a in sc.batch_axes())
    if ({"data", "model"} <= set(sizes)
            and cfg.num_experts % sizes["data"] == 0
            and cfg.d_ff % sizes["model"] == 0 and b % sizes["data"] == 0):
        return moe_shard_map(p, x, cfg, mesh, b)
    # The dense dispatch over the whole batch, as the reference's GSPMD
    # program runs it, on every process; each keeps its own rows.
    have = sc.batch_axes()
    full = sc.relayout(x, have, ())
    out, aux = moe_dense(sc.gathered(p, *path), full, cfg, with_aux)
    return sc.relayout(out, (), have), aux


def moe_dense(p: dict, x: torch.Tensor, cfg: ModelConfig,
              with_aux: bool = True):
    """The single-device capacity dispatch.

    Each token's (token, expert) pair takes the next slot of the expert's
    bucket of ``cap = max(1, int(T * k * capacity_factor / E))`` slots; a
    pair past the capacity is dropped: its write goes to a spill row of its
    own past the buckets, cut off before the experts run (the reference's
    ``mode="drop"`` scatter), and its gate is zeroed; it reads back some
    expert row (``pair % (E * C)``) times that zero gate.  So no row is
    written twice and none is read by more than a kept pair and
    ceil(T k / E C) dropped ones: the backward's scatters then have no long
    runs of one index, which CUDA's sorted index accumulation walks one
    element at a time (the reference gathers every dropped pair from row
    (0, 0)).  Where autograd does not track it, the gated hidden state is
    formed in place, which keeps one [E, C, ff] tensor fewer alive (llama4's
    no-drop check runs at C = 2078).
    """
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.num_experts
    cap = max(1, int(t * k * cfg.capacity_factor / e))

    xt = x.reshape(t, d)
    gate, idx, aux = route(xt, p["router"], k, with_aux)
    flat_e = idx.reshape(t * k)
    pos = positions_in_bucket(flat_e)
    keep = pos < cap
    if _DROPS is not None:
        _DROPS.append((~keep).sum())
    pair = torch.arange(t * k, device=x.device)
    slot = flat_e * cap + pos

    buf = torch.zeros((e * cap + t * k, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, slot, e * cap + pair)] = xt.repeat_interleave(
        k, dim=0)
    buf = buf[:e * cap].view(e, cap, d)
    hidden = torch.bmm(buf, p["wg"])
    if hidden.requires_grad:
        hidden = F.silu(hidden) * torch.bmm(buf, p["wi"])
    else:
        hidden = F.silu(hidden, inplace=True).mul_(torch.bmm(buf, p["wi"]))
    eout = torch.bmm(hidden, p["wo"])                          # [E, C, d]

    gathered = eout.reshape(e * cap, d)[torch.where(keep, slot,
                                                    pair % (e * cap))]
    wts = (gate.reshape(t * k) * keep).to(x.dtype)
    out = (gathered * wts[:, None]).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux


# ------------------------- expert parallelism ------------------------------

class _TakeRows(torch.autograd.Function):
    """``x[idx]`` with out-of-range rows -> 0, whose backward is also a
    gather: ``inv [N, K]`` lists, for each row of ``x``, the (up to K)
    output rows it feeds (out of range: none), so ``dx[n] = sum_j
    g[inv[n, j]]`` (the reference's ``take_rows`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return _fill_take(x, idx)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        dx = _fill_take(g, inv[:, 0])
        for j in range(1, inv.shape[1]):
            dx = dx + _fill_take(g, inv[:, j])
        return dx, None, None


def _fill_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    xp = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    return xp[torch.where(ok, idx, n)]


def take_rows(x: torch.Tensor, idx: torch.Tensor,
              inv: torch.Tensor) -> torch.Tensor:
    return _TakeRows.apply(x, idx, inv)


def _fill_scatter(n: int, idx: torch.Tensor, values: torch.Tensor,
                  fill: int) -> torch.Tensor:
    """``full((n,), fill).at[idx].set(values, mode="drop")`` for indices
    unique where they are below ``n`` (the rest land in a pad, cut)."""
    out = torch.full((n + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[torch.clamp(idx, max=n)] = values
    return out[:n]


def moe_shard_map(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh,
                  b: int):
    """The reference's ``_moe_shard_map`` on this process's block: ``x``
    [b_local, S, d] of a global batch of ``b`` rows, ``p``'s expert stacks
    [E / n_data, d, ff / n_model] (its data row's experts, its model
    column's hidden slice)."""
    sizes = mesh.sizes
    nd, nm = sizes["data"], sizes["model"]
    e, d, k = cfg.num_experts, cfg.d_model, cfg.top_k
    e_row = e // nd
    s = x.shape[1]
    # Every model column of a data row must see the row's tokens (the TP
    # psum merges their ff shards): when the batch splits over (data,
    # model) the body gathers the row over 'model' and keeps its own
    # rows of the result.
    gather_model = b % (nd * nm) == 0
    if gather_model:
        want = ("data", "model")
    elif "pod" in sizes and b % (sizes["pod"] * nd) == 0:
        want = ("pod", "data")
    else:
        want = ("data",)
    have = sc.batch_axes()

    def body(xin, router, wi, wg, wo):
        xl = sc.all_gather(xin, "model") if gather_model else xin
        bl = xl.shape[0]
        tl = bl * s
        xt = xl.reshape(tl, d)
        gate, idx, aux = route(xt, router, k)
        flat_e = idx.reshape(tl * k)
        row = flat_e // e_row                       # owner data row
        le = flat_e % e_row                         # expert within the row

        # ---- outbound: per-destination-row capacity buckets -------------
        cap = max(1, -(-tl * k * int(cfg.capacity_factor * 100) // 100
                       // nd))
        tk = tl * k
        pos = positions_in_bucket(row)
        keep = pos < cap
        slot_of = torch.where(keep, row * cap + pos, nd * cap)   # [tk]
        tr = nd * cap
        ar = torch.arange(tk, device=x.device)
        slot_src = _fill_scatter(tr, slot_of, ar, tk)
        send_x = take_rows(xt, torch.where(slot_src < tk, slot_src // k, tl),
                           slot_of.reshape(tl, k))
        send_le = _fill_scatter(tr, slot_of, le, -1)
        recv_x = sc.all_to_all(send_x, "data")
        recv_le = sc.all_to_all(send_le, "data")

        # ---- owner side: per-expert capacity buffers --------------------
        valid = recv_le >= 0
        c2 = max(1, -(-tr * 13 // (10 * e_row)))    # 1.3x local slack
        lec = torch.where(valid, recv_le, e_row)
        pos2 = positions_in_bucket(lec)
        keep2 = valid & (pos2 < c2)
        if _DROPS is not None:
            _DROPS.append((~keep).sum() + (valid & ~keep2).sum())
        eslot_of = torch.where(keep2, lec * c2 + pos2, e_row * c2)  # [tr]
        slot_tok = _fill_scatter(e_row * c2, eslot_of,
                                 torch.arange(tr, device=x.device), tr)
        buf = take_rows(recv_x, slot_tok, eslot_of[:, None]).reshape(
            e_row, c2, d)
        hidden = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
        part = sc.psum(torch.bmm(hidden, wo), "model")  # merge TP shards
        y_recv = take_rows(part.reshape(e_row * c2, d), eslot_of,
                           slot_tok[:, None])

        # ---- return trip + combine --------------------------------------
        y_send = sc.all_to_all(y_recv, "data")
        y_slot = take_rows(y_send, slot_of, slot_src[:, None])  # [tk, d]
        wts = (gate * keep.reshape(tl, k).to(gate.dtype)).to(x.dtype)
        y_tok = (y_slot.reshape(tl, k, d) * wts[:, :, None]).sum(dim=1)
        aux = sc.pmean(aux, "data")
        y = y_tok.reshape(bl, s, d)
        if gather_model:
            own = bl // nm
            c = mesh.coords["model"]
            y = y[c * own:(c + 1) * own]
        return y, aux

    xin = sc.relayout(x, have, want)
    args = (xin, p["router"], p["wi"], p["wg"], p["wo"])
    # The reference's jax.checkpoint(body); a layer rematerialised as a
    # whole (cfg.remat) already recomputes the body in its backward, and a
    # second checkpoint inside would run its collectives a third time.
    if torch.is_grad_enabled() and not cfg.remat:
        y, aux = checkpoint(body, *args, use_reentrant=False)
    else:
        y, aux = body(*args)
    return sc.relayout(y, want, have), aux
