"""Mixture-of-Experts, single-device capacity dispatch (port of
``repro.models.moe``: ``init_moe``, ``_route``, ``_positions_in_bucket``,
``_moe_dense``).

Tokens beyond an expert's capacity are dropped (standard capacity-factor
semantics); which ones is decided by their token-major rank in the
expert's bucket.  ``moe`` also returns the Switch-style load-balance loss,
which training adds to its loss and serving ignores.  The reference's
expert-parallel ``_moe_shard_map`` and ``take_rows``, the gather whose
transpose is a gather that its backward needs, wait for LM sharding
(ROADMAP.md, queue 1, slice 4): the dense dispatch never calls
``take_rows``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _init


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": _init(gen, (d, e), torch.float32),  # f32 whatever the dtype
        "wi": _init(gen, (e, d, ff), cfg.dtype),
        "wg": _init(gen, (e, d, ff), cfg.dtype),
        "wo": _init(gen, (e, ff, d), cfg.dtype, scale=ff ** -0.5),
    }


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


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig, with_aux: bool = True):
    """x: [B, S, d] -> (out [B, S, d], load-balance loss, a float32 scalar,
    or None without ``with_aux``).

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
