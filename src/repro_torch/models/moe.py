"""Mixture-of-Experts, single-device capacity dispatch (port of
``repro.models.moe``: ``init_moe``, ``_route``, ``_positions_in_bucket``,
``_moe_dense``).

Tokens beyond an expert's capacity are dropped (standard capacity-factor
semantics); which ones is decided by their token-major rank in the
expert's bucket.  The reference's expert-parallel ``_moe_shard_map`` and
the ``take_rows`` gradient wait for sharding and training (ROADMAP.md,
queue 1).  The load-balance loss is a training term and is not computed.
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


def route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k experts of each token, in descending probability, and their
    gates renormalised to sum to 1.  The router runs in float32."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    return gate / gate.sum(dim=-1, keepdim=True), idx


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


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].

    Each token's (token, expert) pair takes the next slot of the expert's
    bucket of ``cap = max(1, int(T * k * capacity_factor / E))`` slots; a
    pair past the capacity is dropped: its write goes to a spill slot that
    is cut off before the experts run (the reference's ``mode="drop"``
    scatter), and its gate is zeroed.
    """
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.num_experts
    cap = max(1, int(t * k * cfg.capacity_factor / e))

    xt = x.reshape(t, d)
    gate, idx = route(xt, p["router"], k)
    flat_e = idx.reshape(t * k)
    pos = positions_in_bucket(flat_e)
    keep = pos < cap
    tok = torch.arange(t * k, device=x.device) // k

    buf = torch.zeros((e + 1, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, flat_e, e), torch.where(keep, pos, cap)] = xt[tok]
    buf = buf[:e, :cap]
    hidden = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    eout = torch.bmm(hidden, p["wo"])                          # [E, C, d]

    gathered = eout[torch.where(keep, flat_e, 0), torch.where(keep, pos, 0)]
    wts = (gate.reshape(t * k) * keep).to(x.dtype)
    out = (gathered * wts[:, None]).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d)
