"""Mamba2 (state-space duality / SSD) blocks and the Mamba2 LM, forward and
serving (port of ``repro.models.ssm``).

The SSD algorithm (Dao & Gu, arXiv:2405.21060) splits the sequence into
chunks: an intra-chunk quadratic term (batched products) plus an
inter-chunk linear state recurrence, here a Python loop over the chunks
(the reference's ``lax.scan``).  Decode is the O(1)-per-token state
recurrence.  The reference's simplifications are kept: n_groups = 1 (B/C
shared across heads), no bias terms, a gated RMSNorm before the output
projection.  No kernel is hand-written here: the reference has none (its
SSD is einsums, a cumsum and exps), so the port stays on torch ops.

Dtypes follow the reference's: ``dt`` and the decays in float32, rounded to
the activations' dtype at the same points (``att``, ``dtc * right``, the
chunk decay before it scales the state, ``left``), and the state kept in the
cache's dtype.  Mixed operands of a product are promoted first, as JAX's
einsum promotes them (``_ein``).

The cache, ``conv`` [L, B, K-1, C] and ``ssd`` [L, B, H, Pd, N], is written
in place, as the transformer's KV cache is.  On a mesh of processes a
process holds its block of it (channels and heads over ``model``): each
layer gathers its parameters and its state where it runs, and keeps its
own block of the new state (``sharding_ctx.whole_state`` /
``own_block``).  The two blocks need not cover the same heads (the
``conv`` block is contiguous over C = d_inner + 2N), so the state is
gathered whole rather than computed head-parallel.  ``loss_fn`` is the
reference's next-token cross-entropy; without a cache, ``forward``
rematerialises each layer in the backward when ``cfg.remat``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.graph_state import resolve_device

from . import layers as L
from .config import ModelConfig
from .layers import FSDP, TP
from .sharding_ctx import (P, gathered, own_block, stacked, unstacked,
                           whole_state)


def _ein(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on operands promoted to one dtype (JAX's einsum
    promotes a bf16 and a float32 operand to float32; torch's refuses)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in ops))
    return torch.einsum(eq, *(t.to(dtype) for t in ops))


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    c, dev = conv_dim(cfg), gen.device
    return {
        "in_z": L._init(gen, (d, di), cfg.dtype),
        "in_xbc": L._init(gen, (d, c), cfg.dtype),
        "in_dt": L._init(gen, (d, h), cfg.dtype),
        "conv_w": L._init(gen, (c, cfg.conv_kernel), cfg.dtype,
                          scale=cfg.conv_kernel ** -0.5),
        "conv_b": torch.zeros((c,), dtype=cfg.dtype, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=cfg.dtype, device=dev),
        "out": L._init(gen, (di, d), cfg.dtype, scale=di ** -0.5),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d and SiLU. xbc: [B, S, C]; w: [C, K].

    Without ``cache`` the sequence is left-padded with K-1 zeros; with it,
    ``cache`` [B, K-1, C] carries the history.  Returns (out [B, S, C],
    the new history, or None without a cache)."""
    k, s = w.shape[1], xbc.shape[1]
    if cache is None:
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        new_cache = None
    else:
        pad = torch.cat([cache.to(xbc.dtype), xbc], dim=1)
        new_cache = pad[:, -(k - 1):]
    out = sum(pad[:, i:i + s] * w[:, i] for i in range(k))
    return F.silu(out + b), new_cache


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD forward. x [B,S,H,Pd]; dt [B,S,H] (softplus applied, float32);
    a [H] (negative); bm, cm [B,S,N].  Returns (y [B,S,H,Pd], final state
    [B,H,Pd,N]).  A sequence that is not a multiple of ``chunk`` is padded
    with dt = 0, which is state-neutral: decay exp(0) = 1, update 0."""
    b, s, h, pd = x.shape
    n = bm.shape[-1]
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))

    xc = x.reshape(b, nc, chunk, h, pd)
    dtc = dt.reshape(b, nc, chunk, h).float()
    bc = bm.reshape(b, nc, chunk, n)
    cc = cm.reshape(b, nc, chunk, n)

    cum = torch.cumsum(dtc * a, dim=2)                    # [b,nc,l,h]

    # Intra-chunk quadratic term (the "attention-like" dual form).  The
    # upper triangle is set to -inf before the exp, so it decays to 0 and
    # never meets an overflowed exp.  In place where autograd does not
    # track it (serving): at full width each of these [b, nc, l, l, h]
    # float32 tensors is about 200 MB.  Autograd needs the exp's output
    # as it was, so training takes the out-of-place form.
    upper = ~torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    att = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b,nc,i,j,h]
    cb = _ein("bcin,bcjn->bcij", cc, bc)
    if att.requires_grad:
        att = (torch.exp(att.masked_fill(upper, -math.inf))
               * cb[..., None] * dtc[:, :, None, :, :])
    else:
        att.masked_fill_(upper, -math.inf).exp_()
        att.mul_(cb[..., None]).mul_(dtc[:, :, None, :, :])
    y_intra = _ein("bcijh,bcjhp->bcihp", att.to(x.dtype), xc)
    del att

    # Per-chunk boundary states.
    right = torch.exp(cum[:, :, -1:, :] - cum)            # [b,nc,l,h]
    wx = (dtc * right).to(x.dtype)[..., None] * xc        # [b,nc,l,h,pd]
    states = _ein("bcln,bclhp->bchpn", bc, wx)
    total = torch.exp(cum[:, :, -1, :])                   # [b,nc,h]

    hstate = init_state if init_state is not None else torch.zeros(
        (b, h, pd, n), dtype=x.dtype, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)
        hstate = (total[:, c, :, None, None].to(hstate.dtype) * hstate
                  + states[:, c])
    hprevs = torch.stack(hprevs, dim=1)                   # [b,nc,h,pd,n]

    left = torch.exp(cum)                                 # [b,nc,l,h]
    y_inter = (_ein("bcln,bchpn->bclhp", cc, hprevs)
               * left[..., None].to(x.dtype))
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, pd)
    return y[:, :s], hstate


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[dict] = None):
    """One Mamba2 block. cache: None or dict(conv=[B,K-1,C],
    ssd=[B,H,Pd,N]).  Returns (out [B,S,d], the new cache or None); the
    given cache is not written."""
    b, s, _ = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim

    z = x @ p["in_z"]
    xbc = x @ p["in_xbc"]
    dt_raw = (x @ p["in_dt"]).float()
    dt = F.softplus(dt_raw + p["dt_bias"])

    conv_cache = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_cache)
    xs = xbc[..., :di].reshape(b, s, h, pd)
    bm = xbc[..., di:di + n]
    cm = xbc[..., di + n:]

    a = -torch.exp(p["A_log"])

    if cache is None or s > 1:
        init_state = cache["ssd"] if cache is not None else None
        y, final = ssd_chunked(xs, dt, a, bm, cm, cfg.ssm_chunk, init_state)
    else:
        # decode: the one-step recurrence
        da = torch.exp(dt[:, 0] * a)                      # [b,h]
        upd = _ein("bn,bh,bhp->bhpn", bm[:, 0], dt[:, 0].to(x.dtype),
                   xs[:, 0])
        final = da[:, :, None, None].to(x.dtype) * cache["ssd"] + upd
        y = _ein("bn,bhpn->bhp", cm[:, 0], final)[:, None]

    y = y + xs * p["D"][:, None].to(x.dtype)
    y = y.reshape(b, s, di)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = _ein("bse,ed->bsd", y, p["out"])
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssd": final}
    return out, new_cache


def residual_block(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                   cache: Optional[dict] = None) -> torch.Tensor:
    """``h + mamba_block(rms_norm(h))`` with ``lp = {mixer, ln}``; with a
    cache (views of one layer's conv and ssd state) the new state is
    written into it in place.  On a mesh the cache is this process's
    block: the block runs on the whole state of its rows and writes its
    own block back."""
    whole = None if cache is None else {
        k: whole_state(cache[k], k) for k in ("conv", "ssd")}
    o, nc = mamba_block(lp["mixer"], L.rms_norm(h, lp["ln"], cfg.norm_eps),
                        cfg, whole)
    if cache is not None:
        for k in ("conv", "ssd"):
            cache[k].copy_(own_block(nc[k], k))
    return h + o


def init_ssm_cache(cfg: ModelConfig, batch_size: int, dtype=torch.bfloat16,
                   device="cuda", lead: tuple = ()) -> dict:
    """Zero conv history [*lead, B, K-1, C] and state [*lead, B, H, Pd, N]."""
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((*lead, batch_size, cfg.conv_kernel - 1,
                             conv_dim(cfg)), dtype=dtype, device=dev),
        "ssd": torch.zeros((*lead, batch_size, cfg.ssm_heads,
                            cfg.ssm_headdim, cfg.ssm_state), dtype=dtype,
                           device=dev),
    }


def layer_cache(caches: Optional[dict], *index) -> Optional[dict]:
    """One layer's views of a stacked SSM cache (None without one)."""
    if caches is None:
        return None
    return {"conv": caches["conv"][index], "ssd": caches["ssd"][index]}


def ssm_block_specs(cfg: ModelConfig) -> dict:
    return {
        "in_z": P(FSDP, TP), "in_xbc": P(FSDP, TP), "in_dt": P(FSDP, None),
        "conv_w": P(TP, None), "conv_b": P(TP),
        "A_log": P(None), "D": P(None), "dt_bias": P(None),
        "norm": P(TP), "out": P(TP, FSDP),
    }


def ssm_cache_specs(cfg: ModelConfig, lead: int = 1) -> dict:
    """conv [*lead, B, K-1, C], ssd [*lead, B, H, Pd, N]."""
    return {"conv": stacked(P(FSDP, None, TP), lead),
            "ssd": stacked(P(FSDP, TP, None, None), lead)}


def layer_specs(cfg: ModelConfig) -> dict:
    return {"mixer": ssm_block_specs(cfg), "ln": P(None)}


# ------------------------- full Mamba2 LM --------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"mixer": init_ssm_block(gen, cfg),
            "ln": L.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device)}


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, at the reference's scales."""
    return {"embed": L.init_embed(gen, cfg),
            "layers": [init_layer(gen, cfg) for _ in range(cfg.num_layers)],
            "final_norm": L.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
            "lm_head": L.init_unembed(gen, cfg)}


def specs(cfg: ModelConfig) -> dict:
    return {"embed": L.embed_specs(cfg),
            "layers": [layer_specs(cfg)] * cfg.num_layers,
            "final_norm": P(None), "lm_head": L.unembed_specs(cfg)}


def cache_specs(cfg: ModelConfig) -> dict:
    return ssm_cache_specs(cfg)


def cache_roles(shardings: dict, lead: int = 1) -> dict:
    """The cache's shardings by the role the cache branch reads them under
    (``sharding_context(cache=)``): one layer's ``conv`` and ``ssd``."""
    return {k: unstacked(shardings[k], lead) for k in ("conv", "ssd")}


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[dict] = None):
    """Returns ``(hidden [B,S,d], caches)``; with ``caches`` each layer's
    state is written into them in place.  On a mesh each layer's
    parameters are gathered where it runs."""
    h = L.embed(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        if caches is None:
            h = L.remat(cfg, residual_block, lp, h, cfg, path=("layers", i))
        else:
            h = residual_block(gathered(lp, "layers", i), h, cfg,
                               layer_cache(caches, i))
    return L.rms_norm(h, params["final_norm"], cfg.norm_eps), caches


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S]."""
    tokens = batch["tokens"]
    h, _ = forward(params, tokens[:, :-1], cfg)
    return L.next_token_loss(params["lm_head"], h, tokens, cfg)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero state for every layer: conv [L, B, K-1, C], ssd [L, B, H, Pd,
    N].  ``max_len`` is unused: the state does not grow."""
    return init_ssm_cache(cfg, batch_size, dtype, device,
                          lead=(cfg.num_layers,))


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            cache: dict, positions=None):
    """Run the tokens through the model from the cache's state.
    Returns (last-token logits [B, 1, V] in float32, cache)."""
    h, cache = forward(params, tokens, cfg, caches=cache)
    return L.unembed_logits(params["lm_head"], h[:, -1:, :]), cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: dict, positions=None):
    """One incremental token: tokens [B, 1] -> (logits [B,1,V], cache)."""
    return prefill(params, tokens, cfg, cache, positions)
