"""Functional layer library, forward only (port of ``repro.models.layers``):
norms, RoPE / M-RoPE, GQA attention, MLP, embeddings.

Parameters are plain dicts of tensors, as the reference's pytrees.  The
reference's sharding constraints are gone: one device needs none.  The
reference's ``preferred_element_type=float32`` products (attention scores,
logits) multiply the operands upcast to float32, which is exact for bf16
operands and accumulates in float32 as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .config import ModelConfig


def _init(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    """Normal(0, 1) * scale in float32 on ``gen``'s device, then cast;
    ``scale`` defaults to fan_in ** -0.5 (``repro.models.layers._init``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# ------------------------------- norms -----------------------------------

def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast to x's dtype, then scale by ``w``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)).to(x.dtype) * w).to(x.dtype)


# ------------------------------ RoPE / M-RoPE ----------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: Optional[tuple] = None) -> torch.Tensor:
    """x: [B, H, S, D]. positions: [B, S] or [3, B, S] for M-RoPE.

    Rotates the interleaved pairs (x[..., 0::2], x[..., 1::2]), as the
    reference does (not the half split).  M-RoPE (Qwen2-VL): the rotary
    half-dim splits into (t, h, w) sections, each rotated by its own
    position stream; sections reaching past D/2 are clamped as the
    reference's slices clamp (at head_dim 32, (16, 24, 24) keeps only t).
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [D/2]
    if positions.dim() == 2:
        positions = positions[None].expand(3, *positions.shape)
    ang = positions[..., None].float() * freqs                 # [3, B, S, D/2]
    if sections is None:
        ang = ang[0]
    else:
        parts = []
        start = 0
        for i, sec in enumerate(sections):
            parts.append(ang[i, ..., start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)                         # [B, S, D/2]
    cos = torch.cos(ang)[:, None].to(x.dtype)                  # [B, 1, S, D/2]
    sin = torch.sin(ang)[:, None].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


# ------------------------------ attention --------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    params = {
        "wq": _init(gen, (d, h * hd), cfg.dtype),
        "wk": _init(gen, (d, kv * hd), cfg.dtype),
        "wv": _init(gen, (d, kv * hd), cfg.dtype),
        "wo": _init(gen, (h * hd, d), cfg.dtype, scale=(h * hd) ** -0.5),
    }
    if cfg.qk_norm:
        params["q_norm"] = init_rmsnorm(hd, cfg.dtype, gen.device)
        params["k_norm"] = init_rmsnorm(hd, cfg.dtype, gen.device)
    return params


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, q_offset: int, chunk: int,
                 window: Optional[int], softcap: float = 0.0) -> torch.Tensor:
    """Full-head attention in plain PyTorch, ``chunk`` query rows at a time
    (port of ``repro.models.layers._sdpa_chunked``).

    q, k, v: [B, H, S, D] with K/V already expanded to the full head count.
    Query row i sits at position ``q_offset + i`` and sees key j iff
    ``j <= q_offset + i`` (causal) and ``j > q_offset + i - window``.
    Scores in float32; the probabilities are cast to v's dtype for the
    second product, as in the reference.
    """
    sq, d0 = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = d0 ** -0.5
    kpos = torch.arange(skv, device=q.device)
    kt = k.float().transpose(-1, -2)
    out = []
    for s0 in range(0, sq, chunk):
        qc = q[:, :, s0:s0 + chunk]
        qpos = q_offset + s0 + torch.arange(qc.shape[2], device=q.device)
        s = (qc.float() @ kt) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = torch.ones((qc.shape[2], skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, -math.inf)
        p = torch.softmax(s, dim=-1)
        p = torch.where(torch.isnan(p), 0.0, p)
        out.append(p.to(v.dtype) @ v)
    return torch.cat(out, dim=2) if len(out) > 1 else out[0]


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None, window: Optional[int] = None,
              kv_x: Union[torch.Tensor, str, None] = None,
              causal: bool = True, use_rope: bool = True):
    """GQA attention. Returns ``(out, new_cache)``.

    cache (self-attn): dict(k=[B,KV,Smax,D], v=..., idx=int) -- keys are
    stored rotated; the fresh rows are written at ``idx`` IN PLACE (the
    returned cache holds the same tensors and ``idx + Sq``).
    ``kv_x``: a tensor [B, Skv, d] gives keys and values from that sequence
    instead (cross-attention: no RoPE, no causal mask, no cache);
    ``"cached"`` takes them from ``cache = dict(k=[B,KV,Se,D], v=...)``
    (``init_cross_kv``) as they are: no projection, no qk-norm, no RoPE,
    no causal mask, and the cache is returned unchanged.  ``use_rope=False``
    leaves self-attention's q and k unrotated.

    Prefill (Sq > 1) with ``cfg.attn_impl == "flash"`` and no logit softcap
    runs the flash kernel; self-attention hands it the filled cache prefix
    ``[:idx + Sq]`` only: the kernel aligns its causal mask at the ends, so
    the empty slots past the prefix must not reach it.  Cross-attention
    hands it the whole K/V, not causal.  Everything else (decode, ``"xla"``)
    runs ``sdpa_chunked`` over the whole cache, whose absolute-position
    mask hides the empty slots, with K/V repeated to the full head count.
    """
    b, sq, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, sq, h, hd)
    cross_cached = isinstance(kv_x, str) and kv_x == "cached"
    if cross_cached:
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        k, v = _project_kv(p, cfg, x if kv_x is None else kv_x)
        new_cache = None

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if not cross_cached:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)  # [B,KV,S,D], D last
    q = q.transpose(1, 2)   # [B, H, Sq, D]

    is_self = kv_x is None
    q_offset = cache["idx"] if (cache is not None and is_self) else 0
    if use_rope and is_self:
        pos = positions if positions is not None else (
            q_offset + torch.arange(sq, device=x.device))[None].expand(b, sq)
        q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope_sections)

    if cache is not None and is_self:
        ck, cv = cache["k"], cache["v"]
        ck[:, :, q_offset:q_offset + sq] = k.to(ck.dtype)
        cv[:, :, q_offset:q_offset + sq] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "idx": q_offset + sq}
        k, v = ck, cv

    if cfg.attn_impl == "flash" and sq > 1 and cfg.logit_softcap == 0:
        if is_self:  # the filled prefix only
            k, v = k[:, :, :q_offset + sq], v[:, :, :q_offset + sq]
        out = kops.flash_attention(q, k, v, causal=causal and is_self,
                                   window=window)
    else:
        g = h // kv
        if g > 1:
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
        out = sdpa_chunked(q, k, v, causal=causal and is_self,
                           q_offset=q_offset, chunk=cfg.attn_chunk,
                           window=window, softcap=cfg.logit_softcap)
    out = out.transpose(1, 2).reshape(b, sq, h * hd)
    return out @ p["wo"], new_cache


def _project_kv(p: dict, cfg: ModelConfig, src: torch.Tensor):
    """K and V [B, KV, S, D] of the sequence ``src`` [B, S, d]."""
    shape = (src.shape[0], src.shape[1], cfg.num_kv_heads, cfg.head_dim)
    return ((src @ p["wk"]).reshape(shape).transpose(1, 2),
            (src @ p["wv"]).reshape(shape).transpose(1, 2))


def init_cross_kv(p: dict, cfg: ModelConfig,
                  enc_out: torch.Tensor) -> dict:
    """Precompute cross-attention K/V [B, KV, Se, D] from the encoder's
    output (the decode cache of ``kv_x="cached"``)."""
    k, v = _project_kv(p, cfg, enc_out)
    return {"k": k, "v": v}


# -------------------------------- MLP ------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": _init(gen, (d, ff), cfg.dtype),
        "wg": _init(gen, (d, ff), cfg.dtype),
        "wo": _init(gen, (ff, d), cfg.dtype, scale=ff ** -0.5),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ p["wg"])
    up = x @ p["wi"]
    return (gate * up) @ p["wo"]


# ----------------------------- embeddings --------------------------------

def init_embed(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    return _init(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype, scale=1.0)


def init_unembed(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    """Untied output head [d, vocab], as in the reference."""
    return _init(gen, (cfg.d_model, cfg.vocab_size), cfg.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed_logits(head: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full float32 logits (decode-time: S is tiny)."""
    return h.float() @ head.float()
