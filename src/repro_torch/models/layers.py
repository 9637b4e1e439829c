"""Functional layer library (port of ``repro.models.layers``): norms, RoPE /
M-RoPE, GQA attention, MLP, embeddings and the chunked cross-entropy.

Parameters are plain dicts of tensors, as the reference's pytrees, with
the reference's sharding specs (``*_specs``).  On a mesh of processes the
parameters are gathered where they are used (``remat(path=)``, ``embed``,
``next_token_loss``, ``unembed_logits``; ``sharding_ctx``), but serving
reads the embedding and the head by vocabulary block where they lie, and
attention reads a KV cache whose sequence is split over ``model``.  The
reference's ``preferred_element_type=float32`` products (attention scores,
logits) multiply the operands upcast to float32, which is exact for bf16
operands and accumulates in float32 as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops

from . import sharding_ctx
from .config import ModelConfig
from .sharding_ctx import P

# Sharding (the reference's MaxText-style FSDP + TP): weight matrices'
# input-feature dim over ``data``, output-feature dim over ``model``.
FSDP = "data"
TP = "model"


# Largest float32 draw ``_init`` makes at once.
INIT_DRAW_BYTES = 1 << 28


def _init(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    """Normal(0, 1) * scale in float32 on ``gen``'s device, then cast;
    ``scale`` defaults to fan_in ** -0.5 (``repro.models.layers._init``).

    A tensor whose float32 draw would exceed ``INIT_DRAW_BYTES`` is drawn
    in blocks of whole slices along its leading axis, each cast into the
    result, so the float32 transient is one block, not the tensor (an
    expert stack of llama4 is 21.5 GB in float32)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    slice_bytes = 4 * math.prod(shape[1:])
    if len(shape) < 2 or shape[0] * slice_bytes <= INIT_DRAW_BYTES:
        x = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.is_meta:     # shapes only (``param_shapes``): nothing to draw
        return out
    rows = max(1, INIT_DRAW_BYTES // slice_bytes)
    for r0 in range(0, shape[0], rows):
        n = min(rows, shape[0] - r0)
        x = torch.randn((n, *shape[1:]), generator=gen, device=gen.device,
                        dtype=torch.float32)
        out[r0:r0 + n] = x.mul_(scale)
    return out


def remat(cfg: ModelConfig, fn, lp, *args, path=None, keep=()):
    """``fn(lp, *args)``, rematerialised in the backward when ``cfg.remat``
    and autograd is on (the reference's ``jax.checkpoint`` of a layer
    body): the forward keeps the block's inputs only.  ``path`` names the
    parameters ``lp`` in the installed tree: on a mesh they are gathered
    inside the region (``sharding_ctx.gathered``, but ``keep``'s
    subtrees), so the backward gathers them again instead of keeping them
    whole."""
    if path is not None and sharding_ctx.live_mesh() is not None:
        inner = fn

        def fn(lp, *a):
            return inner(sharding_ctx.gathered(lp, *path, keep=keep), *a)
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, lp, *args, use_reentrant=False)
    return fn(lp, *args)


def next_token_loss(head: torch.Tensor, h: torch.Tensor,
                    tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of the hidden states ``h`` [B, S-1, d]
    of ``tokens[:, :-1]``: targets ``tokens[:, 1:]``, token id 0 masked
    out (every family's ``loss_fn`` in the reference)."""
    targets = tokens[:, 1:]
    mask = (targets != 0).float()
    nll, cnt = unembed_chunked_xent(sharding_ctx.gathered(head, "lm_head"),
                                    h, targets, mask, cfg.xent_chunk)
    # On a mesh: this process's share, over the whole batch's count.
    cnt = sharding_ctx.batch_total(cnt)
    return sharding_ctx.batch_share(nll / torch.clamp(cnt, min=1.0))


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


def attention_specs(cfg: ModelConfig) -> dict:
    specs = {"wq": P(FSDP, TP), "wk": P(FSDP, TP), "wv": P(FSDP, TP),
             "wo": P(TP, FSDP)}
    if cfg.qk_norm:
        specs["q_norm"] = P(None)
        specs["k_norm"] = P(None)
    return specs


def kv_cache_spec() -> P:
    """A K/V cache [L, B, KV, S, D]: batch over data, sequence over model
    (the reference's sequence parallelism)."""
    return P(None, FSDP, None, TP, None)


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, q_offset: int, chunk: int,
                 window: Optional[int], softcap: float = 0.0) -> torch.Tensor:
    """Full-head attention in plain PyTorch, ``chunk`` query rows at a time
    (port of ``repro.models.layers._sdpa_chunked``).

    q, k, v: [B, H, S, D] with K/V already expanded to the full head count.
    Query row i sits at position ``q_offset + i`` and sees key j iff
    ``j <= q_offset + i`` (causal) and ``j > q_offset + i - window``.
    Scores in float32; the probabilities are cast to v's dtype for the
    second product, as in the reference.  A chunk reads only the keys some
    of its rows can see (causal: up to its last row; windowed: from its
    first row's window on): the rest would be masked to exact zeros.
    Under autograd with more than one chunk, each chunk is rematerialised
    in the backward (the reference's ``jax.checkpoint`` of its scan body),
    so the backward holds one chunk's float32 scores, not the whole [S,
    Skv] matrix.
    """
    sq, skv = q.shape[2], k.shape[2]
    kt = k.float().transpose(-1, -2)
    remat = sq > chunk and torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    # A row sees no key (its softmax is NaN, zeroed as in the reference)
    # only where a window ends before the keys do: causal rows see key 0 or
    # themselves, windowless non-causal rows every key.
    empty_rows = window is not None and q_offset + sq - window >= skv
    out = []
    for s0 in range(0, sq, chunk):
        q0 = q_offset + s0
        hi = min(skv, q0 + min(chunk, sq - s0)) if causal else skv
        lo = min(hi, 0 if window is None else max(0, q0 - window + 1))
        args = (q[:, :, s0:s0 + chunk], kt[..., lo:hi], v[:, :, lo:hi], q0,
                lo, causal, window, softcap, empty_rows)
        out.append(checkpoint(_attend, *args, use_reentrant=False) if remat
                   else _attend(*args))
    return torch.cat(out, dim=2) if len(out) > 1 else out[0]


def _attend(qc, kt, v, q0: int, k0: int, causal: bool,
            window: Optional[int], softcap: float,
            empty_rows: bool) -> torch.Tensor:
    """One chunk of ``sdpa_chunked``: queries at positions q0, q0 + 1, ...
    against the transposed float32 keys ``kt`` at positions k0, k0 + 1,
    ..."""
    p = torch.softmax(_scores(qc, kt, q0, k0, causal, window, softcap),
                      dim=-1)
    if empty_rows:
        p = torch.where(torch.isnan(p), 0.0, p)
    return p.to(v.dtype) @ v


def _scores(qc, kt, q0: int, k0: int, causal: bool, window: Optional[int],
            softcap: float) -> torch.Tensor:
    """The float32 scores of queries at positions q0, q0 + 1, ... against
    the transposed keys ``kt`` at positions k0, k0 + 1, ..., scaled,
    soft-capped, and ``-inf`` where the causal or window mask hides a
    key."""
    skv = kt.shape[-1]
    kpos = k0 + torch.arange(skv, device=qc.device)
    qpos = q0 + torch.arange(qc.shape[2], device=qc.device)
    # In place on the fresh [B, H, chunk, Skv] float32 scores: neither the
    # product's nor the scaling's backward reads its output.
    s = (qc.float() @ kt).mul_(qc.shape[3] ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.ones((qc.shape[2], skv), dtype=torch.bool, device=qc.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return s.masked_fill_(~mask, -math.inf)


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

    On a mesh whose cache sequence is split in blocks
    (``sharding_ctx.cache_block``) ``cache`` holds this process's block of
    global rows ``[r0, r0 + S_l)``: the fresh rows, computed on every
    process of a data row, are written only where they fall in the block.
    A prefill on the flash path hands the kernel the fresh K/V at ``idx``
    0 and the filled prefix gathered over the blocks after it; everything
    else splits the keys (``_sdpa_seq_split``).  A ``"cached"`` cross
    cache is such a block too (role ``"cross"``), its keys split the same
    way, not causally, unless it is marked ``whole`` (a prefill's freshly
    computed cross K/V, before the cache keeps its block).
    """
    b, sq, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, sq, h, hd)
    cross_cached = isinstance(kv_x, str) and kv_x == "cached"
    r0, seq_axes = 0, ()
    if cross_cached:
        k, v = cache["k"], cache["v"]
        new_cache = cache
        if not cache.get("whole", False):
            ck, cv = k, v
            r0, seq_axes = sharding_ctx.cache_block(k.shape[2], "cross")
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
        r0, seq_axes = sharding_ctx.cache_block(ck.shape[2])
        if seq_axes:
            k, v = k.to(ck.dtype), v.to(cv.dtype)
            _write_block(ck, cv, k, v, q_offset, r0, seq_axes)
        else:
            ck[:, :, q_offset:q_offset + sq] = k.to(ck.dtype)
            cv[:, :, q_offset:q_offset + sq] = v.to(cv.dtype)
            k, v = ck, cv
        new_cache = {"k": ck, "v": cv, "idx": q_offset + sq}

    flash = cfg.attn_impl == "flash" and sq > 1 and cfg.logit_softcap == 0
    if seq_axes:
        if flash and is_self:
            # The whole prompt's fresh K/V at idx 0; else the filled
            # prefix, gathered over the sequence's axes.
            if q_offset:
                k = _cache_prefix(ck, q_offset + sq, seq_axes)
                v = _cache_prefix(cv, q_offset + sq, seq_axes)
            out = kops.flash_attention(q, k, v, causal=causal, window=window)
        else:
            out = _sdpa_seq_split(q, ck, cv, cfg, q_offset=q_offset, r0=r0,
                                  window=window, axes=seq_axes,
                                  causal=causal and is_self)
        out = out.transpose(1, 2).reshape(b, sq, h * hd)
        return out @ p["wo"], new_cache

    if flash:
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


def _write_block(ck, cv, k, v, q_offset: int, r0: int, axes: tuple):
    """Write the fresh rows ``k``, ``v`` of global positions ``[q_offset,
    q_offset + Sq)`` into the cache block ``ck``, ``cv`` [B, KV, S_l, D]
    that holds global rows ``[r0, r0 + S_l)``: only the rows that fall in
    the block (a process whose block they miss writes nothing)."""
    sl, sq = ck.shape[2], k.shape[2]
    total = sl * math.prod(sharding_ctx.live_mesh().sizes[a] for a in axes)
    if q_offset + sq > total:
        raise ValueError(f"the cache holds {total} rows; writing {sq} at "
                         f"{q_offset} overflows it")
    lo, hi = max(q_offset, r0), min(q_offset + sq, r0 + sl)
    if lo < hi:
        ck[:, :, lo - r0:hi - r0] = k[:, :, lo - q_offset:hi - q_offset]
        cv[:, :, lo - r0:hi - r0] = v[:, :, lo - q_offset:hi - q_offset]


def _cache_prefix(c: torch.Tensor, n: int, axes: tuple) -> torch.Tensor:
    """The first ``n`` global rows [B, KV, n, D] of a cache whose sequence
    is split in blocks over ``axes``, on every process: each block's first
    ``min(S_l, n)`` rows gathered in rank order (the first block's alone
    where ``n`` fits in it), cut to ``n``."""
    x = c[:, :, :min(c.shape[2], n)]
    for a in reversed(axes):
        x = sharding_ctx.all_gather(x, a, dim=2)
    return x[:, :, :n]


def _sdpa_seq_split(q, ck, cv, cfg: ModelConfig, *, q_offset: int, r0: int,
                    window: Optional[int], axes: tuple,
                    causal: bool = True) -> torch.Tensor:
    """``sdpa_chunked`` (causal, or not: a cross cache) against a cache
    whose sequence is split in blocks over ``axes``, rounding where it
    rounds: each process scores its queries against its own block of keys
    (global positions ``r0``, ``r0 + 1``, ...); the row maxima, then the
    sums of the weights, are reduced over ``axes`` first, so each block's
    probabilities are the whole softmax's, rounded to the values' dtype as
    ``_attend`` rounds them; the blocks' products are summed in float32
    over ``axes`` in rank order and rounded once.  A block whose keys no
    row of a chunk sees adds zeros; a row that sees no key anywhere gives
    0 (the one-process path's zeroed NaN).  Every process of the line gets
    the same bits.  Three passes over the chunks (maxima, sums, products)
    each score a chunk again, so one chunk's scores are held at a time.
    Returns [B, H, Sq, D] in the cache's dtype."""
    g = cfg.num_heads // cfg.num_kv_heads
    sq, sl = q.shape[2], ck.shape[2]
    k, v = ck, cv
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    kt = k.float().transpose(-1, -2)
    spans = []      # (first row, rows, the visible keys lo:hi) per chunk
    for s0 in range(0, sq, cfg.attn_chunk):
        n, q0 = min(cfg.attn_chunk, sq - s0), q_offset + s0
        # the block's keys some row of the chunk can see, local positions
        hi = min(sl, q0 + n - r0) if causal else sl
        lo = min(max(hi, 0), 0 if window is None
                 else max(0, q0 - window + 1 - r0))
        spans.append((s0, n, lo, hi))
    held = {}

    def scores(s0, n, lo, hi):
        # a single chunk (a decode step) keeps its scores for the passes
        s = held.get(s0)
        if s is None:
            s = _scores(q[:, :, s0:s0 + n], kt[..., lo:hi], q_offset + s0,
                        r0 + lo, causal, window, cfg.logit_softcap)
            if len(spans) == 1:
                held[s0] = s
        return s

    rows = q.shape[:2]
    m = sharding_ctx.pmax_over(torch.cat([
        q.new_full(rows + (n, 1), -math.inf, dtype=torch.float32)
        if hi <= lo else scores(s0, n, lo, hi).amax(dim=-1, keepdim=True)
        for s0, n, lo, hi in spans], dim=2), axes)
    m = torch.where(m == -math.inf, 0.0, m)

    def weights(s0, n, lo, hi):
        return torch.exp(scores(s0, n, lo, hi) - m[:, :, s0:s0 + n])

    total = sharding_ctx.psum_over(torch.cat([
        q.new_zeros(rows + (n, 1), dtype=torch.float32) if hi <= lo
        else weights(s0, n, lo, hi).sum(dim=-1, keepdim=True)
        for s0, n, lo, hi in spans], dim=2), axes)
    total = torch.where(total > 0, total, 1.0)
    out = [q.new_zeros(rows + (n, v.shape[3]), dtype=torch.float32)
           if hi <= lo else (weights(s0, n, lo, hi)
                             / total[:, :, s0:s0 + n]).to(v.dtype).float()
           @ v[:, :, lo:hi].float() for s0, n, lo, hi in spans]
    return sharding_ctx.psum_over(torch.cat(out, dim=2), axes).to(cv.dtype)


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


def mlp_specs(cfg: ModelConfig) -> dict:
    return {"wi": P(FSDP, TP), "wg": P(FSDP, TP), "wo": P(TP, FSDP)}


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


def embed_specs(cfg: ModelConfig) -> P:
    # vocab over model, d replicated (the reference's).
    return P(TP, None)


def unembed_specs(cfg: ModelConfig) -> P:
    return P(None, TP)


class _Embed(torch.autograd.Function):
    """``table[tokens]`` whose gradient sums in float32 and is cast to the
    table's dtype once (the reference's custom VJP, ``layers.embed``)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        # Deterministic: the rows of each token id, in token order (a stable
        # sort), summed by a segment reduction.  An accumulating scatter
        # (index_put_, index_add_) sums in atomics order on CUDA, and
        # Zipfian ids (a quarter of them one id) serialise its atomics.
        (tokens,) = ctx.saved_tensors
        ids, order = torch.sort(tokens.reshape(-1).long(), stable=True)
        uniq, counts = torch.unique_consecutive(ids, return_counts=True)
        rows = g.reshape(-1, g.shape[-1])[order].float()
        acc = torch.zeros(ctx.table_shape, dtype=torch.float32,
                          device=g.device)
        acc[uniq] = torch.segment_reduce(rows, "sum", lengths=counts, axis=0)
        return acc.to(ctx.table_dtype), None


def _vocab_block(name: str, dim: int, t: torch.Tensor) -> tuple:
    """``(first id, axes)`` of this process's block of the vocabulary of
    the parameter ``name``, whose vocab is dimension ``dim`` of ``t``:
    split there and nowhere else, and no gradient asked for (serving).
    ``(0, ())`` otherwise: the caller gathers the whole parameter."""
    sh = sharding_ctx.param_shardings(name)
    if sh is None or torch.is_grad_enabled() or any(
            e is not None for i, e in enumerate(sh.spec) if i != dim):
        return 0, ()
    return sharding_ctx.block_of(sh, dim, t.shape[dim])


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on a mesh the table is gathered first, but in
    serving (no autograd) a table split by vocabulary is read where it
    lies: each process looks up the ids of its own rows, zeros for the
    rest, and the rows sum over the split's axes in rank order -- one
    nonzero term per token, so the sum is the row, bit for bit."""
    r0, axes = _vocab_block("embed", 0, table)
    if not axes:
        return _Embed.apply(sharding_ctx.gathered(table, "embed"), tokens)
    ids = tokens.long() - r0
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = torch.where(mine[..., None], table[torch.where(mine, ids, 0)],
                       torch.zeros((), dtype=table.dtype, device=table.device))
    for a in axes:
        rows = sharding_ctx.psum(rows, a)
    return rows


def unembed_chunked_xent(head: torch.Tensor, h: torch.Tensor,
                         targets: torch.Tensor, mask: torch.Tensor,
                         chunk: int):
    """Cross-entropy without materialising [B, S, vocab] logits.  Returns
    ``(sum of nll over the masked positions, sum of the mask)``, float32.

    A loop over ``chunk`` positions at a time; each chunk's float32 logits
    give ``logsumexp - gold logit``.  Under autograd each chunk is
    rematerialised in the backward (the reference's checkpointed scan), so
    the backward holds one chunk's [B, chunk, V] logits."""
    s = h.shape[1]
    chunk = min(chunk, s)
    remat = torch.is_grad_enabled() and (h.requires_grad
                                         or head.requires_grad)
    nll = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, s, chunk):
        args = (head, h[:, s0:s0 + chunk], targets[:, s0:s0 + chunk],
                mask[:, s0:s0 + chunk])
        n, c = (checkpoint(_xent_chunk, *args, use_reentrant=False) if remat
                else _xent_chunk(*args))
        nll, cnt = nll + n, cnt + c
    return nll, cnt


def _xent_chunk(head, hc, tc, mc):
    logits = hc.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def unembed_logits(head: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full float32 logits (decode-time: S is tiny).  On a mesh the head
    is gathered first, but in serving a head split by vocabulary gives
    each process the logits of its own columns, gathered over the split's
    axes."""
    _, axes = _vocab_block("lm_head", 1, head)
    if not axes:
        return h.float() @ sharding_ctx.gathered(head, "lm_head").float()
    logits = h.float() @ head.float()
    for a in reversed(axes):
        logits = sharding_ctx.all_gather(logits, a, dim=logits.dim() - 1)
    return logits
