"""Whisper-style encoder-decoder backbone, forward and serving (port of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: frames come in as
precomputed embeddings [B, encoder_seq, d_model] (what the two conv layers
would emit).  The transformer backbone is complete: a bidirectional
encoder, a causal decoder with cross-attention, KV caches for both.  The
reference's deviations are kept: RMSNorm, and RoPE (on the encoder's
self-attention and the decoder's) instead of Whisper's learned absolute
embeddings.

With ``attn_impl="flash"`` every prefill attention goes through the flash
kernel: the encoder's self-attention and the decoder's cross-attention non
causally (the whole encoder K/V), the decoder's self-attention causally on
the filled cache prefix.  Caches are written in place, apart from the cross
cache, which ``prefill`` rebuilds from the frames it is given.  On a mesh
of processes both caches are this process's blocks (their sequence over
``model``) and each layer's parameters are gathered where it runs: a
prefill with frames attends to the whole cross K/V it has just computed
and keeps its block; a decode step, or a prefill without frames, merges
the blocks' partial softmaxes (``layers.attention``).  ``loss_fn``
is the reference's next-token cross-entropy of the decoder over
``batch["frames"]``; the encoder's layers, and the decoder's without a
cache, are rematerialised in the backward when ``cfg.remat``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.graph_state import resolve_device

from . import layers as L
from .config import ModelConfig
from .sharding_ctx import P, gathered, own_block, stacked


def _norms(cfg: ModelConfig, dev, names) -> dict:
    return {n: L.init_rmsnorm(cfg.d_model, cfg.dtype, dev) for n in names}


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"attn": L.init_attention(gen, cfg), "mlp": L.init_mlp(gen, cfg),
            **_norms(cfg, gen.device, ("ln1", "ln2"))}


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"self": L.init_attention(gen, cfg),
            "cross": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg),
            **_norms(cfg, gen.device, ("ln1", "ln2", "ln3"))}


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, at the reference's scales."""
    return {"embed": L.init_embed(gen, cfg),
            "encoder": [_enc_layer_init(gen, cfg)
                        for _ in range(cfg.encoder_layers)],
            "decoder": [_dec_layer_init(gen, cfg)
                        for _ in range(cfg.num_layers)],
            **_norms(cfg, gen.device, ("enc_norm", "final_norm")),
            "lm_head": L.init_unembed(gen, cfg)}


def specs(cfg: ModelConfig) -> dict:
    a, m = L.attention_specs(cfg), L.mlp_specs(cfg)
    enc_one = {"attn": a, "mlp": m, "ln1": P(None), "ln2": P(None)}
    dec_one = {"self": a, "cross": a, "mlp": m,
               "ln1": P(None), "ln2": P(None), "ln3": P(None)}
    return {"embed": L.embed_specs(cfg),
            "encoder": [enc_one] * cfg.encoder_layers,
            "decoder": [dec_one] * cfg.num_layers, "enc_norm": P(None),
            "final_norm": P(None), "lm_head": L.unembed_specs(cfg)}


def cache_specs(cfg: ModelConfig) -> dict:
    kv = L.kv_cache_spec()
    return {"self": {"k": kv, "v": kv, "idx": stacked(P())},
            "cross": {"k": kv, "v": kv}}


def cache_roles(shardings: dict) -> dict:
    """The decoder's self-attention K/V (``"kv"``) and its cross K/V."""
    return {"kv": shardings["self"]["k"], "cross": shardings["cross"]["k"]}


def encode(params: dict, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: [B, encoder_seq, d] (the stubbed frontend's output)."""
    h = frames.to(cfg.dtype)
    for i, lp in enumerate(params["encoder"]):
        h = L.remat(cfg, _enc_layer, lp, h, cfg, path=("encoder", i))
    return L.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _enc_layer(lp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    a, _ = L.attention(lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                       cfg, causal=False, use_rope=True)
    h = h + a
    return h + L.mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], cfg.norm_eps))


def _dec_layer(lp: dict, h: torch.Tensor, cfg: ModelConfig, sc, cc,
               kv_x) -> torch.Tensor:
    """One decoder layer: self-attention (through ``sc``), cross-attention
    over ``kv_x`` (``"cached"``: ``cc``), MLP."""
    a, _ = L.attention(lp["self"], L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                       cfg, cache=sc)
    h = h + a
    c, _ = L.attention(lp["cross"], L.rms_norm(h, lp["ln2"], cfg.norm_eps),
                       cfg, kv_x=kv_x, cache=cc, causal=False, use_rope=False)
    h = h + c
    return h + L.mlp(lp["mlp"], L.rms_norm(h, lp["ln3"], cfg.norm_eps))


def decode(params: dict, tokens: torch.Tensor,
           enc_out: Optional[torch.Tensor], cfg: ModelConfig,
           caches: Optional[dict] = None, cross: Optional[dict] = None):
    """caches: None (cross-attention over ``enc_out``) or dict(self={k, v}
    [L, ...] and idx, cross={k, v} [L, ...]); ``cross``: the whole cross
    K/V to attend to instead of the cache's (a prefill's, on a mesh where
    the cache keeps a block of it).  Returns ``(hidden [B,S,d], caches)``;
    with caches, the self-attention's K/V rows are written into them in
    place and ``idx`` advances by S."""
    h = L.embed(params["embed"], tokens)
    src = caches["cross"] if cross is None and caches is not None else cross
    for i, lp in enumerate(params["decoder"]):
        if caches is None:
            h = L.remat(cfg, _dec_layer, lp, h, cfg, None, None, enc_out,
                        path=("decoder", i))
            continue
        sc = {"k": caches["self"]["k"][i], "v": caches["self"]["v"][i],
              "idx": caches["self"]["idx"]}
        cc = {"k": src["k"][i], "v": src["v"][i], "whole": cross is not None}
        h = _dec_layer(gathered(lp, "decoder", i), h, cfg, sc, cc, "cached")
    if caches is not None:
        sc = caches["self"]
        caches = {**caches, "self": {**sc, "idx": sc["idx"] + h.shape[1]}}
    return L.rms_norm(h, params["final_norm"], cfg.norm_eps), caches


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S] decoded over
    the encoder's output for ``batch["frames"]`` [B, encoder_seq, d]."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frames"], cfg)
    h, _ = decode(params, tokens[:, :-1], enc_out, cfg)
    return L.next_token_loss(params["lm_head"], h, tokens, cfg)


def build_cross_cache(params: dict, enc_out: torch.Tensor,
                      cfg: ModelConfig) -> dict:
    """Every decoder layer's cross-attention K/V, stacked: [L, B, KV, Se,
    D] each (on a mesh, from the gathered projections)."""
    kvs = [L.init_cross_kv(gathered(lp["cross"], "decoder", i, "cross",
                                    keep=("wq", "wo")), cfg, enc_out)
           for i, lp in enumerate(params["decoder"])]
    return {"k": torch.stack([kv["k"] for kv in kvs]),
            "v": torch.stack([kv["v"] for kv in kvs])}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero caches: self-attention K/V [L, B, KV, max_len, D] with the fill
    ``idx``, and cross-attention K/V [L, B, KV, encoder_seq, D]."""
    dev = resolve_device(device)
    kv, hd, nl = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers

    def zeros(n):
        return torch.zeros((nl, batch_size, kv, n, hd), dtype=dtype,
                           device=dev)
    return {"self": {"k": zeros(max_len), "v": zeros(max_len), "idx": 0},
            "cross": {"k": zeros(cfg.encoder_seq),
                      "v": zeros(cfg.encoder_seq)}}


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            cache: dict, frames: Optional[torch.Tensor] = None,
            positions=None):
    """Prompt pass.  With ``frames`` the cross cache is rebuilt from the
    encoder's output (on a mesh, this process's block of it); without,
    the given cross cache is used as it is.
    Returns (last-token logits [B, 1, V] in float32, cache)."""
    cross = None
    if frames is not None:
        cross = build_cross_cache(params, encode(params, frames, cfg), cfg)
        cache = {**cache, "cross": {k: own_block(t, "cross").contiguous()
                                    for k, t in cross.items()}}
    h, cache = decode(params, tokens, None, cfg, caches=cache, cross=cross)
    return L.unembed_logits(params["lm_head"], h[:, -1:, :]), cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: dict, positions=None):
    """One incremental token: tokens [B, 1] -> (logits [B,1,V], cache)."""
    h, cache = decode(params, tokens, None, cfg, caches=cache)
    return L.unembed_logits(params["lm_head"], h[:, -1:, :]), cache
