"""Decoder-only transformer LM, forward and serving (port of
``repro.models.transformer``: dense / MoE / VLM backbones).

Layers are a Python list run by a Python loop; per-layer windows are
Python ints (or None), so a prefill reaches the flash kernel on every
layer.  The KV cache is one tensor per K and V, stacked over layers as in
the reference, and is written in place.  ``loss_fn`` waits for training
(ROADMAP.md, queue 1, item 3).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.graph_state import resolve_device

from . import layers as L
from .config import ModelConfig
from .moe import init_moe, moe


def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    attn_p = L.init_attention(gen, cfg)
    ffn_p = init_moe(gen, cfg) if cfg.num_experts else L.init_mlp(gen, cfg)
    return {"attn": attn_p, "ffn": ffn_p,
            "ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
            "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device)}


def layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Per-layer window sizes of the local:global pattern; None on a global
    layer (the reference's ``BIG_WINDOW``, a window longer than any
    sequence)."""
    if cfg.local_global and cfg.window:
        return [None if i % (cfg.local_global + 1) == cfg.local_global
                else cfg.window for i in range(cfg.num_layers)]
    return [cfg.window or None] * cfg.num_layers


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, at the reference's scales."""
    return {"embed": L.init_embed(gen, cfg),
            "layers": [_init_layer(gen, cfg) for _ in range(cfg.num_layers)],
            "final_norm": L.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
            "lm_head": L.init_unembed(gen, cfg)}


def _layer_apply(lp, h, cfg, window, cache, positions):
    """One block; the attention writes its K/V rows into ``cache`` in place."""
    a, _ = L.attention(lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                       cfg, positions=positions, cache=cache, window=window)
    h = h + a
    hn = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    f = moe(lp["ffn"], hn, cfg) if cfg.num_experts else L.mlp(lp["ffn"], hn)
    return h + f


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None):
    """Returns ``(hidden [B,S,d], caches)``: with ``caches``, each layer's
    K/V rows are written into them in place and their ``idx`` advances by
    S; without, ``None``."""
    h = L.embed(params["embed"], tokens)
    windows = layer_windows(cfg)
    for i, (lp, win) in enumerate(zip(params["layers"], windows)):
        cache = None if caches is None else {
            "k": caches["k"][i], "v": caches["v"][i], "idx": caches["idx"]}
        h = _layer_apply(lp, h, cfg, win, cache, positions)
    if caches is not None:
        caches = {**caches, "idx": caches["idx"] + h.shape[1]}
    return L.rms_norm(h, params["final_norm"], cfg.norm_eps), caches


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Empty KV cache: k, v [L, B, KV, max_len, D] and the fill ``idx``
    (one int for every layer: the layers advance together)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "idx": 0}


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            cache: dict, positions: Optional[torch.Tensor] = None):
    """Run the prompt through the model, filling the cache.
    Returns (last-token logits [B, 1, V] in float32, cache)."""
    h, cache = forward(params, tokens, cfg, caches=cache,
                       positions=positions)
    return L.unembed_logits(params["lm_head"], h[:, -1:, :]), cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: dict, positions: Optional[torch.Tensor] = None):
    """One incremental token: tokens [B, 1] -> (logits [B,1,V], cache)."""
    return prefill(params, tokens, cfg, cache, positions=positions)
