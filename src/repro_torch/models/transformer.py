"""Decoder-only transformer LM, forward and serving (port of
``repro.models.transformer``: dense / MoE / VLM backbones).

Layers are a Python list run by a Python loop; per-layer windows are
Python ints (or None), so a prefill reaches the flash kernel on every
layer.  The KV cache is one tensor per K and V, stacked over layers as in
the reference, and is written in place.  ``loss_fn`` is the reference's:
the next-token cross-entropy plus 0.01 x the MoE load-balance loss;
without a cache, ``forward`` rematerialises each layer in the backward
when ``cfg.remat``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.graph_state import resolve_device

from . import layers as L
from . import sharding_ctx
from .config import ModelConfig
from .moe import init_moe, moe, moe_specs
from .sharding_ctx import P, stacked


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


def _layer_specs(cfg: ModelConfig) -> dict:
    return {"attn": L.attention_specs(cfg),
            "ffn": moe_specs(cfg) if cfg.num_experts else L.mlp_specs(cfg),
            "ln1": P(None), "ln2": P(None)}


def specs(cfg: ModelConfig) -> dict:
    """The reference's parameter specs, one layer's per entry of
    ``layers`` (its stacked specs without the leading ``None``)."""
    return {"embed": L.embed_specs(cfg),
            "layers": [_layer_specs(cfg)] * cfg.num_layers,
            "final_norm": P(None), "lm_head": L.unembed_specs(cfg)}


def cache_specs(cfg: ModelConfig) -> dict:
    """Batch over data, sequence over model (the reference's)."""
    return {"k": L.kv_cache_spec(), "v": L.kv_cache_spec(),
            "idx": stacked(P())}


def cache_roles(shardings: dict) -> dict:
    """The cache's shardings by the role attention reads them under
    (``sharding_context(cache=)``): the K/V (``"kv"``)."""
    return {"kv": shardings["k"]}


def _layer_apply(lp, h, cfg, window, cache, positions, path=None):
    """One block; the attention writes its K/V rows into ``cache`` in
    place.  Returns (h, the MoE load-balance loss, or 0.0 for a dense
    model or with a cache: serving never reads it).  ``path``: the layer's
    place in the parameter tree, which the MoE's dense dispatch gathers
    its expert blocks by on a mesh."""
    a, _ = L.attention(lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                       cfg, positions=positions, cache=cache, window=window)
    h = h + a
    hn = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        f, aux = moe(lp["ffn"], hn, cfg, with_aux=cache is None,
                     path=None if path is None else path + ("ffn",))
    else:
        f, aux = L.mlp(lp["ffn"], hn), None
    return h + f, 0.0 if aux is None else aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None):
    """Returns ``(hidden [B,S,d], caches, aux)``: with ``caches``, each
    layer's K/V rows are written into them in place and their ``idx``
    advances by S; without, ``None``.  ``aux`` sums the layers' MoE
    load-balance losses (0.0 for a dense model, and with ``caches``).  On
    a mesh ``caches`` is this process's block (batch over data, sequence
    over model), ``idx`` the global fill, and each layer's parameters are
    gathered where it runs."""
    h = L.embed(params["embed"], tokens)
    windows = layer_windows(cfg)
    aux = 0.0
    for i, (lp, win) in enumerate(zip(params["layers"], windows)):
        if caches is None:
            # On a mesh the MoE reads its expert blocks as they are.
            h, a = L.remat(cfg, _layer_apply, lp, h, cfg, win, None,
                           positions, ("layers", i), path=("layers", i),
                           keep=("ffn",) if cfg.num_experts else ())
        else:
            cache = {"k": caches["k"][i], "v": caches["v"][i],
                     "idx": caches["idx"]}
            # On a mesh: the layer's blocks gathered, the experts' kept.
            lp = sharding_ctx.gathered(
                lp, "layers", i, keep=("ffn",) if cfg.num_experts else ())
            h, a = _layer_apply(lp, h, cfg, win, cache, positions,
                                ("layers", i))
        aux = aux + a
    if caches is not None:
        caches = {**caches, "idx": caches["idx"] + h.shape[1]}
    return L.rms_norm(h, params["final_norm"], cfg.norm_eps), caches, aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S] (M-RoPE
    ``positions`` [3, B, S-1] optional) plus 0.01 x the load-balance loss."""
    tokens = batch["tokens"]
    h, _, aux = forward(params, tokens[:, :-1], cfg,
                        positions=batch.get("positions"))
    return L.next_token_loss(params["lm_head"], h, tokens, cfg) \
        + 0.01 * sharding_ctx.replicated_share(aux)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Empty KV cache: k, v [L, B, KV, max_len, D] and the fill ``idx``
    (one int for every layer: the layers advance together).  A process of
    a mesh holds its block of it (``launch.steps.local_cache``)."""
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
    h, cache, _ = forward(params, tokens, cfg, caches=cache,
                          positions=positions)
    return L.unembed_logits(params["lm_head"], h[:, -1:, :]), cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: dict, positions: Optional[torch.Tensor] = None):
    """One incremental token: tokens [B, 1] -> (logits [B,1,V], cache)."""
    return prefill(params, tokens, cfg, cache, positions=positions)
