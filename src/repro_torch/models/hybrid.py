"""Zamba2-style hybrid: a Mamba2 backbone and one weight-SHARED attention
block, forward and serving (port of ``repro.models.hybrid``).

The layer stack is organised as super-blocks of ``attn_every`` Mamba2
layers, each followed by one invocation of a single shared transformer
block (the same weights at every invocation point, as in Zamba2).  The
remaining ``L % attn_every`` Mamba2 layers run after them.  The reference's
simplification is kept: the shared block attends over the hidden stream
only (Zamba2 concatenates the original embedding and uses 2x-width
attention and LoRA adapters per invocation).

Each invocation keeps its own KV cache (``attn.k/v [ns, B, KV, max_len,
D]``) and one ``idx`` for all of them: the invocations advance together, as
the transformer's layers do.  Caches are written in place.  On a mesh of
processes the caches are this process's blocks (the K/V's sequence and
the SSM state's channels and heads over ``model``), and each layer's
parameters, and the shared block's once a pass, are gathered where they
run.  ``loss_fn`` is
the reference's next-token cross-entropy; without a cache, ``forward``
rematerialises each super-block (its Mamba2 layers and the shared block's
invocation) in the backward when ``cfg.remat``, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.graph_state import resolve_device

from . import layers as L
from . import ssm as S
from .config import ModelConfig
from .sharding_ctx import P, gathered, stacked


def _n_super(cfg: ModelConfig):
    return cfg.num_layers // cfg.attn_every, cfg.num_layers % cfg.attn_every


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device: ``blocks`` [ns][attn_every]
    Mamba2 layers, ``tail`` [rem] (when rem > 0), ``shared``."""
    ns, rem = _n_super(cfg)
    dev = gen.device
    params = {
        "embed": L.init_embed(gen, cfg),
        "lm_head": L.init_unembed(gen, cfg),
        "blocks": [[S.init_layer(gen, cfg) for _ in range(cfg.attn_every)]
                   for _ in range(ns)],
        "shared": {"attn": L.init_attention(gen, cfg),
                   "mlp": L.init_mlp(gen, cfg),
                   "ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev),
                   "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev)},
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev),
    }
    if rem:
        params["tail"] = [S.init_layer(gen, cfg) for _ in range(rem)]
    return params


def specs(cfg: ModelConfig) -> dict:
    ns, rem = _n_super(cfg)
    one = S.layer_specs(cfg)
    out = {"embed": L.embed_specs(cfg), "lm_head": L.unembed_specs(cfg),
           "blocks": [[one] * cfg.attn_every] * ns,
           "shared": {"attn": L.attention_specs(cfg),
                      "mlp": L.mlp_specs(cfg),
                      "ln1": P(None), "ln2": P(None)},
           "final_norm": P(None)}
    if rem:
        out["tail"] = [one] * rem
    return out


def cache_specs(cfg: ModelConfig) -> dict:
    ns, rem = _n_super(cfg)
    return {"ssm": S.ssm_cache_specs(cfg, lead=2),
            "attn": {"k": L.kv_cache_spec(), "v": L.kv_cache_spec(),
                     "idx": stacked(P())},
            "tail": S.ssm_cache_specs(cfg) if rem else None}


def cache_roles(shardings: dict) -> dict:
    """The shared block's K/V (``"kv"``) and one Mamba2 layer's state (the
    tail's is laid out alike)."""
    return {"kv": shardings["attn"]["k"],
            **S.cache_roles(shardings["ssm"], lead=2)}


def _shared_block(sp: dict, h: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[dict], positions) -> torch.Tensor:
    a, _ = L.attention(sp["attn"], L.rms_norm(h, sp["ln1"], cfg.norm_eps),
                       cfg, positions=positions, cache=cache)
    h = h + a
    return h + L.mlp(sp["mlp"], L.rms_norm(h, sp["ln2"], cfg.norm_eps))


def _super_block(block: list, sp: dict, h: torch.Tensor, cfg: ModelConfig,
                 positions, j: int) -> torch.Tensor:
    """Super-block ``j`` without caches: its Mamba2 layers, then the shared
    block (on a mesh, each gathered here, inside the remat region)."""
    block, sp = gathered(block, "blocks", j), gathered(sp, "shared")
    for lp in block:
        h = S.residual_block(lp, h, cfg)
    return _shared_block(sp, h, cfg, None, positions)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None):
    """caches: None or dict(ssm={conv, ssd} [ns, ae, ...], attn={k, v}
    [ns, ...] and idx, tail={conv, ssd} [rem, ...] or None).  Returns
    ``(hidden [B,S,d], caches)``; with caches, every state and K/V row is
    written into them in place and ``idx`` advances by S."""
    h = L.embed(params["embed"], tokens)
    sp = params["shared"]
    if caches is not None:
        ssm_c, tail_c = caches["ssm"], caches["tail"]
        sp = gathered(sp, "shared")
    for j, block in enumerate(params["blocks"]):
        if caches is None:
            h = L.remat(cfg, _super_block, block, sp, h, cfg, positions, j)
            continue
        for i, lp in enumerate(block):
            h = S.residual_block(gathered(lp, "blocks", j, i), h, cfg,
                                 S.layer_cache(ssm_c, j, i))
        attn_c = {"k": caches["attn"]["k"][j], "v": caches["attn"]["v"][j],
                  "idx": caches["attn"]["idx"]}
        h = _shared_block(sp, h, cfg, attn_c, positions)
    for i, lp in enumerate(params.get("tail", ())):
        lp = gathered(lp, "tail", i)
        h = S.residual_block(lp, h, cfg, None if caches is None
                             else S.layer_cache(tail_c, i))
    if caches is not None:
        attn = caches["attn"]
        caches = {**caches, "attn": {**attn,
                                     "idx": attn["idx"] + h.shape[1]}}
    return L.rms_norm(h, params["final_norm"], cfg.norm_eps), caches


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S]."""
    tokens = batch["tokens"]
    h, _ = forward(params, tokens[:, :-1], cfg)
    return L.next_token_loss(params["lm_head"], h, tokens, cfg)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero caches: SSM state per Mamba2 layer, K/V per invocation of the
    shared block, and the fill ``idx``."""
    ns, rem = _n_super(cfg)
    dev = resolve_device(device)
    shape = (ns, batch_size, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {
        "ssm": S.init_ssm_cache(cfg, batch_size, dtype, dev,
                                lead=(ns, cfg.attn_every)),
        "attn": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev),
                 "idx": 0},
        "tail": S.init_ssm_cache(cfg, batch_size, dtype, dev, lead=(rem,))
        if rem else None,
    }


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            cache: dict, positions: Optional[torch.Tensor] = None):
    """Run the prompt through the model, filling the caches.
    Returns (last-token logits [B, 1, V] in float32, cache)."""
    h, cache = forward(params, tokens, cfg, caches=cache,
                       positions=positions)
    return L.unembed_logits(params["lm_head"], h[:, -1:, :]), cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: dict, positions: Optional[torch.Tensor] = None):
    """One incremental token: tokens [B, 1] -> (logits [B,1,V], cache)."""
    return prefill(params, tokens, cfg, cache, positions=positions)
