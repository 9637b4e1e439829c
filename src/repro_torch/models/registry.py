"""Config -> model dispatch (port of ``repro.models.registry``):

    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    loss = model.loss_fn(params, batch)      # batch = {"tokens": [B, S], ...}
    cache = model.init_cache(batch, max_len)
    logits, cache = model.prefill(params, tokens, cache)
    logits, cache = model.decode_step(params, tokens, cache)

For the encoder-decoder family ``prefill`` also takes ``frames=`` [B,
encoder_seq, d_model], the stubbed audio frontend's output.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode

from . import encdec, hybrid, ssm, transformer
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable           # (generator) -> params on its device
    loss_fn: Callable        # (params, batch) -> scalar float32 loss
    prefill: Callable        # (params, tokens, cache, **kw) -> (logits, cache)
    decode_step: Callable    # (params, tokens, cache, **kw) -> (logits, cache)
    init_cache: Callable     # (batch, max_len, dtype=, device=) -> cache
    specs: Callable          # () -> parameter spec tree (per-layer lists)
    cache_specs: Callable    # () -> cache spec tree
    cache_roles: Callable    # (cache shardings) -> {role: a layer's sharding}


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        mod = transformer
    elif cfg.family == "ssm":
        mod = ssm
    elif cfg.family == "hybrid":
        mod = hybrid
    elif cfg.family in ("encdec", "audio"):
        mod = encdec
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return Model(
        cfg=cfg,
        init=lambda gen: mod.init(gen, cfg),
        loss_fn=lambda params, batch: mod.loss_fn(params, batch, cfg),
        prefill=lambda params, tokens, cache, **kw: mod.prefill(
            params, tokens, cfg, cache, **kw),
        decode_step=lambda params, tokens, cache, **kw: mod.decode_step(
            params, tokens, cfg, cache, **kw),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device="cuda":
            mod.init_cache(cfg, batch, max_len, dtype, device),
        specs=lambda: mod.specs(cfg),
        cache_specs=lambda: mod.cache_specs(cfg),
        cache_roles=mod.cache_roles,
    )


class _OnMeta(TorchFunctionMode):
    """Every factory call with a ``device=`` builds on ``meta`` instead."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def param_shapes(model: Model) -> dict:
    """The parameter tree ``model.init`` builds, as ``meta`` tensors (shapes
    and dtypes, no storage): the reference's ``jax.eval_shape(model.init,
    key)``, e.g. the ``tree_like`` of a checkpoint restore."""
    with _OnMeta():
        return model.init(torch.Generator())
