"""Config -> model dispatch (port of ``repro.models.registry``):

    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(batch, max_len)
    logits, cache = model.prefill(params, tokens, cache)
    logits, cache = model.decode_step(params, tokens, cache)

The decoder-only families (dense, moe, vlm) are ported; ssm, hybrid and
encdec raise until their model code is (ROADMAP.md, queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import transformer
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable           # (generator) -> params on its device
    prefill: Callable        # (params, tokens, cache, **kw) -> (logits, cache)
    decode_step: Callable    # (params, tokens, cache, **kw) -> (logits, cache)
    init_cache: Callable     # (batch, max_len, dtype=, device=) -> cache


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("ssm", "hybrid", "encdec", "audio"):
        raise NotImplementedError(
            f"repro_torch: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md, queue 1, item 10)")
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {cfg.family}")
    mod = transformer
    return Model(
        cfg=cfg,
        init=lambda gen: mod.init(gen, cfg),
        prefill=lambda params, tokens, cache, **kw: mod.prefill(
            params, tokens, cfg, cache, **kw),
        decode_step=lambda params, tokens, cache, **kw: mod.decode_step(
            params, tokens, cfg, cache, **kw),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device="cuda":
            mod.init_cache(cfg, batch, max_len, dtype, device),
    )
