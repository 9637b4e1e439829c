"""The architectures the port serves (port of ``repro.configs``).

``get_config(name)`` returns the full published config; ``reduced(cfg)``
shrinks it for CPU tests (same family and topology, tiny dims).  The port
keeps its own copies of the config files: it imports nothing of the
reference package.  Every architecture of ``ARCHS`` is ported.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCHS = [
    "mamba2_780m",
    "qwen3_32b",
    "codeqwen15_7b",
    "gemma3_27b",
    "mistral_nemo_12b",
    "llama4_maverick_400b",
    "granite_moe_1b",
    "qwen2_vl_72b",
    "whisper_large_v3",
    "zamba2_12b",
]

# The architectures with a config file (and a model) in the port: all.
PORTED = tuple(ARCHS)

# shape grid assigned to the LM family (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: SSM / hybrid only.
LONG_OK_FAMILIES = ("ssm", "hybrid")


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "")
    if name not in PORTED:
        raise ValueError(f"repro_torch has no config {name!r}: the port "
                         f"serves {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def shapes_for(cfg: ModelConfig):
    """The live (shape) cells for an architecture (skips documented)."""
    out = {}
    for shape, (s, b, kind) in SHAPES.items():
        if shape == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
            continue
        out[shape] = (s, b, kind)
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family miniature for CPU tests (``repro.configs.reduced``)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=256,
        xent_chunk=32,
        attn_chunk=32,
        remat=False,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.attn_every:
        kw.update(attn_every=2, num_layers=5)   # 2 super-blocks + tail of 1
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=24)
    if cfg.window:
        kw.update(window=16)
    kw.update(dtype=torch.float32)
    return dataclasses.replace(cfg, **kw)
