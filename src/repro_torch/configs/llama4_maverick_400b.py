"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) expert ff=8192
vocab=202048, 128 experts top-1. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

moment_dtype=float8_e5m2: at this scale (~600B params as configured: all 48
layers MoE x 128 experts x ff 8192) even bf16 AdamW moments do not fit
beside the parameters and gradients; 1-byte moments (per-leaf f32 math,
cast on store) are the reference's deliberate trade."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=128, top_k=1, capacity_factor=1.25,
    rope_theta=5e5, moment_dtype=torch.float8_e5m2,
)
