"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) ff=21504 vocab=262144,
5 local(window 1024) : 1 global, 128k ctx. [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    window=1024, local_global=5, rope_theta=1e6,
)
