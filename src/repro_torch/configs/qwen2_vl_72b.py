"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) ff=29568 vocab=152064,
M-RoPE (t/h/w sections 16/24/24), vision frontend stubbed.
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
)
