"""zamba2-1.2b [hybrid]: 38L Mamba2 (d=2048, state=64) + weight-shared
attention block (32H, kv=32) every 6 layers, shared-MLP ff=8192, vocab=32000.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
    attn_every=6,
)
