"""mamba2-780m [ssm]: 48L d_model=1536, attn-free, SSD state=128.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
    vocab_size=50432,  # 50280 padded to 256x (Megatron-style) so vocab shards over TP=16
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True,
)
