"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) expert ff=512
vocab=49155, 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49408,  # 49155 padded to 256x so vocab shards over TP=16
    num_experts=32, top_k=8, capacity_factor=1.25,
)
