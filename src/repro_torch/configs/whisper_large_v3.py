"""whisper-large-v3 [audio]: enc-dec 32L+32L d=1280 20H (MHA) ff=5120
vocab=51866, conv frontend STUB (input_specs supplies frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=52224,  # 51866 padded to 256x so vocab shards over TP=16
    encoder_layers=32, encoder_seq=1500,
)
