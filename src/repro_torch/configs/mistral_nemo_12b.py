"""mistral-nemo-12b [dense]: 40L d=5120 32H (GQA kv=8) ff=14336 vocab=131072,
128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1e6,
)
