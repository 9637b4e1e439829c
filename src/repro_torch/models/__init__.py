"""The LMs -- decoder-only (dense / MoE / VLM), Mamba2 SSM, Zamba2 hybrid
and Whisper encoder-decoder -- on one layer library: serving and training
(port of ``repro.models``)."""
from .config import ModelConfig  # noqa: F401
from .registry import Model, get_model, param_shapes  # noqa: F401
