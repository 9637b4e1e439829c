"""The decoder-only LM (dense / MoE / VLM) on one layer library, forward
and serving (port of ``repro.models``)."""
from .config import ModelConfig  # noqa: F401
from .registry import Model, get_model  # noqa: F401
