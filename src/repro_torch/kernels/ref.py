"""Plain PyTorch oracles for the semiring kernels (the correctness ground
truth; port of ``repro.kernels.ref``).  Float32 products here run in full
float32: the callers that compare against them turn TF32 off."""
from __future__ import annotations

import torch


def bool_mm_ref(f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Boolean-semiring matmul on {0,1} f32 masks: out = (f @ a) > 0."""
    return (f.float() @ a.float() > 0).float()


def minplus_mm_ref(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Tropical matmul: out[s, j] = min_k d[s, k] + w[k, j]."""
    return torch.amin(d[:, :, None] + w[None, :, :], dim=1)


def count_mm_ref(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Counting matmul (Brandes sigma): plain f32 product of path counts."""
    return s.float() @ a.float()
