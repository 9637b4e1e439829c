"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit: a CUDA kernel has no
CPU mode, so they skip elsewhere.  The file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core.semiring as tsem
import repro_torch.kernels.count_mm as tcount
import repro_torch.kernels.ops as tops

SHAPES = [(128, 128, 128), (70, 200, 130), (1, 512, 64), (256, 64, 256)]


def _tile_occ(a, tile):
    k, n = a.shape
    nt_r, nt_c = -(-k // tile), -(-n // tile)
    pad = np.zeros((nt_r * tile, nt_c * tile), np.float32)
    pad[:k, :n] = a
    return (pad.reshape(nt_r, tile, nt_c, tile) != 0).any(axis=(1, 3)).astype(
        np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,k,n", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, s, k, n):
    rng = np.random.default_rng(s + k + n)
    f = (rng.random((s, k)) * 4).astype(np.int32).astype(np.float32)
    a = (rng.random((k, n)) < 0.1).astype(np.float32)
    fc = torch.tensor(f, device=cuda_device)
    ac = torch.tensor(a, device=cuda_device)
    before = dict(tcount.LAUNCHES)
    got = tops.count_mm(fc, ac)
    amask = torch.tensor(_tile_occ(a, 64), device=cuda_device)
    got_m = tops.count_mm(fc, ac, amask=amask, tile=64)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy(), f @ a)
    assert np.array_equal(got_m.cpu().numpy(), f @ a)
    assert tcount.LAUNCHES["count_mm"] == before["count_mm"] + 1
    assert tcount.LAUNCHES["count_mm_masked"] == before["count_mm_masked"] + 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsem.bool_mm(fc, ac)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsem.minplus_mm(fc, ac)
