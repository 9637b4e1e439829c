"""Tropical (min, +) product (SSSP relaxation): Hopper kernel + plain version.

Port of ``repro.kernels.minplus_mm``.  ``minplus_mm`` and
``minplus_mm_masked`` are the raw entry points: operands must already be
multiples of the CUDA kernel's block shape (``BM x BK`` times ``BK x BN``;
the ``ops`` wrapper pads with +inf, the identity).  A CUDA tensor launches
the hand-written kernel in ``csrc/minplus_mm.cu`` (built with nvcc at first
use, bound with ctypes); a CPU tensor runs the plain PyTorch version beside
it.  There is no fallback from one to the other.  Every candidate
``d + w`` is one rounded f32 add and ``min`` is exact, so the kernel
equals its plain version bit for bit.

The plain versions work k-step by k-step (the reference oracle
``ref.minplus_mm_ref`` broadcasts the whole ``S x K x N`` sum, which no
card holds at the main path's shapes).

``LAUNCHES`` counts kernel launches per entry point; only a launch adds
to it.
"""
from __future__ import annotations

import math

import torch

from . import build
from .backend import check_masks, check_operands, launch, masked_plain, \
    on_cuda

# The CUDA kernel's block shape (csrc/minplus_mm.cu; checked against the
# library's own minplus_mm_block_shape when it loads).
BM, BN, BK = 128, 128, 16

LAUNCHES = {"minplus_mm": 0, "minplus_mm_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    return build.bind("minplus_mm", (BM, BN, BK))


def _relax(out: torch.Tensor, dk: torch.Tensor,
           wk: torch.Tensor) -> torch.Tensor:
    """``min(out, min_k dk + wk)`` over one k-step."""
    return torch.minimum(out, torch.amin(dk[:, :, None] + wk[None, :, :],
                                         dim=1))


def minplus_mm_plain(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dense kernel's function in plain PyTorch, one k-step of ``BK``
    at a time (an ``S x BK x N`` temporary, not ``S x K x N``)."""
    out = torch.full((d.shape[0], w.shape[1]), math.inf, dtype=torch.float32,
                     device=d.device)
    for k0 in range(0, d.shape[1], BK):
        out = _relax(out, d[:, k0:k0 + BK], w[k0:k0 + BK])
    return out


def minplus_mm_masked_plain(d: torch.Tensor, w: torch.Tensor,
                            dmask: torch.Tensor,
                            wmask: torch.Tensor) -> torch.Tensor:
    """The masked kernel's function in plain PyTorch: every output tile
    starts at +inf and relaxes over exactly the k-steps whose
    ``dmask & wmask`` holds, block for block."""
    return masked_plain(d, w, dmask, wmask, (BM, BN, BK), math.inf, _relax)


# ------------------------------ entry points -------------------------------

def minplus_mm(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d: [S, V] f32 (+inf = unreached); w: [V, V'] f32 (+inf = no edge)
    -> [S, V'] f32, ``out[s, j] = min_k d[s, k] + w[k, j]``.

    Shapes must be multiples of (BM, BK) x (BK, BN)."""
    m, kdim, n = check_operands("minplus_mm", d, w, BM, BK, BN)
    if not on_cuda(d, w):
        return minplus_mm_plain(d, w)
    d, w = d.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=d.device)
    launch("minplus_mm", _lib().minplus_mm, d.data_ptr(), w.data_ptr(),
           out.data_ptr(), m, kdim, n)
    LAUNCHES["minplus_mm"] += 1
    return out


def minplus_mm_masked(d: torch.Tensor, w: torch.Tensor, dmask: torch.Tensor,
                      wmask: torch.Tensor) -> torch.Tensor:
    """Tile-skipping min-plus product.

    ``dmask``: int32 [S/BM, K/BK] -- nonzero iff the d slab has a finite
    entry; ``wmask``: int32 [K/BK, N/BN] -- nonzero iff the w block has a
    finite entry.  A zero mask MUST imply an all-+inf block for the result
    to equal the dense product; a fully skipped output tile is +inf.
    """
    m, kdim, n = check_operands("minplus_mm_masked", d, w, BM, BK, BN)
    check_masks("minplus_mm_masked", dmask, wmask, (m // BM, n // BN,
                                                    kdim // BK))
    if not on_cuda(d, w, dmask, wmask):
        return minplus_mm_masked_plain(d, w, dmask, wmask)
    d, w = d.contiguous(), w.contiguous()
    dmask = dmask.to(torch.int32).contiguous()
    wmask = wmask.to(torch.int32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=d.device)
    launch("minplus_mm_masked", _lib().minplus_mm_masked, d.data_ptr(),
           w.data_ptr(), out.data_ptr(), dmask.data_ptr(), wmask.data_ptr(),
           m, kdim, n)
    LAUNCHES["minplus_mm_masked"] += 1
    return out
