"""Counting-semiring product (Brandes sigma): Hopper kernel + plain version.

Port of ``repro.kernels.count_mm``.  ``count_mm`` and ``count_mm_masked``
are the raw entry points: operands must already be multiples of the CUDA
kernel's block shape (``BM x BK`` times ``BK x BN``; the ``ops`` wrapper
pads).  A CUDA tensor launches the hand-written kernel in
``csrc/count_mm.cu`` (built with nvcc at first use, bound with ctypes); a
CPU tensor runs the plain PyTorch version beside it, which computes the
same function block for block.  There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches per entry point; only a launch adds
to it, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from . import build
from .backend import check_masks, check_operands, launch, masked_plain, \
    on_cuda
from .ref import count_mm_ref  # the dense kernel's plain version

# The CUDA kernel's block shape (csrc/count_mm.cu; checked against the
# library's own count_mm_block_shape when it loads).
BM, BN, BK = 64, 64, 32

LAUNCHES = {"count_mm": 0, "count_mm_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    return build.bind("count_mm", (BM, BN, BK))


def count_mm_masked_plain(s: torch.Tensor, a: torch.Tensor,
                          smask: torch.Tensor,
                          amask: torch.Tensor) -> torch.Tensor:
    """The masked kernel's function in plain PyTorch: per k-step of ``BK``,
    add ``s[:, k] @ a[k, :]`` into exactly the output tiles whose
    ``smask[i, k] & amask[k, j]`` holds -- the kernel's skip, block for
    block (so it stays exact even for masks that are not conservative)."""
    return masked_plain(s, a, smask, amask, (BM, BN, BK), 0.0,
                        lambda out, sk, ak: out + sk @ ak)


# ------------------------------ entry points -------------------------------

def count_mm(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """s: [S, V] f32 counts; a: [V, V'] f32 -> [S, V'] f32 (plain product).

    Shapes must be multiples of (BM, BK) x (BK, BN)."""
    m, kdim, n = check_operands("count_mm", s, a, BM, BK, BN)
    if not on_cuda(s, a):
        return count_mm_ref(s, a)
    s, a = s.contiguous(), a.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=s.device)
    launch("count_mm", _lib().count_mm, s.data_ptr(), a.data_ptr(),
           out.data_ptr(), m, kdim, n)
    LAUNCHES["count_mm"] += 1
    return out


def count_mm_masked(s: torch.Tensor, a: torch.Tensor, smask: torch.Tensor,
                    amask: torch.Tensor) -> torch.Tensor:
    """Tile-skipping counting product.

    ``smask``: int32 [S/BM, K/BK] -- nonzero iff the count slab has any
    nonzero entry; ``amask``: int32 [K/BK, N/BN] -- nonzero iff the
    adjacency tile has any live edge.  A zero mask MUST imply an all-zero
    block for the result to equal ``s @ a``.
    """
    m, kdim, n = check_operands("count_mm_masked", s, a, BM, BK, BN)
    check_masks("count_mm_masked", smask, amask, (m // BM, n // BN,
                                                  kdim // BK))
    if not on_cuda(s, a, smask, amask):
        return count_mm_masked_plain(s, a, smask, amask)
    s, a = s.contiguous(), a.contiguous()
    smask = smask.to(torch.int32).contiguous()
    amask = amask.to(torch.int32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=s.device)
    launch("count_mm_masked", _lib().count_mm_masked, s.data_ptr(),
           a.data_ptr(), out.data_ptr(), smask.data_ptr(), amask.data_ptr(),
           m, kdim, n)
    LAUNCHES["count_mm_masked"] += 1
    return out
