"""Boolean-semiring product (BFS frontier expansion): Hopper kernel + plain
version.

Port of ``repro.kernels.bool_mm``.  ``bool_mm`` and ``bool_mm_masked`` are
the raw entry points: operands must already be multiples of the CUDA
kernel's block shape (``BM x BK`` times ``BK x BN``; the ``ops`` wrapper
pads).  A CUDA tensor launches the hand-written kernel in
``csrc/bool_mm.cu`` (built with nvcc at first use, bound with ctypes); a
CPU tensor runs the plain PyTorch version beside it.  There is no fallback
from one to the other.  Operands are {0,1} (nonnegative) f32, so the
thresholded sum is exact in any order: the kernel equals its plain version
bit for bit.

``LAUNCHES`` counts kernel launches per entry point; only a launch adds
to it.
"""
from __future__ import annotations

import torch

from . import build
from .backend import check_masks, check_operands, launch, masked_plain, \
    on_cuda
from .ref import bool_mm_ref  # the dense kernel's plain version

# The CUDA kernel's block shape (csrc/bool_mm.cu; checked against the
# library's own bool_mm_block_shape when it loads).
BM, BN, BK = 128, 128, 16

LAUNCHES = {"bool_mm": 0, "bool_mm_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    return build.bind("bool_mm", (BM, BN, BK))


def bool_mm_masked_plain(f: torch.Tensor, a: torch.Tensor,
                         fmask: torch.Tensor,
                         amask: torch.Tensor) -> torch.Tensor:
    """The masked kernel's function in plain PyTorch: the counting sum over
    exactly the (k-step, tile) pairs whose ``fmask & amask`` holds, block
    for block, then thresholded ``> 0`` as the kernel's epilogue does."""
    acc = masked_plain(f, a, fmask, amask, (BM, BN, BK), 0.0,
                       lambda out, fk, ak: out + fk @ ak)
    return (acc > 0).float()


# ------------------------------ entry points -------------------------------

def bool_mm(f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """f: [S, V] {0,1} f32; a: [V, V'] {0,1} f32 -> [S, V'] {0,1} f32.

    Shapes must be multiples of (BM, BK) x (BK, BN)."""
    m, kdim, n = check_operands("bool_mm", f, a, BM, BK, BN)
    if not on_cuda(f, a):
        return bool_mm_ref(f, a)
    f, a = f.contiguous(), a.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=f.device)
    launch("bool_mm", _lib().bool_mm, f.data_ptr(), a.data_ptr(),
           out.data_ptr(), m, kdim, n)
    LAUNCHES["bool_mm"] += 1
    return out


def bool_mm_masked(f: torch.Tensor, a: torch.Tensor, fmask: torch.Tensor,
                   amask: torch.Tensor) -> torch.Tensor:
    """Tile-skipping boolean-semiring product.

    ``fmask``: int32 [S/BM, K/BK] -- nonzero iff the frontier slab has any
    set bit; ``amask``: int32 [K/BK, N/BN] -- nonzero iff the adjacency
    block has any live edge.  A zero mask MUST imply an all-zero block for
    the result to equal ``(f @ a) > 0``.
    """
    m, kdim, n = check_operands("bool_mm_masked", f, a, BM, BK, BN)
    check_masks("bool_mm_masked", fmask, amask, (m // BM, n // BN,
                                                 kdim // BK))
    if not on_cuda(f, a, fmask, amask):
        return bool_mm_masked_plain(f, a, fmask, amask)
    f, a = f.contiguous(), a.contiguous()
    fmask = fmask.to(torch.int32).contiguous()
    amask = amask.to(torch.int32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=f.device)
    launch("bool_mm_masked", _lib().bool_mm_masked, f.data_ptr(),
           a.data_ptr(), out.data_ptr(), fmask.data_ptr(), amask.data_ptr(),
           m, kdim, n)
    LAUNCHES["bool_mm_masked"] += 1
    return out
