"""Tropical (min, +) product (SSSP relaxation): Hopper kernel + plain version.

Port of ``repro.kernels.minplus_mm``.  ``minplus_mm`` and
``minplus_mm_masked`` are the raw entry points: operands must already be
multiples of the CUDA kernel's block shape (``BM x BK`` times ``BK x BN``;
the ``ops`` wrapper pads with +inf, the identity).  ``BM`` = 8 is a row
granule, not a tile: the kernel runs few rows (the static query's one
source) in a skinny form that splits K across CTAs, and many rows in a
wide form of 128 x 128 tiles (``csrc/minplus_mm.cu``).  A CUDA tensor
launches the hand-written kernel (built with nvcc at first use, bound with
ctypes; the wrapper allocates the scratch it asks for); a CPU tensor runs
the plain PyTorch version beside it.  There is no fallback from one to the
other.  Every candidate ``d + w`` is one rounded f32 add and ``min`` is
exact, so the kernel equals its plain version bit for bit.

The plain versions work k-step by k-step (the reference oracle
``ref.minplus_mm_ref`` broadcasts the whole ``S x K x N`` sum, which no
card holds at the main path's shapes).

``LAUNCHES`` counts kernel launches per entry point; only a launch adds
to it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .backend import aligned_f32, check_masks, check_operands, \
    count_launch, launch, masked_plain, on_cuda

# The CUDA kernel's block shape (csrc/minplus_mm.cu; checked against the
# library's own minplus_mm_block_shape when it loads): the row granule,
# the columns of a CTA and the k-step of the ring and of the masks.
BM, BN, BK = 8, 128, 16

# minplus_mm(d, w, out, scratch, m, k, n, stream) and the masked form with
# dmask, wmask after scratch; minplus_mm_scratch(m, k, n, &floats).
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"minplus_mm": [_P, _P, _P, _P, _I, _I, _I, _P],
            "minplus_mm_masked": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
            "minplus_mm_scratch": [_I, _I, _I,
                                   ctypes.POINTER(ctypes.c_longlong)]}

LAUNCHES = {"minplus_mm": 0, "minplus_mm_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    return build.bind("minplus_mm", (BM, BN, BK), ARGTYPES)


def _scratch(lib, m: int, kdim: int, n: int,
             device: torch.device) -> torch.Tensor:
    """The device scratch the kernel asks for at these shapes: d
    transposed for the wide form, the K splits' partial minima."""
    floats = ctypes.c_longlong(0)
    err = lib.minplus_mm_scratch(m, kdim, n, ctypes.byref(floats))
    if err != 0:
        raise RuntimeError(f"minplus_mm: shapes ({m}, {kdim}) x ({kdim}, "
                           f"{n}) refused (cudaError_t {err})")
    return torch.empty((floats.value,), dtype=torch.float32, device=device)


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
    d, w = aligned_f32(d), aligned_f32(w)
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=d.device)
    scratch = _scratch(lib, m, kdim, n, d.device)
    launch("minplus_mm", lib.minplus_mm, d.data_ptr(), w.data_ptr(),
           out.data_ptr(), scratch.data_ptr(), m, kdim, n)
    count_launch(LAUNCHES, "minplus_mm")
    return out


def minplus_mm_masked(d: torch.Tensor, w: torch.Tensor, dmask: torch.Tensor,
                      wmask: torch.Tensor) -> torch.Tensor:
    """Tile-skipping min-plus product.

    ``dmask``: int32 [S/BM, K/BK] -- nonzero iff the d slab (one row
    granule by one k-step) has a finite entry; ``wmask``: int32 [K/BK,
    N/BN] -- nonzero iff the w block has a finite entry.  The kernel skips
    exactly the (granule, k-step, column panel) blocks where either is
    zero, as ``minplus_mm_masked_plain`` does.  A zero mask MUST imply an
    all-+inf block for the result to equal the dense product; a fully
    skipped output tile is +inf.
    """
    m, kdim, n = check_operands("minplus_mm_masked", d, w, BM, BK, BN)
    check_masks("minplus_mm_masked", dmask, wmask, (m // BM, n // BN,
                                                    kdim // BK))
    if not on_cuda(d, w, dmask, wmask):
        return minplus_mm_masked_plain(d, w, dmask, wmask)
    d, w = aligned_f32(d), aligned_f32(w)
    dmask = dmask.to(torch.int32).contiguous()
    wmask = wmask.to(torch.int32).contiguous()
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=d.device)
    scratch = _scratch(lib, m, kdim, n, d.device)
    launch("minplus_mm_masked", lib.minplus_mm_masked, d.data_ptr(),
           w.data_ptr(), out.data_ptr(), scratch.data_ptr(), dmask.data_ptr(),
           wmask.data_ptr(), m, kdim, n)
    count_launch(LAUNCHES, "minplus_mm_masked")
    return out
