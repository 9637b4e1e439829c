"""Counting-semiring product (Brandes sigma): Hopper kernel + plain version.

Port of ``repro.kernels.count_mm``.  ``count_mm`` and ``count_mm_masked``
are the raw entry points: operands must already be multiples of the CUDA
kernel's block shape (``BM x BK`` times ``BK x BN``; the ``ops`` wrapper
pads).  A CUDA tensor launches the hand-written kernel in
``csrc/count_mm.cu`` (built with nvcc at first use, bound with ctypes); a
CPU tensor runs the plain PyTorch version beside it, which computes the
same function block for block.  There is no fallback from one to the other.

The kernel computes the f32 product as an exact split onto bf16 tensor
cores: ``split3`` is the truncation split (the plain twin of the kernel's
left-operand split), ``right_planes`` splits the right operand once into
the bf16 planes the kernel reads (one plane when it is exact in bf16, three
otherwise).  Pass those planes as ``planes=`` to reuse them across products.

``LAUNCHES`` counts kernel launches per entry point; only a launch adds
to it, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .backend import check_masks, check_operands, count_launch, \
    launch, masked_plain, on_cuda
from .ref import count_mm_ref  # the dense kernel's plain version

# The CUDA kernel's block shape (csrc/count_mm.cu; checked against the
# library's own count_mm_block_shape when it loads).
BM, BN, BK = 128, 128, 64
# Rows of the right operand split at a time (bounds the temporaries).
_SPLIT_ROWS = 2048

# count_mm(s, s_planes, x_live, a_planes, planes_a, out, m, k, n, stream)
# and the masked form with smask, amask after out.
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"count_mm": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
            "count_mm_masked": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                                _P]}

LAUNCHES = {"count_mm": 0, "count_mm_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    return build.bind("count_mm", (BM, BN, BK), ARGTYPES)


def _trunc_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) with its low 16 bits cleared: a bf16 value, as f32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def split3(x: torch.Tensor):
    """The truncation split of an f32 tensor: ``(hi, mid, lo)`` in bf16 with
    ``hi`` = x truncated to bf16, ``mid`` = (x - hi) truncated, ``lo`` =
    x - hi - mid rounded.  Each piece has the sign of ``x`` (or is zero),
    and ``hi + mid + lo == x`` exactly for zero and every |x| >= 2^-110; a
    smaller x keeps its bits down to bf16's least subnormal, 2^-133."""
    x = x.float()
    hi = _trunc_bf16(x)
    r = x - hi                                        # exact
    mid = _trunc_bf16(r)
    return hi.bfloat16(), mid.bfloat16(), (r - mid).bfloat16()


def exact_in_bf16(a: torch.Tensor) -> bool:
    """True iff every entry of the f32 ``a`` is a bf16 value (its low 16
    bits are zero), checked a slab of rows at a time."""
    return all(not bool((a[r:r + _SPLIT_ROWS].contiguous().view(torch.int32)
                         & 0xFFFF).any())
               for r in range(0, a.shape[0], _SPLIT_ROWS))


def right_planes(a: torch.Tensor) -> torch.Tensor:
    """The right operand ``a`` [K, N] (f32) as the kernel reads it: bf16
    planes [P, N, K], K contiguous, whose sum is ``a`` transposed.  One
    plane when ``a`` is exact in bf16 (a {0,1} adjacency), else the three
    pieces of ``split3``."""
    k, n = a.shape
    nplanes = 1 if exact_in_bf16(a) else 3
    planes = torch.empty((nplanes, n, k), dtype=torch.bfloat16,
                         device=a.device)
    for r in range(0, k, _SPLIT_ROWS):
        rows = a[r:r + _SPLIT_ROWS].float()
        pieces = (rows.bfloat16(),) if nplanes == 1 else split3(rows)
        for i, piece in enumerate(pieces):
            planes[i, :, r:r + _SPLIT_ROWS] = piece.t()
    return planes


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

def _launch_args(s: torch.Tensor, a: torch.Tensor, planes, m, kdim, n):
    """Contiguous ``s``, its split scratch (the three planes, and which of
    its (BM x BK) slabs hold a nonzero mid or lo piece), the right operand's
    planes (split here unless given) and the output."""
    if planes is None:
        planes = right_planes(a)
    if (planes.dtype != torch.bfloat16 or planes.dim() != 3
            or planes.shape[0] not in (1, 3)
            or tuple(planes.shape[1:]) != (n, kdim)
            or not planes.is_contiguous() or planes.device != s.device):
        raise ValueError(f"count_mm: planes {tuple(planes.shape)} "
                         f"{planes.dtype} are not right_planes of a "
                         f"({kdim}, {n}) operand on {s.device}")
    s = s.contiguous()
    scratch = (torch.empty((3, m, kdim), dtype=torch.bfloat16,
                           device=s.device),
               torch.empty((2, m // BM, kdim // BK), dtype=torch.int32,
                           device=s.device))
    out = torch.empty((m, n), dtype=torch.float32, device=s.device)
    return s, scratch, planes, out


def count_mm(s: torch.Tensor, a: torch.Tensor,
             planes: torch.Tensor | None = None) -> torch.Tensor:
    """s: [S, V] f32 counts; a: [V, V'] f32 -> [S, V'] f32 (plain product).

    Shapes must be multiples of (BM, BK) x (BK, BN).  ``planes``: the
    kernel's ``right_planes(a)``, when the caller keeps them."""
    m, kdim, n = check_operands("count_mm", s, a, BM, BK, BN)
    if not on_cuda(s, a):
        return count_mm_ref(s, a)
    s, scratch, planes, out = _launch_args(s, a, planes, m, kdim, n)
    launch("count_mm", _lib().count_mm, s.data_ptr(), scratch[0].data_ptr(),
           scratch[1].data_ptr(), planes.data_ptr(), planes.shape[0],
           out.data_ptr(), m, kdim, n)
    count_launch(LAUNCHES, "count_mm")
    return out


def count_mm_masked(s: torch.Tensor, a: torch.Tensor, smask: torch.Tensor,
                    amask: torch.Tensor,
                    planes: torch.Tensor | None = None) -> torch.Tensor:
    """Tile-skipping counting product.

    ``smask``: int32 [S/BM, K/BK] -- nonzero iff the count slab has any
    nonzero entry; ``amask``: int32 [K/BK, N/BN] -- nonzero iff the
    adjacency tile has any live edge.  A zero mask MUST imply an all-zero
    block for the result to equal ``s @ a``.  ``planes`` as in
    ``count_mm``.
    """
    m, kdim, n = check_operands("count_mm_masked", s, a, BM, BK, BN)
    check_masks("count_mm_masked", smask, amask, (m // BM, n // BN,
                                                  kdim // BK))
    if not on_cuda(s, a, smask, amask):
        return count_mm_masked_plain(s, a, smask, amask)
    s, scratch, planes, out = _launch_args(s, a, planes, m, kdim, n)
    smask = smask.to(torch.int32).contiguous()
    amask = amask.to(torch.int32).contiguous()
    launch("count_mm_masked", _lib().count_mm_masked, s.data_ptr(),
           scratch[0].data_ptr(), scratch[1].data_ptr(), planes.data_ptr(),
           planes.shape[0], out.data_ptr(), smask.data_ptr(),
           amask.data_ptr(), m, kdim, n)
    count_launch(LAUNCHES, "count_mm_masked")
    return out
