"""Boolean-semiring product (BFS frontier expansion): Hopper kernel + plain
version.

Port of ``repro.kernels.bool_mm``.  ``bool_mm`` and ``bool_mm_masked`` are
the raw entry points: operands must already be multiples of the CUDA
kernel's block shape (``BM x BK`` times ``BK x BN``; the ``ops`` wrapper
pads).  A CUDA tensor launches the hand-written kernel in
``csrc/bool_mm.cu`` (built with nvcc at first use, bound with ctypes); a
CPU tensor runs the plain PyTorch version beside it, with no packing.
There is no fallback from one to the other.

The kernel is an int8 tensor-core product on operands packed to one byte
per entry: ``pack_left`` turns the f32 frontier into int8 ``[M, K]`` (the
kernel does it on every call), ``pack_right`` turns the adjacency into int8
``[N, K]``, transposed, because 8-bit ``wgmma`` reads both operands
K-major.  Pass ``pack_right(a)`` as ``packed=`` to reuse it across
products.  Both packs store ``x != 0``, so the kernel computes "some k with
``f[s, k] != 0`` and ``a[k, j] != 0``": that is ``(f @ a) > 0`` for the
nonnegative {0,1} operands of the reference's contract and of every
caller.  Its s32 sums (at most K < 2^31) are exact in any order, so the
kernel equals its plain version bit for bit; ``bool_mm_packed_plain`` is
that integer formulation in plain PyTorch.

``LAUNCHES`` counts kernel launches per entry point; only a launch adds
to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .backend import aligned_f32, check_masks, check_operands, launch, \
    masked_plain, on_cuda
from .ref import bool_mm_ref  # the dense kernel's plain version

# The CUDA kernel's block shape (csrc/bool_mm.cu; checked against the
# library's own bool_mm_block_shape when it loads).  BK = 128 int8 is one
# 128-byte swizzled row.
BM, BN, BK = 128, 128, 128

# bool_mm(f, f_packed, a_packed, out, m, k, n, stream) and the masked form
# with fmask, amask after out; the packs (x, out, rows, cols, stream).
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"bool_mm": [_P, _P, _P, _P, _I, _I, _I, _P],
            "bool_mm_masked": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
            "bool_mm_pack_left": [_P, _P, _I, _I, _P],
            "bool_mm_pack_right": [_P, _P, _I, _I, _P]}

LAUNCHES = {"bool_mm": 0, "bool_mm_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    return build.bind("bool_mm", (BM, BN, BK), ARGTYPES)


# ------------------------------ packing ------------------------------------

def pack_left_plain(f: torch.Tensor) -> torch.Tensor:
    """``f`` [M, K] as the kernel reads it: int8 ``f != 0``, [M, K]."""
    return (f != 0).to(torch.int8)


def pack_right_plain(a: torch.Tensor) -> torch.Tensor:
    """``a`` [K, N] as the kernel reads it: int8 ``a != 0`` transposed,
    contiguous [N, K] (K contiguous)."""
    return (a != 0).t().to(torch.int8).contiguous()


def pack_left(f: torch.Tensor) -> torch.Tensor:
    """``pack_left_plain`` by the kernel's own pack on a CUDA tensor (the
    one ``bool_mm`` runs on every call; this entry times it alone)."""
    if not on_cuda(f):
        return pack_left_plain(f)
    m, k = f.shape
    if (m * k) % 16:
        raise ValueError(f"bool_mm.pack_left: {m} x {k} entries are not a "
                         f"multiple of 16")
    f = aligned_f32(f.float())
    out = torch.empty((m, k), dtype=torch.int8, device=f.device)
    launch("bool_mm_pack_left", _lib().bool_mm_pack_left, f.data_ptr(),
           out.data_ptr(), m, k)
    return out


def pack_right(a: torch.Tensor) -> torch.Tensor:
    """``pack_right_plain`` by a transposing pack kernel on a CUDA tensor
    (K and N multiples of 64, as the block-multiple operands are)."""
    if not on_cuda(a):
        return pack_right_plain(a)
    k, n = a.shape
    if k % 64 or n % 64:
        raise ValueError(f"bool_mm.pack_right: ({k}, {n}) is not a multiple "
                         f"of 64 each way")
    a = aligned_f32(a.float())
    out = torch.empty((n, k), dtype=torch.int8, device=a.device)
    launch("bool_mm_pack_right", _lib().bool_mm_pack_right, a.data_ptr(),
           out.data_ptr(), k, n)
    return out


def bool_mm_packed_plain(f_packed: torch.Tensor,
                         a_packed: torch.Tensor) -> torch.Tensor:
    """The kernel's integer formulation in plain PyTorch: int8 ``[M, K]``
    times the transposed int8 ``[N, K]``, summed exactly in int32, then
    ``> 0`` as f32 {0,1}."""
    acc = f_packed.to(torch.int32) @ a_packed.to(torch.int32).t()
    return (acc > 0).float()


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

def _launch_args(f: torch.Tensor, a: torch.Tensor, packed, m, kdim, n):
    """Contiguous aligned ``f``, its int8 scratch, the packed right operand
    (packed here unless given) and the output."""
    if packed is None:
        packed = pack_right(a)
    if (packed.dtype != torch.int8 or tuple(packed.shape) != (n, kdim)
            or not packed.is_contiguous() or packed.device != f.device
            or packed.data_ptr() % 16):
        raise ValueError(f"bool_mm: packed {tuple(packed.shape)} "
                         f"{packed.dtype} is not a contiguous, 16-byte "
                         f"aligned pack_right of a ({kdim}, {n}) operand on "
                         f"{f.device}")
    f = aligned_f32(f)
    scratch = torch.empty((m, kdim), dtype=torch.int8, device=f.device)
    out = torch.empty((m, n), dtype=torch.float32, device=f.device)
    return f, scratch, packed, out


def bool_mm(f: torch.Tensor, a: torch.Tensor,
            packed: torch.Tensor | None = None) -> torch.Tensor:
    """f: [S, V] {0,1} f32; a: [V, V'] {0,1} f32 -> [S, V'] {0,1} f32.

    Shapes must be multiples of (BM, BK) x (BK, BN).  ``packed``: the
    kernel's ``pack_right(a)``, when the caller keeps it."""
    m, kdim, n = check_operands("bool_mm", f, a, BM, BK, BN)
    if not on_cuda(f, a):
        return bool_mm_ref(f, a)
    f, scratch, packed, out = _launch_args(f, a, packed, m, kdim, n)
    launch("bool_mm", _lib().bool_mm, f.data_ptr(), scratch.data_ptr(),
           packed.data_ptr(), out.data_ptr(), m, kdim, n)
    LAUNCHES["bool_mm"] += 1
    return out


def bool_mm_masked(f: torch.Tensor, a: torch.Tensor, fmask: torch.Tensor,
                   amask: torch.Tensor,
                   packed: torch.Tensor | None = None) -> torch.Tensor:
    """Tile-skipping boolean-semiring product.

    ``fmask``: int32 [S/BM, K/BK] -- nonzero iff the frontier slab has any
    set bit; ``amask``: int32 [K/BK, N/BN] -- nonzero iff the adjacency
    block has any live edge.  A zero mask MUST imply an all-zero block for
    the result to equal ``(f @ a) > 0``.  ``packed`` as in ``bool_mm``.
    """
    m, kdim, n = check_operands("bool_mm_masked", f, a, BM, BK, BN)
    check_masks("bool_mm_masked", fmask, amask, (m // BM, n // BN,
                                                 kdim // BK))
    if not on_cuda(f, a, fmask, amask):
        return bool_mm_masked_plain(f, a, fmask, amask)
    f, scratch, packed, out = _launch_args(f, a, packed, m, kdim, n)
    fmask = fmask.to(torch.int32).contiguous()
    amask = amask.to(torch.int32).contiguous()
    launch("bool_mm_masked", _lib().bool_mm_masked, f.data_ptr(),
           scratch.data_ptr(), packed.data_ptr(), out.data_ptr(),
           fmask.data_ptr(), amask.data_ptr(), m, kdim, n)
    LAUNCHES["bool_mm_masked"] += 1
    return out
