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

import ctypes

import torch

from . import build
from .backend import check_blocks, on_cuda
from .ref import count_mm_ref  # the dense kernel's plain version

# The CUDA kernel's block shape (csrc/count_mm.cu; checked against the
# library's own count_mm_block_shape when it loads).
BM, BN, BK = 64, 64, 32

LAUNCHES = {"count_mm": 0, "count_mm_masked": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _bound.get("count_mm")
    if lib is None:
        lib = build.load("count_mm")
        lib.count_mm_block_shape.argtypes = [ctypes.POINTER(_I)]
        lib.count_mm_block_shape.restype = None
        shape = (_I * 3)()
        lib.count_mm_block_shape(shape)
        if tuple(shape) != (BM, BN, BK):
            raise RuntimeError(f"csrc/count_mm.cu blocks {tuple(shape)} != "
                               f"the wrapper's {(BM, BN, BK)}")
        lib.count_mm.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.count_mm.restype = _I
        lib.count_mm_masked.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.count_mm_masked.restype = _I
        _bound["count_mm"] = lib
    return lib


def _check_operands(name: str, s: torch.Tensor, a: torch.Tensor):
    if s.dim() != 2 or a.dim() != 2 or s.shape[1] != a.shape[0]:
        raise ValueError(f"{name}: bad operand shapes {tuple(s.shape)} x "
                         f"{tuple(a.shape)}")
    if s.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{name}: operands must be float32, got "
                         f"{s.dtype}/{a.dtype}")
    m, kdim = s.shape
    n = a.shape[1]
    check_blocks(name, m, kdim, n, BM, BK, BN)
    return m, kdim, n


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ----------------------------- plain versions ------------------------------

def count_mm_masked_plain(s: torch.Tensor, a: torch.Tensor,
                          smask: torch.Tensor,
                          amask: torch.Tensor) -> torch.Tensor:
    """The masked kernel's function in plain PyTorch: per k-step of ``BK``,
    add ``s[:, k] @ a[k, :]`` into exactly the output tiles whose
    ``smask[i, k] & amask[k, j]`` holds -- the kernel's skip, block for
    block (so it stays exact even for masks that are not conservative)."""
    m, kdim = s.shape
    n = a.shape[1]
    out = torch.zeros((m, n), dtype=torch.float32, device=s.device)
    sm = smask != 0
    am = amask != 0
    steps = (sm.any(dim=0) & am.any(dim=1)).nonzero().flatten().tolist()
    for kb in steps:
        act = sm[:, kb, None] & am[None, kb, :]           # [m/BM, n/BN]
        act = act.repeat_interleave(BM, 0).repeat_interleave(BN, 1)
        ks = slice(kb * BK, (kb + 1) * BK)
        out += torch.where(act, s[:, ks] @ a[ks, :], 0.0)
    return out


# ------------------------------ entry points -------------------------------

def count_mm(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """s: [S, V] f32 counts; a: [V, V'] f32 -> [S, V'] f32 (plain product).

    Shapes must be multiples of (BM, BK) x (BK, BN)."""
    m, kdim, n = _check_operands("count_mm", s, a)
    if not on_cuda(s, a):
        return count_mm_ref(s, a)
    s, a = s.contiguous(), a.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=s.device)
    err = _lib().count_mm(s.data_ptr(), a.data_ptr(), out.data_ptr(),
                          m, kdim, n, _stream())
    _check_launch("count_mm", err)
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
    m, kdim, n = _check_operands("count_mm_masked", s, a)
    grid = (m // BM, n // BN, kdim // BK)
    if (tuple(smask.shape) != (grid[0], grid[2])
            or tuple(amask.shape) != (grid[2], grid[1])):
        raise ValueError(
            f"count_mm_masked: mask shapes {tuple(smask.shape)}/"
            f"{tuple(amask.shape)} do not match the block grid "
            f"({grid[0]}, {grid[2]})/({grid[2]}, {grid[1]})")
    if not on_cuda(s, a, smask, amask):
        return count_mm_masked_plain(s, a, smask, amask)
    s, a = s.contiguous(), a.contiguous()
    smask = smask.to(torch.int32).contiguous()
    amask = amask.to(torch.int32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=s.device)
    err = _lib().count_mm_masked(s.data_ptr(), a.data_ptr(), out.data_ptr(),
                                 smask.data_ptr(), amask.data_ptr(),
                                 m, kdim, n, _stream())
    _check_launch("count_mm_masked", err)
    LAUNCHES["count_mm_masked"] += 1
    return out
