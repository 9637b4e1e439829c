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
``LIVE_PAIRS`` and ``PAIRS`` tally how much of its launched work the masked
kernel found live (``reset_pairs``, ``read_pairs``); the program never
reads them.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.obs.trace import host_read

from . import build
from .backend import check_masks, check_operands, count_launch, \
    launch, masked_plain, on_cuda
from .ref import count_mm_ref  # the dense kernel's plain version

# The CUDA kernel's block shape (csrc/count_mm.cu; checked against the
# library's own count_mm_block_shape when it loads).
BM, BN, BK = 128, 128, 64
# Rows of the right operand split at a time (bounds the temporaries).
_SPLIT_ROWS = 2048

# count_mm(s, s_planes, x_flags, a_planes, planes_a, out, m, k, n, stream)
# and the masked form with smask, amask and tally after out.
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"count_mm": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
            "count_mm_masked": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                _I, _P]}

LAUNCHES = {"count_mm": 0, "count_mm_masked": 0}
#: The masked kernel's own tally, one int64 [2] per device: the live
#: (k-step, output tile) pairs its CTAs found, and the tiles with none.
LIVE_PAIRS: dict = {}
#: The host's tally of the same launches: launches and (k-step, tile)
#: pairs launched.
PAIRS = {"launches": 0, "pairs": 0}
_PAIRS_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reset_pairs() -> None:
    """Zero ``LIVE_PAIRS`` and ``PAIRS``."""
    with _PAIRS_LOCK:
        for tally in LIVE_PAIRS.values():
            tally.zero_()
        for key in PAIRS:
            PAIRS[key] = 0


def read_pairs() -> dict:
    """``PAIRS`` and, summed over the devices, ``live_pairs`` and
    ``zero_tiles`` since the last ``reset_pairs``: one read per device."""
    with _PAIRS_LOCK:
        live = [tally.tolist() for tally in LIVE_PAIRS.values()]
        return dict(PAIRS, live_pairs=sum(t[0] for t in live),
                    zero_tiles=sum(t[1] for t in live))


def _tally(device: torch.device, m: int, kdim: int, n: int) -> torch.Tensor:
    """Count a masked launch of the block grid (m, kdim, n) on the host,
    and return the device's ``LIVE_PAIRS`` counters for its kernel."""
    with _PAIRS_LOCK:
        PAIRS["launches"] += 1
        PAIRS["pairs"] += (m // BM) * (n // BN) * (kdim // BK)
        if device not in LIVE_PAIRS:
            LIVE_PAIRS[device] = torch.zeros(2, dtype=torch.int64,
                                             device=device)
        return LIVE_PAIRS[device]


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


def split_flags(x: torch.Tensor) -> torch.Tensor:
    """int32 [3, m / BM, k / BK]: the kernel's per-slab flags of an f32
    [m, k] operand (m % BM == k % BK == 0), the plain twin of its split's
    third output: 1 where the slab has a mid piece whose bits are not all
    zero, a nonzero lo piece before its rounding to bf16, or an entry
    x != 0 (so -0 is none).  The first two are set for every nonzero bf16
    piece, and for no piece of an x of magnitude 2^-110 or more that is
    zero."""
    x = x.float()
    hi = _trunc_bf16(x)
    r = x - hi                                        # exact
    mid = _trunc_bf16(r)
    m, k = x.shape
    pieces = torch.stack([mid.view(torch.int32) != 0, (r - mid) != 0,
                          (x.view(torch.int32) & 0x7FFFFFFF) != 0])
    return pieces.view(3, m // BM, BM, k // BK, BK).any(dim=4).any(
        dim=2).to(torch.int32)


def exact_in_bf16(a: torch.Tensor) -> bool:
    """True iff every entry of the f32 ``a`` is a bf16 value (its low 16
    bits are zero), checked a slab of rows at a time."""
    return all(not host_read(bool, (a[r:r + _SPLIT_ROWS].contiguous()
                                    .view(torch.int32) & 0xFFFF).any())
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
    """Contiguous ``s``, its split scratch (the three planes, and its
    (BM x BK) slabs' flags: a nonzero mid piece, lo piece, entry), the right
    operand's planes (split here unless given) and the output."""
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
               torch.empty((3, m // BM, kdim // BK), dtype=torch.int32,
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


def count_mm_masked(s: torch.Tensor, a: torch.Tensor,
                    smask: torch.Tensor | None, amask: torch.Tensor,
                    planes: torch.Tensor | None = None) -> torch.Tensor:
    """Tile-skipping counting product.

    ``smask``: int32 [S/BM, K/BK] -- nonzero iff the count slab has any
    nonzero entry; ``amask``: int32 [K/BK, N/BN] -- nonzero iff the
    adjacency tile has any live edge.  A zero mask MUST imply an all-zero
    block for the result to equal ``s @ a``.  ``smask=None`` takes the
    slabs' own flags (``split_flags(s)[2]``), which the kernel's split
    computes as it goes; a given ``smask`` is ANDed with them on the card
    (a slab of zeros adds exact zeros).  ``planes`` as in ``count_mm``.
    """
    m, kdim, n = check_operands("count_mm_masked", s, a, BM, BK, BN)
    check_masks("count_mm_masked", smask, amask, (m // BM, n // BN,
                                                  kdim // BK))
    if not on_cuda(*(t for t in (s, a, smask, amask) if t is not None)):
        if smask is None:
            smask = split_flags(s)[2]
        return count_mm_masked_plain(s, a, smask, amask)
    s, scratch, planes, out = _launch_args(s, a, planes, m, kdim, n)
    if smask is not None:
        smask = smask.to(torch.int32).contiguous()
    amask = amask.to(torch.int32).contiguous()
    tally = _tally(s.device, m, kdim, n)
    launch("count_mm_masked", _lib().count_mm_masked, s.data_ptr(),
           scratch[0].data_ptr(), scratch[1].data_ptr(), planes.data_ptr(),
           planes.shape[0], out.data_ptr(),
           None if smask is None else smask.data_ptr(), amask.data_ptr(),
           tally.data_ptr(), m, kdim, n)
    count_launch(LAUNCHES, "count_mm_masked")
    return out
