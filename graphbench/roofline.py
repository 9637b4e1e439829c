"""The least time a counting product can take on one H100, from the work its
operands need.

The work is counted at a fixed grain (``WORK_BM`` x ``WORK_BN`` x
``WORK_BK``), from the operands' own non-zero blocks and never the kernel's
block shape, so the bound does not move when a kernel's tiles do, and the
same work is counted whatever kernel computes the product.  The rule is
``chip_smoke.py``'s (``work_masks``, ``product_work``): two operations per
term for each (slab, block) pair where both operands hold a non-zero,
counted once per non-zero bf16 piece of the left operand's exact
truncation split (the tensor-core form of an exact f32 count product reads
the {0, 1} right operand as one bf16 plane); each needed input block read
once (the left operand in f32, the right at ``a_bytes`` per entry), the
whole f32 output and one int32 flag per block read or written once.

Published peaks of the H100 SXM (NVIDIA's data sheet, dense rates, 700 W).
"""
from __future__ import annotations

BF16_PEAK = 989e12      # FLOP/s, bf16 tensor cores, dense
HBM_RATE = 3.35e12      # bytes/s
WORK_BM, WORK_BN, WORK_BK = 64, 64, 32


def _pad_to(x, rows: int, cols: int):
    import torch

    r, c = x.shape
    pr, pc = -r % rows, -c % cols
    if pr or pc:
        x = torch.nn.functional.pad(x, (0, pc, 0, pr))
    return x


def block_mask(x, bm: int, bk: int):
    """bool ``[ceil(r / bm), ceil(c / bk)]``: which ``bm x bk`` blocks of
    ``x`` hold a non-zero (zero padding at the ragged edges)."""
    import torch

    nz = _pad_to((x != 0).to(torch.uint8), bm, bk)
    r, c = nz.shape
    return nz.view(r // bm, bm, c // bk, bk).amax(dim=(1, 3)) > 0


def truncation_split(x):
    """``(hi, mid, lo)`` with ``hi`` = x truncated to bf16, ``mid`` = the
    rest truncated, ``lo`` = what remains: ``hi + mid + lo == x``."""
    import torch

    x = x.float()
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & -65536).view(torch.float32)
    return hi, mid, r - mid


def pair_work(x, a, a_bytes: int = 4):
    """``(operations, bytes)`` of ``x @ a`` counted on the live
    ``(slab, block)`` pairs of the two operands."""
    bm = min(WORK_BM, x.shape[0])
    sm = block_mask(x, bm, WORK_BK)
    am = block_mask(a, WORK_BK, WORK_BN)
    pairs = float(sm.sum(dim=0).double() @ am.sum(dim=1).double())
    s_blocks = float((sm & am.any(dim=1)[None, :]).sum())
    a_blocks = float((am & sm.any(dim=0)[:, None]).sum())
    S, N = x.shape[0], a.shape[1]
    flops = 2.0 * bm * WORK_BN * WORK_BK * pairs
    nbytes = (4.0 * (s_blocks * bm * WORK_BK + S * N)
              + a_bytes * a_blocks * WORK_BK * WORK_BN
              + 4.0 * (sm.numel() + am.numel()))
    return flops, nbytes


def count_product_work(x, a):
    """``(operations, bytes)`` of an exact f32 counting product ``x @ a``
    on the bf16 tensor cores: the operations of each non-zero piece of
    ``x``'s split, the bytes of ``x`` itself."""
    ops = sum(pair_work(p, a)[0] for p in truncation_split(x))
    return ops, pair_work(x, a)[1]


def least_seconds(ops: float, nbytes: float, peak: float = BF16_PEAK):
    """``(seconds, bound)``: the larger of the operations at ``peak`` and
    the bytes at ``HBM_RATE``, and which of the two it is."""
    t_ops, t_bytes = ops / peak, nbytes / HBM_RATE
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
