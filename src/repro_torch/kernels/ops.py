"""Padded public wrappers around the Hopper kernels (port of
``repro.kernels.ops``).

``count_mm`` takes any ``(S, V) x (V, V')`` shapes: it zero-pads the
operands up to the CUDA kernel's block shape (zero is the counting
semiring's identity), dispatches, and slices the padding back off.

With ``amask`` -- the tile-occupancy grid of the right operand at ``tile``
granularity (see ``repro_torch.core.tiles``) -- it dispatches to the
tile-skipping kernel: the grid is coarsened to the CUDA kernel's
``(BK, BN)`` block grid (not to the Pallas kernel's 128/512 blocks), the
left operand's slab mask is derived from the operand itself (frontier
slabs go all-zero as the BC levels saturate), and the kernel skips every
(slab, tile) pair whose contribution is zero.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import count_mm as _count
from .backend import check_amask


def _pad2(x: torch.Tensor, bm: int, bn: int, value: float = 0.0):
    m, n = x.shape
    mp, np_ = -(-m // bm) * bm, -(-n // bn) * bn
    if (mp, np_) == (m, n):
        return x, (m, n)
    return F.pad(x, (0, np_ - n, 0, mp - m), value=value), (m, n)


def _block_ranges(nblocks: int, blk: int, tile: int, ntiles: int):
    """Static (first, last) tile index covered by each kernel block."""
    t0 = (np.arange(nblocks) * blk) // tile
    t1 = ((np.arange(nblocks) + 1) * blk - 1) // tile
    return (np.clip(t0, 0, ntiles - 1).astype(np.int64),
            np.clip(t1, 0, ntiles - 1).astype(np.int64))


def _coarsen_mask(occ: torch.Tensor, tile: int, blk_r: int, nbr: int,
                  blk_c: int, nbc: int) -> torch.Tensor:
    """Tile-granularity occupancy -> kernel-block granularity (any-reduce).

    Works for any (tile, block) size relation via prefix sums over the tile
    grid gathered at the block -> tile ranges.  Blocks that extend past the
    tile grid (operand padding) clip to the last tile -- at worst an
    all-zero block is marked active, never the reverse.
    """
    dev = occ.device
    occ_b = (occ > 0).to(torch.int32)
    nt_r, nt_c = occ_b.shape
    r0, r1 = (torch.as_tensor(x, device=dev)
              for x in _block_ranges(nbr, blk_r, tile, nt_r))
    cum_r = torch.cat([torch.zeros((1, nt_c), dtype=torch.int32, device=dev),
                       torch.cumsum(occ_b, 0, dtype=torch.int32)], 0)
    rows = ((cum_r[r1 + 1] - cum_r[r0]) > 0).to(torch.int32)  # [nbr, nt_c]
    c0, c1 = (torch.as_tensor(x, device=dev)
              for x in _block_ranges(nbc, blk_c, tile, nt_c))
    cum_c = torch.cat([torch.zeros((nbr, 1), dtype=torch.int32, device=dev),
                       torch.cumsum(rows, 1, dtype=torch.int32)], 1)
    return ((cum_c[:, c1 + 1] - cum_c[:, c0]) > 0).to(torch.int32)


def _slab_mask(xp: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """Blockwise any(nonzero) over a padded left operand."""
    mp, kp = xp.shape
    return (xp != 0).view(mp // bm, bm, kp // bk, bk).any(dim=3).any(
        dim=1).to(torch.int32)


def count_mm_against(a: torch.Tensor, amask: torch.Tensor | None = None,
                     tile: int = 128):
    """``s -> count_mm(s, a, amask, tile)`` for a right operand that stays
    fixed across many products (one per BC level): ``a`` is padded and
    ``amask`` coarsened to the kernel's block grid once, not per product.
    """
    bm, bn, bk = _count.BM, _count.BN, _count.BK
    ap, (_, n) = _pad2(a.float(), bk, bn)
    am = None
    if amask is not None:
        check_amask("count_mm", amask.shape, a.shape[0], a.shape[1], tile)
        am = _coarsen_mask(amask, tile, bk, ap.shape[0] // bk, bn,
                           ap.shape[1] // bn)

    def product(s: torch.Tensor) -> torch.Tensor:
        sp, (m, _) = _pad2(s.float(), bm, bk)
        if am is None:
            out = _count.count_mm(sp, ap)
        else:
            out = _count.count_mm_masked(sp, ap, _slab_mask(sp, bm, bk), am)
        return out if out.shape == (m, n) else out[:m, :n]

    return product


def count_mm(s: torch.Tensor, a: torch.Tensor,
             amask: torch.Tensor | None = None,
             tile: int = 128) -> torch.Tensor:
    """Padded counting matmul (Brandes sigma); zero padding is the identity.

    ``amask``: optional tile-occupancy grid of ``a``.
    """
    return count_mm_against(a, amask=amask, tile=tile)(s)
