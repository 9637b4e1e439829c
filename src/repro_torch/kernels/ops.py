"""Padded public wrappers around the Hopper kernels (port of
``repro.kernels.ops``).

``bool_mm``, ``minplus_mm`` and ``count_mm`` take any ``(S, V) x (V, V')``
shapes: they pad the operands up to the CUDA kernel's block shape with the
semiring's identity (0 for the boolean and counting products, +inf for
min-plus), dispatch, and slice the padding back off.

With ``amask`` -- the tile-occupancy grid of the right operand at ``tile``
granularity (see ``repro_torch.core.tiles``) -- they dispatch to the
tile-skipping kernel: the grid is coarsened to the CUDA kernel's
``(BK, BN)`` block grid (not to the Pallas kernel's blocks), the left
operand's slab mask is derived from the operand itself (frontier slabs go
all-identity as the BFS/SSSP/BC levels saturate; the count kernel's split
finds its own as it splits the operand), and the kernel skips every
(slab, block) pair whose contribution is the identity.

``*_against(a, ...)`` prepares a right operand that stays fixed across many
products (one per BFS level, relax pass or BC level): it is padded and its
mask coarsened once, not per product; on the card it is also put once
into the form the kernel reads: the count product's bf16 planes
(``count_mm.right_planes``), the boolean product's transposed int8 pack
(``bool_mm.pack_right``).  The min-plus product's coarsened mask is also
narrowed once to the weights' own live blocks at the kernel's ``(BK, BN)``
grain (``minplus_live_blocks``), on whatever device the weights are.

``flash_attention`` needs no padding: its kernel masks the ragged edges
itself, so the wrapper here is the kernel module's entry point as it is.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import bool_mm as _bool
from . import count_mm as _count
from . import flash_attention as _flash
from . import minplus_mm as _minplus
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
    all-identity block is marked active, never the reverse.
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


def _slab_mask(xp: torch.Tensor, bm: int, bk: int,
               nonidentity) -> torch.Tensor:
    """Blockwise any(non-identity) over a padded left operand.

    ``nonidentity`` is the semiring's test, as in the reference: ``!= 0``
    for the boolean and counting products, ``torch.isfinite`` for min-plus
    (whose identity is +inf, so a slab of ``0.0`` distances is live)."""
    mp, kp = xp.shape
    return nonidentity(xp).view(mp // bm, bm, kp // bk, bk).any(dim=3).any(
        dim=1).to(torch.int32)


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return x != 0


def _against(kern, name: str, identity: float, nonidentity,
             a: torch.Tensor, amask: torch.Tensor | None, tile: int,
             prepare=None, narrow=None):
    """``x -> name(x, a)`` through ``kern``'s dense or masked entry point,
    with ``a`` padded and ``amask`` coarsened to the kernel's blocks once;
    ``nonidentity=None`` leaves the left operand's slab mask to the masked
    entry point.
    ``prepare(ap)``, where given, makes once from the padded ``a`` the extra
    keyword arguments that every call of the entry points gets;
    ``narrow(ap, am)`` the mask that the masked entry point reads, from the
    coarsened one."""
    bm, bn, bk = kern.BM, kern.BN, kern.BK
    ap, (_, n) = _pad2(a.float(), bk, bn, identity)
    dense = getattr(kern, name)
    masked = getattr(kern, f"{name}_masked")
    am = None
    if amask is not None:
        check_amask(name, amask.shape, a.shape[0], a.shape[1], tile)
        am = _coarsen_mask(amask, tile, bk, ap.shape[0] // bk, bn,
                           ap.shape[1] // bn)
        if narrow is not None:
            am = narrow(ap, am)
    kw = {} if prepare is None else prepare(ap)

    def product(x: torch.Tensor) -> torch.Tensor:
        xp, (m, _) = _pad2(x.float(), bm, bk, identity)
        if am is None:
            out = dense(xp, ap, **kw)
        else:
            xm = (None if nonidentity is None
                  else _slab_mask(xp, bm, bk, nonidentity))
            out = masked(xp, ap, xm, am, **kw)
        return out if out.shape == (m, n) else out[:m, :n]

    return product


def bool_mm_against(a: torch.Tensor, amask: torch.Tensor | None = None,
                    tile: int = 128):
    """``f -> bool_mm(f, a, amask, tile)`` for an adjacency reused across
    the BFS levels."""
    return _against(_bool, "bool_mm", 0.0, _nonzero, a, amask, tile,
                    prepare=_bool_packed)


def _bool_packed(ap: torch.Tensor) -> dict:
    """The boolean kernel reads its right operand packed to int8 and
    transposed: pack the padded operand once, on the card."""
    return {"packed": _bool.pack_right(ap)} if ap.is_cuda else {}


def minplus_mm_against(w: torch.Tensor, amask: torch.Tensor | None = None,
                       tile: int = 128):
    """``d -> minplus_mm(d, w, amask, tile)`` for weights reused across the
    relax passes."""
    return _against(_minplus, "minplus_mm", math.inf, torch.isfinite, w,
                    amask, tile, narrow=_minplus_exact)


def minplus_live_blocks(wp: torch.Tensor) -> torch.Tensor:
    """int32 [K/BK, N/BN]: 1 where the padded weights' (BK, BN) block of
    the min-plus kernel holds an entry below +inf (one pass over ``wp``)."""
    bn, bk = _minplus.BN, _minplus.BK
    kp, np_ = wp.shape
    low = wp.reshape(kp // bk, bk, np_ // bn, bn).amin(dim=(1, 3))
    return (low < math.inf).to(torch.int32)


def _minplus_exact(wp: torch.Tensor, am: torch.Tensor) -> torch.Tensor:
    """The tile occupancy, coarsened to the kernel's (BK, BN) blocks, marks
    a block live when its 128-tile is; ``w`` stays fixed across the relax
    passes, so AND it once with the blocks' own occupancy."""
    return am & minplus_live_blocks(wp)


def count_mm_against(a: torch.Tensor, amask: torch.Tensor | None = None,
                     tile: int = 128):
    """``s -> count_mm(s, a, amask, tile)`` for a right operand reused
    across the BC levels.  The masked kernel takes the slabs of ``s`` that
    hold a nonzero entry from its own split of ``s``."""
    return _against(_count, "count_mm", 0.0, None, a, amask, tile,
                    prepare=_count_planes)


def _count_planes(ap: torch.Tensor) -> dict:
    """The count kernel reads its right operand as bf16 planes: split the
    padded operand once, on the card."""
    return {"planes": _count.right_planes(ap)} if ap.is_cuda else {}


def bool_mm(f: torch.Tensor, a: torch.Tensor,
            amask: torch.Tensor | None = None,
            tile: int = 128) -> torch.Tensor:
    """Padded boolean-semiring matmul; zero padding is the identity.

    ``amask``: optional tile-occupancy grid of ``a`` (nonzero iff the
    ``tile`` x ``tile`` block holds any set bit) enabling tile skipping.
    """
    return bool_mm_against(a, amask=amask, tile=tile)(f)


def minplus_mm(d: torch.Tensor, w: torch.Tensor,
               amask: torch.Tensor | None = None,
               tile: int = 128) -> torch.Tensor:
    """Padded tropical matmul; +inf padding is the semiring identity.

    ``amask``: optional tile-occupancy grid of ``w`` (nonzero iff the
    ``tile`` x ``tile`` block holds any finite weight).
    """
    return minplus_mm_against(w, amask=amask, tile=tile)(d)


def count_mm(s: torch.Tensor, a: torch.Tensor,
             amask: torch.Tensor | None = None,
             tile: int = 128) -> torch.Tensor:
    """Padded counting matmul (Brandes sigma); zero padding is the identity.

    ``amask``: optional tile-occupancy grid of ``a``.
    """
    return count_mm_against(a, amask=amask, tile=tile)(s)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Causal GQA flash attention; q [B,Hq,Sq,D], kv [B,Hkv,Skv,D]."""
    return _flash.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                  window=window)
