"""Semiring matmuls: the dense formulation of graph traversal (port of
``repro.core.semiring``).

  * bool semiring  (or, and)        -> BFS frontier expansion
  * tropical       (min, +)         -> SSSP relaxation
  * counting       (+, x) on masks  -> sigma path counting (Brandes)

``use_kernel`` selects the hand-written kernel.  Its default (``None``)
means "the kernel on a CUDA tensor, the plain version on a CPU tensor";
``use_kernel=False`` is the plain version, for tests and for comparing a
kernel with it.  All three products have Hopper kernels
(``repro_torch.kernels``: ``bool_mm``, ``minplus_mm``, ``count_mm``, each
dense and masked).  ``*_against`` prepares a right operand reused across
many products (one per BFS level, relax pass or BC level).

Each product optionally takes ``amask``, the right operand's
tile-occupancy grid (nonzero iff the ``tile x tile`` block holds any
non-identity entry).  The kernel path skips per (slab, tile) block inside
the kernel; the plain fallbacks skip at k-slab granularity -- a slab whose
adjacency row of tiles is empty, or whose left slab is all-identity, is
never multiplied.  Both equal the unmasked dense product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import check_amask

_BLOCK = 128  # logical tile of the blocked plain fallbacks


def _pad_axis(x: torch.Tensor, axis: int, mult: int, value) -> torch.Tensor:
    size = x.shape[axis]
    pad = -(-size // mult) * mult - size
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad
    return F.pad(x, widths, value=value)


def _wants_kernel(use_kernel, x: torch.Tensor) -> bool:
    return x.is_cuda if use_kernel is None else bool(use_kernel)


def _active_slabs(left: torch.Tensor, amask: torch.Tensor, tile: int,
                  nonidentity) -> list:
    """k-slab indices that can contribute: their adjacency tile row holds
    an active tile and their left slab holds a non-identity entry (one host
    read for the whole product)."""
    rows, kp = left.shape
    left_any = nonidentity(left).view(rows, kp // tile, tile).any(
        dim=2).any(dim=0)
    return ((amask > 0).any(dim=1) & left_any).nonzero().flatten().tolist()


def _masked_count_accum(fp_in: torch.Tensor, ap_in: torch.Tensor,
                        amask: torch.Tensor, tile: int,
                        name: str) -> torch.Tensor:
    """Shared k-slab-skipping sum of products: the masked fallback body of
    both ``bool_mm`` (which thresholds the result) and ``count_mm``."""
    check_amask(name, amask.shape, ap_in.shape[0], ap_in.shape[1], tile)
    fp = _pad_axis(fp_in, 1, tile, 0.0)
    ap = _pad_axis(ap_in, 0, tile, 0.0)
    acc = torch.zeros((fp_in.shape[0], ap_in.shape[1]), dtype=torch.float32,
                      device=fp_in.device)
    for i in _active_slabs(fp, amask, tile, lambda x: x != 0):
        ks = slice(i * tile, (i + 1) * tile)
        acc += fp[:, ks] @ ap[ks, :]
    return acc


def bool_mm(f: torch.Tensor, a: torch.Tensor, use_kernel=None,
            amask: torch.Tensor | None = None,
            tile: int = _BLOCK) -> torch.Tensor:
    """(S,V) x (V,V) boolean-semiring product, as f32 {0,1} masks."""
    if _wants_kernel(use_kernel, f):
        from repro_torch.kernels import ops as kops
        return kops.bool_mm(f, a, amask=amask, tile=tile)
    if amask is None:
        return (f.float() @ a.float() > 0).float()
    acc = _masked_count_accum(f.float(), a.float(), amask, tile, "bool_mm")
    return (acc > 0).float()


def minplus_mm(d: torch.Tensor, w: torch.Tensor, use_kernel=None,
               amask: torch.Tensor | None = None,
               tile: int = _BLOCK) -> torch.Tensor:
    """(S,V) x (V,V) tropical product: out[s,j] = min_k d[s,k] + w[k,j]."""
    if _wants_kernel(use_kernel, d):
        from repro_torch.kernels import ops as kops
        return kops.minplus_mm(d, w, amask=amask, tile=tile)
    if amask is not None:
        check_amask("minplus_mm", amask.shape, w.shape[0], w.shape[1], tile)
    # Blocked over k to bound the (S, K, V) broadcast working set.
    blk = min(tile, w.shape[0])
    dp = _pad_axis(d, 1, blk, float("inf"))
    wp = _pad_axis(w, 0, blk, float("inf"))
    if amask is None:
        slabs = range(dp.shape[1] // blk)
    else:
        slabs = _active_slabs(dp, amask, blk, torch.isfinite)
    acc = torch.full((d.shape[0], w.shape[1]), float("inf"), dtype=d.dtype,
                     device=d.device)
    for i in slabs:
        ks = slice(i * blk, (i + 1) * blk)
        cand = torch.amin(dp[:, ks, None] + wp[None, ks, :], dim=1)
        acc = torch.minimum(acc, cand)
    return acc


def count_mm(s: torch.Tensor, a: torch.Tensor, use_kernel=None,
             amask: torch.Tensor | None = None,
             tile: int = _BLOCK) -> torch.Tensor:
    """(S,V) x (V,V) counting product (plain matmul on path counts)."""
    if _wants_kernel(use_kernel, s):
        from repro_torch.kernels import ops as kops
        return kops.count_mm(s, a, amask=amask, tile=tile)
    if amask is None:
        return s.float() @ a.float()
    return _masked_count_accum(s.float(), a.float(), amask, tile, "count_mm")


def _against(name: str, plain, a: torch.Tensor, use_kernel,
             amask: torch.Tensor | None, tile: int):
    if _wants_kernel(use_kernel, a):
        from repro_torch.kernels import ops as kops
        return getattr(kops, f"{name}_against")(a, amask=amask, tile=tile)
    return lambda x: plain(x, a, use_kernel=False, amask=amask, tile=tile)


def bool_mm_against(a: torch.Tensor, use_kernel=None,
                    amask: torch.Tensor | None = None, tile: int = _BLOCK):
    """``f -> bool_mm(f, a, ...)`` for an adjacency reused by many
    products: the kernel path prepares ``a`` and its block mask once."""
    return _against("bool_mm", bool_mm, a, use_kernel, amask, tile)


def minplus_mm_against(w: torch.Tensor, use_kernel=None,
                       amask: torch.Tensor | None = None, tile: int = _BLOCK):
    """``d -> minplus_mm(d, w, ...)``, ``w`` prepared once."""
    return _against("minplus_mm", minplus_mm, w, use_kernel, amask, tile)


def count_mm_against(a: torch.Tensor, use_kernel=None,
                     amask: torch.Tensor | None = None, tile: int = _BLOCK):
    """``s -> count_mm(s, a, ...)``, ``a`` prepared once."""
    return _against("count_mm", count_mm, a, use_kernel, amask, tile)
