"""Device dispatch, shared guards and the shared launch and plain-version
helpers of the kernel modules.

The reference switches Pallas into interpret mode off the TPU
(``repro.kernels.backend.INTERPRET``).  Here the switch is the tensor's
device: a CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain PyTorch version.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import threading

import torch

#: Serialises the launch counts: the sharded engine launches from one
#: thread per rank, and ``+= 1`` on a dict entry is not atomic.
_COUNT_LOCK = threading.Lock()


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True iff every tensor lies on a CUDA device, False iff all lie on
    the CPU; mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all lie on one CUDA device or all on "
                     f"the CPU, got devices {sorted(kinds)}")


def check_blocks(name: str, s: int, kdim: int, n: int,
                 bm: int, bk: int, bn: int) -> None:
    """Refuse shapes the kernel grid would silently truncate.

    ``grid = (s // bm, n // bn)`` with ``kdim // bk`` k-steps drops trailing
    rows/columns when a dimension is not a block multiple; every raw kernel
    entry point calls this so a direct call can't return wrong-shaped
    results (the ``ops`` wrappers pad first and never trip it).
    """
    if s % bm or kdim % bk or n % bn:
        raise ValueError(
            f"{name}: shapes ({s}, {kdim}) x ({kdim}, {n}) are not "
            f"multiples of blocks (bm={bm}, bk={bk}, bn={bn}); grid "
            "truncation would drop trailing rows/columns — pad the operands "
            f"(repro_torch.kernels.ops.{name} does) or pass dividing blocks")


def check_operands(name: str, x: torch.Tensor, a: torch.Tensor,
                   bm: int, bk: int, bn: int):
    """A raw kernel entry point's operand guard: 2-D float32 ``x @ a``
    whose shapes are block multiples.  Returns ``(m, kdim, n)``."""
    if x.dim() != 2 or a.dim() != 2 or x.shape[1] != a.shape[0]:
        raise ValueError(f"{name}: bad operand shapes {tuple(x.shape)} x "
                         f"{tuple(a.shape)}")
    if x.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{name}: operands must be float32, got "
                         f"{x.dtype}/{a.dtype}")
    m, kdim = x.shape
    n = a.shape[1]
    check_blocks(name, m, kdim, n, bm, bk, bn)
    return m, kdim, n


def check_masks(name: str, xmask: torch.Tensor | None, amask: torch.Tensor,
                grid) -> None:
    """The masked kernels' block masks must match the block grid
    ``(m / BM, n / BN, k / BK)`` (``xmask=None``: the kernel finds the
    left operand's own)."""
    xshape = (grid[0], grid[2]) if xmask is None else tuple(xmask.shape)
    if xshape != (grid[0], grid[2]) or tuple(amask.shape) != (grid[2],
                                                              grid[1]):
        raise ValueError(
            f"{name}: mask shapes {xshape}/"
            f"{tuple(amask.shape)} do not match the block grid "
            f"({grid[0]}, {grid[2]})/({grid[2]}, {grid[1]})")


def aligned_f32(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels read float4s
    and copy 16-byte chunks)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def count_launch(launches: dict, name: str) -> None:
    """Add one to a kernel module's ``LAUNCHES[name]`` (any thread)."""
    with _COUNT_LOCK:
        launches[name] += 1


def launch(name: str, fn, *args) -> None:
    """Call a C launcher on PyTorch's current stream; raise if the launch
    was refused (it returns the launch's ``cudaError_t``)."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def masked_plain(x: torch.Tensor, a: torch.Tensor, xmask: torch.Tensor,
                 amask: torch.Tensor, blocks, init: float,
                 step) -> torch.Tensor:
    """A masked kernel's function in plain PyTorch, block for block.

    ``blocks`` = (BM, BN, BK).  The output starts at ``init`` (the
    semiring's identity); for each k-step ``kb`` of BK, exactly the output
    tiles whose ``xmask[i, kb] & amask[kb, j]`` holds become
    ``step(out, x[:, ks], a[ks, :])`` -- the kernel's skip, so the plain
    version stays equal to the kernel even for masks that are not
    conservative.
    """
    bm, bn, bk = blocks
    out = torch.full((x.shape[0], a.shape[1]), init, dtype=torch.float32,
                     device=x.device)
    xm = xmask != 0
    am = amask != 0
    steps = (xm.any(dim=0) & am.any(dim=1)).nonzero().flatten().tolist()
    for kb in steps:
        act = xm[:, kb, None] & am[None, kb, :]           # [m/BM, n/BN]
        act = act.repeat_interleave(bm, 0).repeat_interleave(bn, 1)
        ks = slice(kb * bk, (kb + 1) * bk)
        out = torch.where(act, step(out, x[:, ks], a[ks, :]), out)
    return out


def check_amask(name: str, amask_shape, kdim: int, n: int, tile: int) -> None:
    """The tile-occupancy grid must tile the right operand exactly.

    A mismatched grid (e.g. a ``TileView`` built at a different ``tile``)
    would be silently clipped by the block-mask coarsening and skip live
    slabs; shared by the ``ops`` wrappers and the plain fallbacks in
    ``repro_torch.core.semiring`` so both paths raise identically.
    """
    expect = (-(-kdim // tile), -(-n // tile))
    if tuple(amask_shape) != expect:
        raise ValueError(
            f"{name}: amask shape {tuple(amask_shape)} does not tile the "
            f"({kdim}, {n}) operand at tile={tile} (expected {expect}); "
            "was the tile view built with a different tile size?")
