"""Device dispatch + shared guards for the kernel modules.

The reference switches Pallas into interpret mode off the TPU
(``repro.kernels.backend.INTERPRET``).  Here the switch is the tensor's
device: a CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain PyTorch version.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch


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
