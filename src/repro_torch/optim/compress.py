"""Error-feedback int8 gradient compression (port of
``repro.optim.compress``).

Each gradient leaf, plus the residual carried from the step before, is
fake-quantised to symmetric per-tensor int8 (``round`` half to even, as
the reference's); the quantisation error is the next residual.  On one
card the transform is applied to the gradients as they are: it has the
numerics a cross-host all-reduce of the int8 values would give.

    grads_q, comp_state = compress_grads(grads, comp_state)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .tree import tree_flatten, tree_map


class CompressState(NamedTuple):
    residual: dict     # error-feedback accumulator, float32, as the grads


def compress_init(params) -> CompressState:
    return CompressState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def quant_dequant(x: torch.Tensor):
    """Symmetric per-tensor int8 fake-quant. Returns (dq, err)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    dq = q.float() * scale
    return dq, xf - dq


def compress_grads(grads, state: CompressState):
    """Returns (dequantised grads, in their dtypes; the new state)."""
    gs, unflatten = tree_flatten(grads)
    rs, _ = tree_flatten(state.residual)
    out = [quant_dequant(g.float() + r) for g, r in zip(gs, rs)]
    return (unflatten([dq.to(g.dtype) for (dq, _), g in zip(out, gs)]),
            CompressState(residual=unflatten([err for _, err in out])))
