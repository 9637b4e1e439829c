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


def quant_dequant(x: torch.Tensor, amax=None):
    """Symmetric per-tensor int8 fake-quant. Returns (dq, err).  ``amax``:
    the tensor's largest magnitude, when ``x`` is a block of it."""
    xf = x.float()
    amax = xf.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    dq = q.float() * scale
    return dq, xf - dq


def compress_grads(grads, state: CompressState, shardings=None):
    """Returns (dequantised grads, in their dtypes; the new state).
    ``shardings``: the leaves are blocks of a mesh's (``adamw.global_norm``),
    each quantised on the scale of its whole tensor."""
    from .adamw import paired, shard_sums

    gs, unflatten = tree_flatten(grads)
    rs, _ = tree_flatten(state.residual)
    xs = [g.float() + r for g, r in zip(gs, rs)]
    amax = [x.abs().max() for x in xs]
    if shardings is not None:
        amax = shard_sums(amax, [sh for _, sh in paired(grads, shardings)],
                          op="pmax")
    out = [quant_dequant(x, a) for x, a in zip(xs, amax)]
    return (unflatten([dq.to(g.dtype) for (dq, _), g in zip(out, gs)]),
            CompressState(residual=unflatten([err for _, err in out])))
