"""Carry the reference's parameters over to the port.

``params_from_jax`` takes the JAX model's parameter pytree with its leaves
as numpy arrays (``jax.tree.map(np.asarray, params)``; the per-layer
parameters stacked on a leading L axis, as ``repro.models.transformer``
keeps them) and returns the port's parameters -- the same dict, with the
``layers`` unstacked into a list of per-layer dicts -- on ``device``, in
the same dtypes.  Both packages then compute the same function, which is
what the parity tests compare.  It imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph_state import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through float32
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def params_from_jax(tree: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    out = {k: _tree(v, lambda a: _tensor(a, dev))
           for k, v in tree.items() if k != "layers"}
    stacked = _tree(tree["layers"], lambda a: _tensor(a, dev))
    n = len(stacked["ln1"])
    out["layers"] = [_tree(stacked, lambda t, i=i: t[i].clone())
                     for i in range(n)]
    return out
