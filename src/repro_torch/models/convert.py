"""Carry the reference's parameters over to the port.

``params_from_jax`` takes the JAX model's parameter pytree with its leaves
as numpy arrays (``jax.tree.map(np.asarray, params)``; the per-layer
parameters stacked on leading axes, as ``repro.models`` keeps them) and
returns the port's parameters -- the same dict, with each stack unstacked
into (nested) lists of per-layer dicts -- on ``device``, in the same
dtypes.  The stacks are ``STACKED``'s keys: ``layers`` (transformer,
Mamba2), ``encoder`` / ``decoder`` (Whisper), ``tail`` and, stacked twice
as [super-block, layer], ``blocks`` (Zamba2).  Both packages then compute
the same function, which is what the parity tests compare.  It imports no
JAX.

``reference_name`` maps a leaf path of the port's layout (``params/layers/
3/attn/wq``, ``opt/m/blocks/1/0/...``) to the reference's stacked leaf and
the leading indices of its slice, by the same ``STACKED`` table: what a
restore of a checkpoint the reference wrote reads
(``repro_torch.checkpoint.restore_checkpoint``).
"""
from __future__ import annotations

from typing import Optional, Tuple

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


# Stacked subtrees of the reference's parameters: key -> leading axes.
STACKED = {"layers": 1, "encoder": 1, "decoder": 1, "tail": 1, "blocks": 2}


def reference_name(path) -> Optional[Tuple[str, Tuple[int, ...]]]:
    """The reference's name of a port leaf and the leading indices of its
    slice: ``"params/layers/3/attn/wq"`` -> ``("params/layers/attn/wq",
    (3,))``, ``"opt/m/blocks/1/0/x"`` -> ``("opt/m/blocks/x", (1, 0))``.
    ``path``: a ``/``-joined string or a sequence of keys.  ``None`` for a
    leaf outside every stack (``opt/step``, ``params/embed``), whose name
    is the same in both layouts."""
    keys = path.split("/") if isinstance(path, str) else list(path)
    for i, key in enumerate(keys):
        depth = STACKED.get(key)
        idx = keys[i + 1:i + 1 + depth] if depth else ()
        if depth and len(idx) == depth and all(k.isdigit() for k in idx):
            return ("/".join(keys[:i + 1] + keys[i + 1 + depth:]),
                    tuple(int(k) for k in idx))
    return None


def _first_leaf(x):
    return _first_leaf(next(iter(x.values()))) if isinstance(x, dict) else x


def _unstack(stacked: dict, depth: int):
    """A tree whose leaves share ``depth`` leading axes -> nested lists of
    trees of per-layer clones."""
    n = len(_first_leaf(stacked))
    parts = [_tree(stacked, lambda t, i=i: t[i]) for i in range(n)]
    if depth > 1:
        return [_unstack(p, depth - 1) for p in parts]
    return [_tree(p, lambda t: t.clone()) for p in parts]


def params_from_jax(tree: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        v = _tree(v, lambda a: _tensor(a, dev))
        out[k] = _unstack(v, STACKED[k]) if k in STACKED else v
    return out
