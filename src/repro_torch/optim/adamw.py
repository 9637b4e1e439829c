"""AdamW (port of ``repro.optim.adamw``).

Moments live in ``cfg.moment_dtype`` (float32, bfloat16 or float8_e5m2),
with the arithmetic in float32 and a cast on store.  Global-norm clipping
runs in float32.  A stacked leaf (ndim >= 3: an expert stack) is read and
updated one slice of its leading axis at a time, so its float32 working
copies never exist whole (an expert stack of llama4 is 21.5 GB in
float32).  The update is functional: new parameter and moment tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .tree import tree_flatten, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the parameters' device
    m: dict
    v: dict


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    leaves, _ = tree_flatten(params)
    dev = leaves[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=dev)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _stacked(x: torch.Tensor) -> bool:
    return x.dim() >= 3 and x.shape[0] > 1


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares in float32, slice by slice for a stacked leaf."""
    if _stacked(x):
        return sum(sl.float().square().sum() for sl in x)
    return x.float().square().sum()


def global_norm(tree, shardings=None) -> torch.Tensor:
    """The float32 norm of every leaf together.  With ``shardings`` (a tree
    of ``launch.mesh.Sharding`` like ``tree``: the leaves are this
    process's blocks) each leaf's sum of squares is summed over the axes
    its block is split over, in rank order, so a leaf replicated over an
    axis counts once and every process gets the same bits."""
    if shardings is None:
        return torch.sqrt(sum(_sumsq(x) for x in tree_leaves(tree)))
    pairs = paired(tree, shardings)
    sq = shard_sums([_sumsq(x) for x, _ in pairs], [sh for _, sh in pairs])
    return torch.sqrt(sum(sq))


def paired(tree, shardings) -> list:
    """``(leaf, its sharding)`` in ``tree``'s leaf order (matched by
    place: key, index or field, not by order)."""
    out = []
    tree_map(lambda x, sh: out.append((x, sh)), tree, shardings)
    return out


def shard_sums(vals, shardings, op: str = "psum") -> list:
    """Each scalar of ``vals`` summed (``op="pmax"``: maxed) over the axes
    of its leaf's sharding, one collective per set of axes."""
    out = list(vals)
    by_axes: dict = {}
    for i, sh in enumerate(shardings):
        axes = tuple(a for a in sh.mesh.axis_names if a in sh.axes)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        v = torch.stack([out[i] for i in idx])
        for a in axes:
            v = getattr(shardings[idx[0]].mesh.group(a), op)(v)
        for j, i in enumerate(idx):
            out[i] = v[j]
    return out


def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0, shardings=None):
    """Returns (new_params, new_state).  ``lr`` is a float or a float32
    tensor (``warmup_cosine``'s).  ``shardings``: the leaves are blocks of
    a mesh's parameters (``global_norm``)."""
    step = state.step + 1
    gn = global_norm(grads, shardings)
    scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(g, m, v, p):
        gf = g.float() * scale
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        pf = p.float()
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf)
        return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    gs, _ = tree_flatten(grads)
    ms, _ = tree_flatten(state.m)
    vs, _ = tree_flatten(state.v)
    ps, unflatten = tree_flatten(params)
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(gs, ms, vs, ps):
        if _stacked(g):
            out = (torch.empty_like(p), torch.empty_like(m),
                   torch.empty_like(v))
            for i in range(g.shape[0]):
                for dst, val in zip(out, upd(g[i], m[i], v[i], p[i])):
                    dst[i] = val
        else:
            out = upd(g, m, v, p)
        new_p.append(out[0])
        new_m.append(out[1])
        new_v.append(out[2])
    return unflatten(new_p), AdamWState(step=step, m=unflatten(new_m),
                                        v=unflatten(new_v))
