"""The deployments' initial graphs, drawn from a seed.

Frozen here, so that a change to the program cannot move the yardstick:

  * ``kronecker`` -- the Graph500 specification's Kronecker generator
    (its reference code: per level a row bit with P(1) = 1 - (A + B) and a
    column bit conditioned on it), vertex labels permuted, edge order
    permuted; each undirected edge stored in both directions, self-loops
    dropped.

Edge weights are drawn as the configuration's ``weights`` names
(``WEIGHTS``); the update stream draws an inserted edge's weight the same
way.  ``draw`` returns host arrays ``(src, dst, w)`` (int32, int32,
float32) of the directed entries, duplicates included: the loader keeps
the last weight of a duplicated key, and the reference does the same.
"""
from __future__ import annotations

import numpy as np


def uniform_01(rng, size: int):
    """Real weights uniform in [0, 1), the Graph500 specification's."""
    return rng.random(size).astype(np.float32)


WEIGHTS = {"uniform_01": uniform_01}


def weight_draw(config: dict):
    """The configuration's ``weight(rng, size)`` function."""
    return WEIGHTS[config["weights"]]


def kronecker(rng, scale: int, edge_factor: int, a: float, b: float,
              c: float, weight):
    n, m = 1 << scale, edge_factor << scale
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    i = np.zeros(m, np.int64)
    j = np.zeros(m, np.int64)
    for level in range(scale):
        i_bit = rng.random(m) > ab
        j_bit = rng.random(m) > np.where(i_bit, c_norm, a_norm)
        i += i_bit.astype(np.int64) << level
        j += j_bit.astype(np.int64) << level
    perm = rng.permutation(n)
    i, j = perm[i], perm[j]
    order = rng.permutation(m)
    i, j = i[order], j[order]
    w = weight(rng, m)
    keep = i != j
    i, j, w = i[keep], j[keep], w[keep]
    src = np.concatenate([i, j]).astype(np.int32)
    dst = np.concatenate([j, i]).astype(np.int32)
    return src, dst, np.concatenate([w, w])


def draw(config: dict, rng):
    """``(n_vertices, src, dst, w)`` of a configuration's initial graph."""
    scale = int(config["scale"])
    gen = config["generator"]
    if gen != "kronecker":
        raise ValueError(f"unknown graph generator {gen!r}")
    src, dst, w = kronecker(rng, scale, int(config["edge_factor"]),
                            config["a"], config["b"], config["c"],
                            weight_draw(config))
    return 1 << scale, src, dst, w


def edge_capacity(config: dict, n_entries: int) -> int:
    return int(n_entries * float(config["edge_slack"]))
