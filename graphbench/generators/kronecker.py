"""The Graph500 specification's Kronecker generator (its reference code: per
level a row bit with P(1) = 1 - (A + B) and a column bit conditioned on
it), vertex labels permuted, edge order permuted.

Reads the configuration's ``scale``, ``edge_factor``, ``a``, ``b`` and
``c``.  Returns every drawn edge once, duplicates and self-loops as drawn;
``graphs.draw`` applies the configuration's ``directed`` and
``self_loops``.
"""
import numpy as np


def draw(config: dict, rng, weight):
    """``(n, i, j, w)``: ``n`` vertices and the drawn edges ``i -> j``."""
    scale = int(config["scale"])
    a, b, c = config["a"], config["b"], config["c"]
    n, m = 1 << scale, int(config["edge_factor"]) << scale
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
    return n, i[order], j[order], weight(rng, m)
