"""SSCA#2 v2.2's scalable data generator (R-MAT, Chakrabarti, Zhan and
Faloutsos): each arc descends ``scale`` levels of the adjacency matrix, and
at each level one uniform draw picks the quadrant, a, b, c or d with the
probabilities the configuration gives; then one uniform permutation of the
vertex labels, drawn from the same generator.

Reads the configuration's ``scale``, ``edge_factor``, ``a``, ``b`` and
``c`` (``d`` is what is left).  Returns every drawn arc once, in the order
drawn, multi-arcs and self-loops as drawn; ``graphs.draw`` drops the
self-loops and the loader keeps one arc of each key.
"""
import numpy as np


def draw(config: dict, rng, weight):
    """``(n, i, j, w)``: ``n`` vertices and the drawn arcs ``i -> j``."""
    scale = int(config["scale"])
    a, b, c = config["a"], config["b"], config["c"]
    n, m = 1 << scale, int(config["edge_factor"]) << scale
    i = np.zeros(m, np.int64)
    j = np.zeros(m, np.int64)
    for level in range(scale):
        r = rng.random(m)
        # quadrants a (0, 0), b (0, 1), c (1, 0), d (1, 1)
        i_bit = r >= a + b
        j_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        i += i_bit.astype(np.int64) << level
        j += j_bit.astype(np.int64) << level
    perm = rng.permutation(n)
    return n, perm[i], perm[j], weight(rng, m)
