"""R-MAT graph generator (Chakrabarti et al.) — the paper's benchmark input.

A copy of ``repro.data.rmat``: plain numpy, so the same seed gives the same
graph in both packages; ``load_rmat_graph`` adds ``device=``.

Defaults follow the paper exactly: a=0.5, b=0.1, c=0.1, d=0.3, edge count
10x vertices unless stated, integer weights uniform in [1, log2(N)].
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph_state import GraphState, from_edge_list


def rmat_edges(n_vertices: int, n_edges: int, a=0.5, b=0.1, c=0.1, d=0.3,
               seed: int = 0, weighted: bool = True):
    """Returns (src, dst, w) int32/float32 arrays. n_vertices must be 2^k."""
    scale = int(np.log2(n_vertices))
    assert 2 ** scale == n_vertices, "R-MAT needs a power-of-two vertex count"
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    probs = np.array([a, b, c, d]).cumsum()
    for level in range(scale):
        r = rng.random(n_edges)
        quad = np.searchsorted(probs, r)
        half = n_vertices >> (level + 1)
        src += np.where((quad == 2) | (quad == 3), half, 0)
        dst += np.where((quad == 1) | (quad == 3), half, 0)
    if weighted:
        w = rng.integers(1, max(2, scale + 1), size=n_edges).astype(np.float32)
    else:
        w = np.ones(n_edges, np.float32)
    # drop self loops (paper graphs are simple directed graphs)
    keep = src != dst
    return src[keep].astype(np.int32), dst[keep].astype(np.int32), w[keep]


def load_rmat_graph(n_vertices: int, n_edges: int, slack: float = 1.5,
                    seed: int = 0, weighted: bool = True, *,
                    device="cuda") -> GraphState:
    """Paper Table-1 style initial graph, with edge-capacity slack for the
    dynamic-update workload."""
    src, dst, w = rmat_edges(n_vertices, n_edges, seed=seed, weighted=weighted)
    ecap = int(n_edges * slack)
    return from_edge_list(n_vertices, ecap, src, dst, w, device=device)
