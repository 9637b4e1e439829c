"""Single-source queries on one version's live edges (``graph.Edges``), from
their definitions:

  * BFS  -- hop distance from the source (-1 where unreached);
  * SSSP -- least total weight from the source (+inf where unreached), by
    label-correcting relaxation until nothing improves;
  * BC   -- Brandes' single-source pass on hop distances: level, number of
    shortest paths ``sigma`` and dependency ``delta(s | v) = sum over
    successors w of sigma[v] / sigma[w] * (1 + delta[w])``, the source's
    own dependency 0.

A source that is absent or out of range answers ``ok = False`` with
nothing reached.
"""
from __future__ import annotations

import numpy as np


def _source_ok(e, s: int) -> bool:
    return 0 <= s < e.n and bool(e.alive[s])


def bfs(e, s: int):
    """``(ok, dist int64[n])``."""
    dist = np.full(e.n, -1, np.int64)
    if not _source_ok(e, s):
        return False, dist
    dist[s] = 0
    frontier, lvl = np.array([s]), 0
    while frontier.size:
        nbrs = e.dst[e.out_edges(frontier)]
        nbrs = np.unique(nbrs[dist[nbrs] < 0])
        dist[nbrs] = lvl + 1
        frontier, lvl = nbrs, lvl + 1
    return True, dist


def sssp(e, s: int):
    """``(ok, dist float64[n])``."""
    dist = np.full(e.n, np.inf)
    if not _source_ok(e, s):
        return False, dist
    dist[s] = 0.0
    frontier = np.array([s])
    while frontier.size:
        idx = e.out_edges(frontier)
        cand = dist[e.src[idx]] + e.w[idx]
        tgt = e.dst[idx]
        order = np.argsort(cand, kind="stable")
        tgt_sorted = tgt[order]
        first = np.unique(tgt_sorted, return_index=True)[1]
        v, c = tgt_sorted[first], cand[order][first]
        better = c < dist[v]
        dist[v[better]] = c[better]
        frontier = v[better]
    return True, dist


def bc(e, s: int):
    """``(ok, level int64[n], sigma float64[n], delta float64[n])``."""
    ok, level = bfs(e, s)
    sigma = np.zeros(e.n)
    delta = np.zeros(e.n)
    if not ok:
        return ok, level, sigma, delta
    sigma[s] = 1.0
    ls, ld = level[e.src], level[e.dst]
    deepest = int(level.max())
    tree = [np.flatnonzero((ls == l) & (ld == l + 1))
            for l in range(deepest)]
    for l in range(deepest):
        t = tree[l]
        sigma += np.bincount(e.dst[t], weights=sigma[e.src[t]],
                             minlength=e.n)
    for l in range(deepest - 1, -1, -1):
        t = tree[l]
        u, w = e.src[t], e.dst[t]
        delta += np.bincount(u, weights=sigma[u] / sigma[w] * (1.0 + delta[w]),
                             minlength=e.n)
    delta[s] = 0.0
    return ok, level, sigma, delta
