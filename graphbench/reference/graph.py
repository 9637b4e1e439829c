"""A dynamic directed graph with the semantics of the paper's ADT, as the
program's batches apply it.

A committed batch is one version.  Within a batch:

  1. vertex ops (PutV, RemV) take effect first, in order: PutV adds an
     absent vertex, RemV removes a present one;
  2. every vertex removed at any point of the batch loses all its edges,
     in and out (a vertex added again comes back with none);
  3. edge ops (PutE, RemE) then take effect in order, each only where both
     endpoints are present after step 1: PutE sets the edge's weight,
     RemE removes it.

Out-of-range vertices are ignored.  A vertex is present initially iff an
edge of the initial list touches it; duplicated keys keep their last
weight.
"""
from __future__ import annotations

import numpy as np

NOP, PUTV, REMV, PUTE, REME = 0, 1, 2, 3, 4


class Graph:
    def __init__(self, n: int, src, dst, w):
        self.n = n
        self.alive = np.zeros(n, bool)
        self.weight = {}
        self.out = [set() for _ in range(n)]
        self.inc = [set() for _ in range(n)]
        for u, v, x in zip(np.asarray(src).tolist(), np.asarray(dst).tolist(),
                           np.asarray(w, np.float64).tolist()):
            self.weight[(u, v)] = x
            self.out[u].add(v)
            self.inc[v].add(u)
            self.alive[u] = self.alive[v] = True
        self.version = 0

    def _drop_vertex_edges(self, u: int) -> None:
        for v in self.out[u]:
            del self.weight[(u, v)]
            self.inc[v].discard(u)
        for s in self.inc[u]:
            del self.weight[(s, u)]
            self.out[s].discard(u)
        self.out[u] = set()
        self.inc[u] = set()

    def apply(self, ops) -> None:
        """Commit one batch of ``(kind, u[, v[, w]])`` ops."""
        n = self.n
        removed = []
        for op in ops:
            kind, u = op[0], op[1]
            if kind not in (PUTV, REMV) or not 0 <= u < n:
                continue
            if kind == PUTV:
                self.alive[u] = True
            elif self.alive[u]:
                self.alive[u] = False
                removed.append(u)
        for u in removed:
            self._drop_vertex_edges(u)
        for op in ops:
            kind = op[0]
            if kind not in (PUTE, REME):
                continue
            u, v = op[1], op[2]
            if not (0 <= u < n and 0 <= v < n and self.alive[u]
                    and self.alive[v]):
                continue
            if kind == PUTE:
                self.weight[(u, v)] = float(op[3])
                self.out[u].add(v)
                self.inc[v].add(u)
            elif (u, v) in self.weight:
                del self.weight[(u, v)]
                self.out[u].discard(v)
                self.inc[v].discard(u)
        self.version += 1

    def arrays(self) -> "Edges":
        """The live edges as arrays grouped by source (CSR)."""
        m = len(self.weight)
        keys = np.fromiter((k for kv in self.weight for k in kv),
                           np.int64, 2 * m).reshape(m, 2)
        w = np.fromiter(self.weight.values(), np.float64, m)
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        src, dst, w = keys[order, 0], keys[order, 1], w[order]
        indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=self.n), out=indptr[1:])
        return Edges(self.n, self.alive.copy(), src, dst, w, indptr)


class Edges:
    """A version's live edges: ``src`` sorted, ``indptr`` its CSR index."""

    def __init__(self, n, alive, src, dst, w, indptr):
        self.n, self.alive = n, alive
        self.src, self.dst, self.w, self.indptr = src, dst, w, indptr

    def out_edges(self, frontier: np.ndarray) -> np.ndarray:
        """Indices of the edges leaving ``frontier``."""
        starts = self.indptr[frontier]
        lens = self.indptr[frontier + 1] - starts
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        offs = np.repeat(starts - np.cumsum(lens) + lens, lens)
        return offs + np.arange(total)
