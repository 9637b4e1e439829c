"""Paper-style workload runner: mixed update/search/query streams (the
port's counterpart of ``benchmarks/workload.py``).

Reproduces the experimental protocol of the paper's Section 5: load an
R-MAT graph, run N operations drawn from an {Update, Search, Op}
distribution, measure end-to-end time.  "Concurrency" shows at batch
granularity: while a query SCANs, pending updates from the stream commit
between collects (the ``StateRef.on_read`` hook), producing the paper's
interrupting-update dynamics.

Modes: ``pgcn`` (linearizable), ``pgicn`` (single collect), ``static``
(Ligra-style dense semiring analytics over a frozen snapshot: on a CUDA
graph, the ``bool_mm`` / ``minplus_mm`` kernels).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.core import (
    GETE, GETV, PUTE, PUTV, REME, REMV, StateRef, apply_ops,
    bfs_batched_dense, dense_views, op_inconsistent, op_linearizable,
    sssp_batched_dense,
)
from repro_torch.core.snapshot import COLLECTORS
from repro_torch.data import load_rmat_graph


@dataclass
class MixResult:
    seconds: float
    queries: int = 0
    collects: int = 0
    interrupts: int = 0
    retries_hist: list = field(default_factory=list)
    unvalidated: int = 0  # PG-Cn scans that hit max_collects unmatched


def make_ops(rng, n_ops, n_vertices, dist):
    """dist = (update%, search%, query%) as in the paper's labels."""
    upd, srch, qry = dist
    kinds = rng.choice(3, size=n_ops, p=[upd, srch, qry])
    ops = []
    for k in kinds:
        u = int(rng.integers(0, n_vertices))
        v = int(rng.integers(0, n_vertices))
        if k == 0:
            op = rng.choice([PUTV, REMV, PUTE, REME])
            if op == PUTV:
                ops.append((PUTV, u))
            elif op == REMV:
                ops.append((REMV, u))
            elif op == PUTE:
                ops.append((PUTE, u, v, float(rng.integers(1, 9))))
            else:
                ops.append((REME, u, v))
        elif k == 1:
            ops.append((rng.choice([GETV, GETE]), u, v))
        else:
            ops.append(("QUERY", u))
    return ops


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mix(graph, ops, query: str, mode: str,
            update_batch: int = 8) -> MixResult:
    ref = StateRef(graph)
    pending = [op for op in ops if op[0] != "QUERY"]
    queries = [op for op in ops if op[0] == "QUERY"]
    pos = {"i": 0}

    def interrupt(r):
        i = pos["i"]
        if i < len(pending):
            batch = pending[i:i + update_batch]
            pos["i"] = i + len(batch)
            ns, _ = apply_ops(r.state, batch, batch_size=update_batch)
            r.commit(ns)

    ref.on_read.append(interrupt)
    res = MixResult(0.0)
    dev = graph.device
    _sync(dev)
    t0 = time.perf_counter()
    for q in queries:
        src = q[1]
        if mode == "pgcn":
            _, stats = op_linearizable(ref, query, src)
            res.collects += stats.collects
            res.interrupts += stats.interrupting_updates
            res.retries_hist.append(stats.collects)
            res.unvalidated += not stats.validated
        elif mode == "pgicn":
            _, stats = op_inconsistent(ref, query, src)
            res.collects += stats.collects
        elif mode == "static":
            # Ligra-style: freeze a snapshot, run the parallel dense query
            interrupt(ref)
            am, wd, alive = dense_views(ref.state)
            srcs = torch.tensor([src], dtype=torch.int32, device=dev)
            if query == "bfs":
                bfs_batched_dense(am, srcs, alive)
            elif query == "sssp":
                sssp_batched_dense(wd, srcs, alive)
            else:  # bc via one dense source pass
                COLLECTORS["bc"](ref.state, src)
            _sync(dev)
        res.queries += 1
    # drain the remaining update stream (all modes do the same total work)
    while pos["i"] < len(pending):
        interrupt(ref)
    _sync(dev)
    res.seconds = time.perf_counter() - t0
    return res


def load_graph(n_vertices: int, edge_factor: int = 10, seed: int = 0, *,
               device="cuda"):
    return load_rmat_graph(n_vertices, n_vertices * edge_factor,
                           slack=2.0, seed=seed, device=device)
