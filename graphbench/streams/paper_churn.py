"""Vertex and arc churn over every vertex, as the paper's Section 5 draws an
update (``repro_torch.bench.workload.make_ops``): each op is PutV, RemV,
PutE or RemE with the shares ``putv_share``, ``remv_share``,
``pute_share`` and ``reme_share``, its endpoints uniform over ``[0, n)``;
``ops_per_batch`` ops a batch.

An inserted arc's weight is drawn as the deployment draws its arcs'
(``weight(rng, size)``); PutE inserts ``u -> v`` alone.  A removed vertex
loses its arcs, and one put back comes back with none.  There is no hot
set: ``base`` is not read.  Shares that do not sum to 1 are refused.
"""
import numpy as np

from graphbench.traffic import PUTE, PUTV, REME, REMV

KINDS = (PUTV, REMV, PUTE, REME)
SHARES = ("putv_share", "remv_share", "pute_share", "reme_share")


def batches(rng, n: int, n_batches: int, p: dict, weight, base: int):
    shares = [float(p[k]) for k in SHARES]
    if abs(sum(shares) - 1.0) > 1e-9:
        raise ValueError(f"the shares {dict(zip(SHARES, shares))} do not "
                         f"sum to 1")
    bounds = np.cumsum(shares)[:-1]
    out = []
    for _ in range(n_batches):
        ops = []
        for _ in range(int(p["ops_per_batch"])):
            kind = KINDS[int(np.searchsorted(bounds, rng.random(),
                                             side="right"))]
            u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
            if kind == PUTE:
                ops.append((PUTE, u, v, float(weight(rng, 1)[0])))
            elif kind == REME:
                ops.append((REME, u, v))
            else:
                ops.append((kind, u))
        out.append(ops)
    return out
