"""Edge churn on a contiguous hot set of ``hot_frac * n`` sources at
``base``: ``pute_share`` PutE, the rest RemE, the other endpoint uniform
(``chip_smoke.commit_stream``'s draw), ``ops_per_batch`` ops a batch.

An inserted edge's weight is drawn as the deployment draws its edges'
(``weight(rng, size)``).  Each PutE inserts one direction, ``u -> v``, as
the paper's PutE does: the configuration's ``directed`` governs the initial
graph only, and a stream's inserts are the stream's own.
"""
from graphbench.traffic import PUTE, REME, hot_size


def batches(rng, n: int, n_batches: int, p: dict, weight, base: int):
    size = hot_size(n, p)
    out = []
    for _ in range(n_batches):
        ops = []
        for _ in range(int(p["ops_per_batch"])):
            u = base + int(rng.integers(0, size))
            v = int(rng.integers(0, n))
            if rng.random() < p["pute_share"]:
                ops.append((PUTE, u, v, float(weight(rng, 1)[0])))
            else:
                ops.append((REME, u, v))
        out.append(ops)
    return out
