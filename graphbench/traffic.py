"""Traffic drawn from seeds: update batches, as a traffic file's parameters
describe them.

Every run of a cell offers the same work in another order.  The
configuration's ``data_seed`` draws the deployment's data: the initial
graph, the hot set and the update batches.  The run's ``--seed`` draws the
order in which the batches commit, and the sample the check compares.  A
seed that changed the graph or the hot set changed the work a run measures
by several percent.

Op codes are the program's batch interface (``repro_torch.core.updates``):
the harness checks them against the program at set-up.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NOP, PUTV, REMV, PUTE, REME = 0, 1, 2, 3, 4


@dataclass
class Streams:
    """Independent generators: the data's (from the configuration's
    ``data_seed``) and the run's (from ``--seed``)."""

    graph: object
    updates: object
    hot: object
    order: object
    check: object


def streams(seed: int, data_seed: int) -> Streams:
    # children are fixed by their index: graph 0, updates 1, hot set 4
    data = np.random.SeedSequence(int(data_seed)).spawn(5)
    run = np.random.SeedSequence(int(seed)).spawn(2)
    return Streams(*(np.random.default_rng(s)
                     for s in (data[0], data[1], data[4], *run)))


def permuted(items, order):
    """``items`` in the order ``order`` (a generator) draws, or as they
    are when it is ``None``."""
    if order is None:
        return list(items)
    return [items[i] for i in order.permutation(len(items))]


def hot_size(n: int, p: dict) -> int:
    return max(2, int(n * p.get("hot_frac", 0.0)))


def hot_base(rng, n: int, p: dict) -> int:
    """Where the contiguous hot set starts: one draw per deployment."""
    return int(rng.integers(0, max(1, n - hot_size(n, p))))


def hot_churn(rng, n: int, n_batches: int, p: dict, weight, base: int):
    """Edge churn on the contiguous hot set of ``hot_frac * n`` sources at
    ``base``: ``pute_share`` PutE, the rest RemE, the other endpoint uniform
    (``chip_smoke.commit_stream``'s draw); an inserted edge's weight is
    drawn as the deployment draws its edges' (``weight(rng, size)``)."""
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


UPDATE_STREAMS = {"hot_churn": hot_churn}


def update_batches(rng, n: int, n_batches: int, p: dict, weight,
                   base: int = 0, order=None):
    return permuted(UPDATE_STREAMS[p["stream"]](rng, n, n_batches, p, weight,
                                                base), order)
