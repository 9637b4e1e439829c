"""Traffic drawn from seeds: update batches, as a traffic file's parameters
describe them.

A traffic file's ``updates.stream`` names the stream,
``streams/<stream>.py``, whose ``batches(rng, n, n_batches, p, weight,
base)`` draws the batches from the parameters ``p`` (the file's
``updates``), an inserted edge's weight by ``weight(rng, size)`` (the
configuration's ``weights/<weights>.py``).  The configuration's
``directed`` governs the initial graph only: a stream's inserts are the
stream's own.

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

from . import spec

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


def update_batches(rng, n: int, n_batches: int, p: dict, weight,
                   base: int = 0, order=None, root: str = spec.HOME):
    """``n_batches`` batches of the stream ``p["stream"]`` names
    (``streams/<stream>.py``'s ``batches``), in the order ``order`` draws."""
    stream = spec.load_module(root, "streams", p["stream"])
    return permuted(stream.batches(rng, n, n_batches, p, weight, base), order)
