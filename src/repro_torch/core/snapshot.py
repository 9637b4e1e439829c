"""PANIGRAHAM snapshots: multi-collect validation (OP / SCAN / CMPTREE)
(port of ``repro.core.snapshot``).

The paper's interface operation OP(v):

    1. validate the query vertex is alive;
    2. SCAN: repeatedly TREECOLLECT partial snapshots until two
       *consecutive* collects compare equal (CMPTREE over (vertex set,
       parents, ecnt));
    3. the matched collect is linearizable.

A TREECOLLECT is one query over one committed state version;
"interrupting updates" are the batches committed between collects (by a
workload harness through ``StateRef.on_read``).  CMPTREE compares the
reached vertex set (vertex added/removed), the traversal-tree parents
(path changed), the per-vertex ``ecnt`` of the region (edge removed and
re-added: the ABA case version counters exist for) and the payloads.  The
global ``version`` is deliberately not compared: an update outside the
query's region must not invalidate it.

Execution modes (paper section 5):
    * PG-Cn  -- linearizable: double-collect until match;
    * PG-Icn -- single collect, no validation (best-effort consistency).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import torch

from . import queries
from .graph_state import NOKEY, GraphState
from .updates import OpBatch, apply_batch


class Collect(NamedTuple):
    """One TREECOLLECT: a query result + its validation vector."""
    result: object          # BFSResult | SSSPResult | BCResult
    reached: torch.Tensor   # bool[vcap]  snapshot region
    parent: torch.Tensor    # int32[vcap] traversal tree (NOKEY outside it)
    ecnt: torch.Tensor      # int32[vcap] ecnt masked to the region
    payload: torch.Tensor   # f32[vcap]   dist/delta masked to the region


def cmp_tree(a: Collect, b: Collect) -> bool:
    """The paper's CMPTREE: equality of region, tree, ecnt (and payloads)."""
    return (torch.equal(a.reached, b.reached)
            and torch.equal(a.parent, b.parent)
            and torch.equal(a.ecnt, b.ecnt)
            and torch.equal(a.payload, b.payload))


# ----------------------------- collectors --------------------------------

def collect_bfs(state: GraphState, src) -> Collect:
    r = queries.bfs(state, src)
    m = r.reached
    return Collect(
        result=r,
        reached=m,
        parent=torch.where(m, r.parent, NOKEY),
        ecnt=torch.where(m, state.ecnt, 0),
        payload=torch.where(m, r.dist.float(), 0.0),
    )


def collect_sssp(state: GraphState, src) -> Collect:
    r = queries.sssp(state, src)
    m = r.dist < float("inf")
    return Collect(
        result=r,
        reached=m,
        parent=torch.where(m, r.parent, NOKEY),
        ecnt=torch.where(m, state.ecnt, 0),
        payload=torch.where(m, r.dist, 0.0) + r.negcycle.float(),
    )


def collect_bc(state: GraphState, src) -> Collect:
    r = queries.bc_dependencies(state, src)
    m = r.level >= 0
    return Collect(
        result=r,
        reached=m,
        parent=torch.where(m, r.level, NOKEY),  # levels play the tree
        ecnt=torch.where(m, state.ecnt, 0),
        payload=torch.where(m, r.delta + r.sigma, 0.0),
    )


COLLECTORS: dict[str, Callable] = {
    "bfs": collect_bfs,
    "sssp": collect_sssp,
    "bc": collect_bc,
}


# ------------------------------ OP operations ------------------------------

@dataclass
class ScanStats:
    """Per-query statistics mirroring the paper's Fig 12/13."""
    collects: int = 0               # TREECOLLECT invocations in the SCAN
    interrupting_updates: int = 0   # committed batches during the query
    validated: bool = True


@dataclass
class StateRef:
    """Mutable cell holding the latest committed state (the 'shared heap').

    The update stream commits new versions into the ref; queries read
    whatever version is current at each collect -- how "concurrency"
    shows at batch granularity.  ``on_read`` callbacks run before every
    read (a harness commits its interrupting updates there).
    """
    state: GraphState
    commits: int = 0
    on_read: list = field(default_factory=list)

    def commit(self, new_state: GraphState) -> None:
        self.state = new_state
        self.commits += 1

    def read(self) -> GraphState:
        for cb in self.on_read:
            cb(self)
        return self.state


def _src_alive(state: GraphState, src) -> bool:
    src_i = int(src)
    return 0 <= src_i < state.vcap and bool(state.alive[src_i])


def op_linearizable(ref: StateRef, query: str, src, max_collects: int = 64):
    """PG-Cn: the paper's OP -- double-collect until CMPTREE matches.

    Returns ``(Collect | None, ScanStats)``.  None when the source vertex is
    not alive at the first read (the paper's NULL return).
    """
    coll = COLLECTORS[query]
    stats = ScanStats()
    commits0 = ref.commits

    state = ref.read()
    if not _src_alive(state, src):
        stats.interrupting_updates = ref.commits - commits0
        return None, stats

    prev = coll(state, src)
    stats.collects = 1
    while stats.collects < max_collects:
        cur = coll(ref.read(), src)
        stats.collects += 1
        if cmp_tree(prev, cur):
            stats.interrupting_updates = ref.commits - commits0
            return cur, stats
        prev = cur
    stats.validated = False
    stats.interrupting_updates = ref.commits - commits0
    return prev, stats


def op_inconsistent(ref: StateRef, query: str, src):
    """PG-Icn: single collect, no validation (the throughput/consistency
    dial)."""
    state = ref.read()
    if not _src_alive(state, src):
        return None, ScanStats(collects=0, validated=False)
    return COLLECTORS[query](state, src), ScanStats(collects=1,
                                                    validated=False)


def op_linearizable_jit(state: GraphState, batches: OpBatch, src,
                        max_collects: int = 32):
    """The whole PG-Cn OP with its update commits as one loop.

    The reference runs this inside one jitted ``lax.while_loop`` (no host
    round trip per collect); eager PyTorch runs the same loop on the host,
    reading the CMPTREE flag once per collect.  ``batches`` is a stacked
    ``OpBatch`` (leading axis = pending update batches) committed one per
    collect, modelling the paper's concurrent updaters; past the last
    batch the state stays as it is.  Returns ``(final_state, Collect,
    collects_used, validated)``.
    """
    n_batches = batches.kind.shape[0]
    st, prev = state, collect_bfs(state, src)
    collects, matched = 1, False
    while not matched and collects < max_collects:
        i = collects - 1
        if i < n_batches:  # an "interrupting" update
            st, _, _ = apply_batch(st, OpBatch(*(x[i] for x in batches)))
        cur = collect_bfs(st, src)
        matched = cmp_tree(prev, cur)
        prev, collects = cur, collects + 1
    return st, prev, collects, matched
