"""Whether what the timed path produced is correct: the numbers compared with
the plain reference, each against its limit (``limits/<cell>.json``).

Refresh cells: every flush must commit exactly one version
(``version_gap``), every refresh must be at the version its flush just
committed (``stale_refresh``: refreshes that name another), and the scores
of sampled steps and of the last step must equal the reference's
betweenness of every vertex at the version each names: ``alive_mismatch``
(vertices scored on one side only) and ``bc_score_gap`` (the widest
``|program - reference| / (|reference| + 1)``).

The control stands the reference's answer at a neighbouring version (the
one before, or after for version 0) in the program's place: an answer
exact at another version than it names, which breaks the guarantee every
configuration states.
"""
from __future__ import annotations

import math
import sys

import numpy as np

from .reference import bc_all


def rel_gap(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    d = np.where(same, 0.0, np.abs(got - want) / (np.abs(want) + 1.0))
    d = np.where(np.isnan(d), math.inf, d)
    return float(d.max()) if d.size else 0.0


def neighbour(v: int, last: int) -> int:
    return v - 1 if v > 0 else min(v + 1, last)


def refresh_numbers(graph0, run, rng, p: dict, device,
                    control: bool = False):
    """The refresh cell's numbers over the sampled steps and the last."""
    steps = run.steps
    k = min(int(p["steps"]), max(0, len(steps) - 1))
    pick = sorted(rng.choice(len(steps) - 1, size=k, replace=False).tolist()
                  ) if k else []
    chosen = pick + [len(steps) - 1]
    got = {steps[i][0]: steps[i][1].detach().cpu().numpy() for i in chosen}
    last = len(run.history)
    need = set(got)
    if control:
        need |= {neighbour(v, last) for v in got}
    want = {}
    g = graph0()
    for v in sorted(need):
        while g.version < v:
            g.apply(run.history[g.version])
        want[v] = bc_all.bc_scores(g.arrays(), device=device).cpu().numpy()

    def numbers(pairs):
        out = {"alive_mismatch": 0, "bc_score_gap": 0.0,
               "version_gap": run.version_gaps,
               "stale_refresh": run.stale_refreshes}
        for a, b in pairs:
            out["alive_mismatch"] += int((np.isnan(a) != np.isnan(b)).sum())
            out["bc_score_gap"] = max(out["bc_score_gap"], rel_gap(a, b))
            live = ~np.isnan(b)
            top = float(np.abs(b[live]).max()) if live.any() else 1.0
            diag = float(np.nanmax(np.abs(a - b)) / max(top, 1.0))
            print(f"graphbench: step gap relative to the largest score "
                  f"{diag!r}", file=sys.stderr)
        return out

    mine = numbers([(got[v], want[v]) for v in sorted(got)])
    if control:
        return mine, numbers([(want[neighbour(v, last)], want[v])
                              for v in sorted(got)])
    return mine


def verdict(numbers: dict, limits: dict):
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    has a limit and none is above it (NaN never passes)."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            ok = False
    return ok, checks
