"""``GraphService.bc_scores`` on a directed graph under vertex and arc
churn, held against the plain reference at every version: a scale-7 SSCA#2
R-MAT (``graphbench/generators/rmat_ssca2.py``, as the configuration
``ssca2_s14`` draws it) takes the paper's churn
(``graphbench/streams/paper_churn.py``: PutV, RemV, PutE and RemE a quarter
each, endpoints uniform) one batch a version, and after each commit the
refresh is compared with ``graphbench.reference`` at that version.  The run
goes through a cold refresh, delta refreshes, revived sources and dead
vertices.  The traced records' new fields (``bc_scores``: ``dead``,
``revived_rows``, ``cold_rows``, ``reused_rows``; ``commit``: ``putv``,
``remv``, ``pute``, ``reme``) equal counts made by hand from the same
batches and the reference's graphs, and a refresh without a tracer makes
one host read fewer than the traced one: the read the record's fields
share."""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from graphbench import graphs, traffic  # noqa: E402
from graphbench.reference import bc_all, queries as ref_q  # noqa: E402
from graphbench.reference.graph import Graph  # noqa: E402
from repro_torch.core import from_edge_list  # noqa: E402
from repro_torch.engine import GraphService  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

SCALE = 7
SEED = 2**31 + 33
STEPS = 16
#: scores: the port sums each vertex's dependencies in float32, in another
#: order than the float64 reference; at 128 sources of integer-valued
#: paths the sums stay far inside 1e-5 of (|score| + 1).  Levels and sigma
#: are exact integers.
TOL = 1e-5
KINDS = {traffic.PUTV: "putv", traffic.REMV: "remv", traffic.PUTE: "pute",
         traffic.REME: "reme"}


def _deployment():
    with open(os.path.join(ROOT, "graphbench", "configs",
                           "ssca2_s14.json")) as f:
        cfg = json.load(f)
    cfg.update(scale=SCALE)
    with open(os.path.join(ROOT, "graphbench", "traffic",
                           "paper_churn.json")) as f:
        p = json.load(f)["updates"]
    rngs = traffic.streams(SEED, cfg["data_seed"])
    n, src, dst, w = graphs.draw(cfg, rngs.graph)
    batches = traffic.update_batches(rngs.updates, n, STEPS, p,
                                     graphs.weight_draw(cfg))
    return cfg, n, src, dst, w, batches


def _service(cfg, n, src, dst, w, telemetry=None):
    """The deployment's service, every later refresh on the delta path: at
    128 vertices a batch dirties more than the default threshold's 5%."""
    state = from_edge_list(n, graphs.edge_capacity(cfg, len(src)), src, dst,
                           w, device="cpu")
    return GraphService(state, telemetry=telemetry, dirty_threshold={
        "bc": 1.0}, **{k: int(v) for k, v in cfg["service"].items()})


def _last(records, span):
    (rec,) = [r for r in records if r["span"] == span]
    return rec


def _reached(e, alive, n):
    """bool [n, n]: row s, the vertices source s reaches (none where s is
    not alive)."""
    out = np.zeros((n, n), bool)
    for s in np.flatnonzero(alive):
        out[s] = ref_q.bfs(e, int(s))[1] >= 0
    return out


def _dirty(before, after, alive0, alive1, n):
    """Vertices whose liveness or out-arcs (keys or weights) changed."""
    dirty = alive0 != alive1
    for u, _ in set(before.items()) ^ set(after.items()):
        dirty[u[0]] = True
    return dirty


def _check_against_reference(svc, scores, e):
    want = bc_all.bc_scores(e).numpy()
    got = scores.numpy().astype(np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    assert np.all(np.abs(got[live] - want[live])
                  <= TOL * (np.abs(want[live]) + 1.0))
    level = svc._bc_scores["level"].numpy()
    sigma = svc._bc_scores["sigma"].numpy()
    for s in range(e.n):
        ok, lvl, sig, _ = ref_q.bc(e, s)
        assert np.array_equal(level[s], lvl), s
        assert np.array_equal(sigma[s], sig), s


def test_refresh_under_paper_churn_matches_the_reference_at_every_version():
    cfg, n, src, dst, w, batches = _deployment()
    tel = Telemetry.make(hlo=False, profile=False)
    traced = _service(cfg, n, src, dst, w, telemetry=tel)
    plain = _service(cfg, n, src, dst, w)
    g = Graph(n, src, dst, w)

    plain.bc_scores()
    n0 = len(tel.tracer.records)
    scores, version = traced.bc_scores()
    rec = _last(tel.tracer.records[n0:], "bc_scores")
    assert (rec["mode"], version) == ("full", 0)
    # a cold refresh restarts every row
    assert (rec["dead"], rec["revived_rows"], rec["cold_rows"],
            rec["reused_rows"]) == (int((~g.alive).sum()), 0, n, 0)
    e = g.arrays()
    _check_against_reference(traced, scores, e)

    seen = {"delta": 0, "revived": 0, "cold": 0, "reused": 0, "dead": 0}
    for ops in batches:
        alive0, weights0 = g.alive.copy(), dict(g.weight)
        reached0 = _reached(e, alive0, n)
        n0 = len(tel.tracer.records)
        for svc in (traced, plain):
            svc.submit_many(ops)
            svc.flush()
        commit = _last(tel.tracer.records[n0:], "commit")
        for kind, name in KINDS.items():
            assert commit[name] == sum(op[0] == kind for op in ops), name
        g.apply(ops)
        e = g.arrays()

        with Tracer().span("outer") as outer:
            plain.bc_scores()
        n0 = len(tel.tracer.records)
        scores, version = traced.bc_scores()
        assert version == g.version
        _check_against_reference(traced, scores, e)
        rec = _last(tel.tracer.records[n0:], "bc_scores")
        assert traced.bc_scores_stats == plain.bc_scores_stats
        if rec["mode"] == "unchanged":
            continue
        assert rec["mode"] == "delta"
        # no tracer: the reads of the refresh, less the record's one
        assert outer.counts["host_read"] == rec["host_reads"] - 1

        alive1 = g.alive
        dirty = _dirty(weights0, g.weight, alive0, alive1, n)
        revived = alive1 & ~alive0
        kept = alive1 & alive0 & ~(reached0 & dirty[None, :]).any(axis=1)
        hand = {"dead": int((~alive1).sum()),
                "revived_rows": int(revived.sum()),
                # a source that died (its cut 0) or was revived
                "cold_rows": int((alive0 != alive1).sum()),
                "reused_rows": int(kept.sum())}
        assert {k: rec[k] for k in hand} == hand
        seen["delta"] += 1
        seen["revived"] += hand["revived_rows"]
        seen["cold"] += hand["cold_rows"] - hand["revived_rows"]
        seen["reused"] += hand["reused_rows"]
        seen["dead"] += hand["dead"] > 0
    # every path was taken: delta refreshes, revived and died sources,
    # whole trees reused, and dead vertices at every delta refresh
    assert seen["delta"] >= STEPS // 2
    assert all(seen[k] > 0 for k in ("revived", "cold", "reused")), seen
    assert seen["dead"] == seen["delta"]
