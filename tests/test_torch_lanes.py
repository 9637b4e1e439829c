"""Lane forms of the port's queries (``repro_torch.core.queries.*_lanes``,
``repro_torch.engine.incremental.delta_*_lanes``): L single-source queries
in one loop.

Each lane must equal the port's single-source call on its inputs bit for
bit (every field, BC ``delta`` included), and the reference's ``jax.vmap``
of the single-source function on the same state: bit-exact for BFS/SSSP
and BC ``level``/``sigma``, BC ``delta`` within the reference's own
1e-5.  The lanes cover padding (lane 0 repeated), a dead source, sources
out of range on both sides, lanes with different level cuts and priors
from different versions, and lanes that find a negative cycle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import queries as jq
from repro.engine import incremental as jinc
import repro_torch.core as tc
from repro_torch.core import queries as tq
from repro_torch.engine import incremental as tinc

VCAP, ECAP = 48, 256
TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ("bfs", "sssp", "bc")
SINGLE = {"bfs": tq.bfs, "sssp": tq.sssp, "bc": tq.bc_dependencies}
LANES = {"bfs": tq.bfs_lanes, "sssp": tq.sssp_lanes,
         "bc": tq.bc_dependencies_lanes}
REF = {"bfs": jq.bfs, "sssp": jq.sssp, "bc": jq.bc_dependencies}
DEAD = 5


#: a side component 40 -> 41 -> 40 fed by 42, whose cycle turns
#: negative in the first churn commit of a ``neg`` graph
SIDE = [(jc.PUTV, 40), (jc.PUTV, 41), (jc.PUTV, 42), (jc.PUTE, 40, 41, 1.0),
        (jc.PUTE, 41, 40, 1.0), (jc.PUTE, 42, 40, 1.0)]


def _ops(rng, n, m, neg):
    ops = [(jc.PUTV, i) for i in range(n)] + SIDE
    for _ in range(m):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        w = -1.0 if neg and float(rng.random()) < 0.12 else \
            float(rng.integers(1, 6))
        ops.append((jc.PUTE, u, v, w))
    return ops + [(jc.REMV, DEAD)]


def _churn(rng, n, count):
    ops = []
    for _ in range(count):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        ops.append((jc.REME, u, v) if float(rng.random()) < 0.3
                   else (jc.PUTE, u, v, float(rng.integers(1, 6))))
    return ops


def _port(jstate):
    return tc.state_from_numpy(*map(np.asarray, jstate), device="cpu")


def _graphs(seed, neg):
    """Three successive reference snapshots (base, then two churn commits
    that also kill and revive vertices) and the port's copies."""
    rng = np.random.default_rng(seed)
    n = 36
    g0, _ = jc.apply_ops(jc.make_graph(VCAP, ECAP), _ops(rng, n, 110, neg))
    born = [(jc.PUTE, 40, 41, -2.0)] if neg else []
    g1, _ = jc.apply_ops(g0, _churn(rng, n, 6) + [(jc.REMV, 9)] + born)
    g2, _ = jc.apply_ops(g1, _churn(rng, n, 6) + [(jc.PUTV, DEAD)])
    return [g0, g1, g2], [_port(g) for g in (g0, g1, g2)]


#: lane sources: hubs, a dead source, out of range on both sides, the
#: side component, and lane 0 repeated at the end (the dispatcher's
#: padding)
SRCS = [0, 3, DEAD, VCAP + 7, -1, 17, 42, 30, 0, 0]


def _assert_lanes_equal(kind, out, singles, ctx):
    for i, ref in enumerate(singles):
        for name, got, exp in zip(type(ref)._fields, out, ref):
            assert torch.equal(got[i], exp), (ctx, kind, i, name)


def _assert_matches_reference(kind, out, jout, ctx):
    for name, got, exp in zip(type(out)._fields, out, jout):
        exp = np.asarray(exp)
        if name == "delta":
            np.testing.assert_allclose(got.numpy(), exp, err_msg=str(ctx),
                                       **TOL)
        else:
            assert np.array_equal(got.numpy(), exp), (ctx, kind, name)


@pytest.mark.parametrize("neg", [False, True], ids=["pos", "neg"])
@pytest.mark.parametrize("kind", KINDS)
def test_full_lanes_equal_single_source_and_vmap(kind, neg):
    jgs, tgs = _graphs(7, neg)
    state = tgs[-1]
    srcs = torch.tensor(SRCS, dtype=torch.int32)
    out = LANES[kind](state, srcs)
    assert all(x.shape[0] == len(SRCS) for x in out)
    _assert_lanes_equal(kind, out, [SINGLE[kind](state, s) for s in SRCS],
                        ("full", neg))
    jout = jax.vmap(REF[kind], in_axes=(None, 0))(
        jgs[-1], jnp.asarray(SRCS, jnp.int32))
    _assert_matches_reference(kind, out, jout, ("full", neg))
    if kind == "sssp" and neg:
        assert bool(out.negcycle.any()) and not bool(out.negcycle.all()), \
            "the lanes must mix negative-cycle and clean sources"


def _stack(results):
    return type(results[0])(*(torch.stack(list(xs)) for xs in
                              zip(*results)))


def _to_jax(result):
    return type(result)(*(jnp.asarray(x.numpy()) for x in result))


def _delta_inputs(kind, tgs):
    """Per lane: a prior computed at version 0 or 1 (alternating), the
    OR of the dirty sets since, and its source; BC lanes keep only
    sources whose level cut is >= 1 (the ladder's gate) and carry it."""
    state = tgs[-1]
    dirt = [tc.dirty_vertices(tgs[0], tgs[1]), tc.dirty_vertices(tgs[1],
                                                                 tgs[2])]
    lanes = []
    for i, src in enumerate(s for s in SRCS if 0 <= s < VCAP):
        v = i % 2
        prior = SINGLE[kind](tgs[v], src)
        if not bool(prior.ok):
            continue
        dirty = dirt[1] if v == 1 else dirt[0] | dirt[1]
        cut = None
        if kind == "bc":
            cut = int(tq.bc_level_cut(prior.level, dirty, state.alive))
            if cut < 1:
                continue
        lanes.append((src, prior, dirty, cut))
    assert len(lanes) >= 3, "too few usable lanes for the delta check"
    return lanes


@pytest.mark.parametrize("neg", [False, True], ids=["pos", "neg"])
@pytest.mark.parametrize("kind", KINDS)
def test_delta_lanes_equal_single_source_and_vmap(kind, neg):
    jgs, tgs = _graphs(11, neg)
    state = tgs[-1]
    lanes = _delta_inputs(kind, tgs)
    lanes = lanes + lanes[:1]  # a padding lane
    srcs = torch.tensor([ln[0] for ln in lanes], dtype=torch.int32)
    priors = _stack([ln[1] for ln in lanes])
    if kind == "bc":
        third = torch.tensor([ln[3] for ln in lanes], dtype=torch.int32)
        out = tinc.delta_bc_at_cut_lanes(state, priors, third, srcs)
        singles = [tinc._delta_bc_at_cut(state, p, c, s)
                   for s, p, _, c in lanes]
        ref = jinc._delta_bc_at_cut
        assert len(set(third.tolist())) > 1, "the lanes' cuts must differ"
    else:
        third = torch.stack([ln[2] for ln in lanes])
        fn = {"bfs": tinc.delta_bfs_lanes, "sssp": tinc.delta_sssp_lanes}
        out = fn[kind](state, priors, third, srcs)
        one = {"bfs": tinc.delta_bfs, "sssp": tinc.delta_sssp}[kind]
        singles = [one(state, p, d, s) for s, p, d, _ in lanes]
        ref = {"bfs": jinc.delta_bfs, "sssp": jinc.delta_sssp}[kind]
    _assert_lanes_equal(kind, out, singles, ("delta", neg))
    jout = jax.vmap(ref, in_axes=(None, 0, 0, 0))(
        jgs[-1], _to_jax(priors), jnp.asarray(third.numpy()),
        jnp.asarray(srcs.numpy()))
    _assert_matches_reference(kind, out, jout, ("delta", neg))
    # where the delta rung's answer stands (no negative cycle: the ladder
    # re-runs those lanes full), it is the full answer
    stands = ~out.negcycle if kind == "sssp" else torch.ones(len(lanes),
                                                             dtype=bool)
    for i, (src, *_) in enumerate(lanes):
        full = SINGLE[kind](state, src)
        for name, got, exp in zip(type(full)._fields, out, full):
            assert not stands[i] or torch.equal(got[i], exp), \
                (kind, src, name)
    if kind == "sssp" and neg:
        assert bool(out.negcycle.any()), "no lane met the born cycle"


def test_lane_segment_sum_matches_single_source_sum():
    """The lane sum pads each row to a multiple of 32 edges with one extra
    segment and drops it: every (lane, vertex) sum equals the
    single-source segment sum bit for bit, at edge counts on both sides
    of the padding."""
    rng = np.random.default_rng(3)
    for n_edges in (0, 1, 31, 32, 33, 95):
        idx = torch.as_tensor(rng.integers(0, 12, n_edges))
        seg = tq._segments(idx, 12, grouped=False)
        vals = torch.as_tensor(rng.standard_normal((5, n_edges)),
                               dtype=torch.float32)
        lane = tq._lane_segments(seg, 5, n_edges)
        got = lane.sum(vals)
        assert got.shape == (5, 12)
        for i in range(5):
            assert torch.equal(got[i], seg.sum(vals[i])), (n_edges, i)
