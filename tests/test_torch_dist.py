"""The sharded engine across processes (``repro_torch.shard.dist``): four
gloo ranks on the CPU, started by ``repro_torch.shard.spawn``.

The rank bodies live in ``tests/dist_ranks.py`` (module level, so spawn
can pickle them; that module imports no JAX).  Each process runs the same
calls; what it returns is compared here:

  * against ``ThreadGroup`` on ``GraphMesh(["cpu"] * 4)`` in this
    process: views, cold and delta BFS/SSSP/BC in both ``bc_mode``s, the
    collectives and their byte counts -- bit for bit, BC ``delta`` and
    ``scores`` included (both groups reduce in rank order);
  * against the reference on four placeholder devices
    (``conftest.run_multidevice``, a JAX subprocess writing ``.npz``):
    levels, sigma and distances exact, BC ``delta`` / ``scores`` to
    ``rtol = atol = 1e-5``;
  * across ranks: the streaming service's replies equal the local
    ``GraphService``'s on every rank, and its rung tallies agree, with
    the breaker, chaos with journaled recovery, and adaptive thresholds
    driven apart.

Every spawn has a join timeout; the mesh's timeout bounds each
collective.
"""
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.data import load_rmat_graph
import repro_torch.core as tc
import repro_torch.shard as ts

import dist_ranks as dr
from conftest import run_multidevice

N_RANKS = 4
TOL = dict(rtol=1e-5, atol=1e-5)
TILE = dr.TILE
MESH_TIMEOUT = 30.0
JOIN = 240.0     # seconds a spawn of four ranks may take in all
SRCS = [0, 1, 7, 33, 12, 63, 5, 2, 200, 255]
CLOSE = ("delta", "scores")


def _spawn(fn, *args, timeout=MESH_TIMEOUT):
    return ts.spawn(fn, N_RANKS, device="cpu", transport="gloo",
                    timeout=timeout, join_timeout=JOIN, args=args)


def _graph():
    """test_torch_shard's graph: R-MAT(256, 2000, seed 3) with tombstones
    and two dead vertices, as numpy arrays of the state's six leaves."""
    g = load_rmat_graph(256, 2000, seed=3)
    g, _ = jc.apply_ops(g, [(jc.REME, int(g.esrc[5]), int(g.edst[5])),
                            (jc.REME, int(g.esrc[40]), int(g.edst[40])),
                            (jc.REMV, 7), (jc.REMV, 33)])
    ops = [(jc.PUTE, 0, 140, 2.0), (jc.REME, 1, int(g.edst[20])),
           (jc.PUTE, 20, 155, 1.0), (jc.REMV, 12), (jc.PUTE, 147, 18, 3.0),
           (jc.PUTE, 230, 3, 1.0)]
    return [np.asarray(x) for x in g], ops


def _thread_mesh():
    return ts.GraphMesh(["cpu"] * N_RANKS)


def _assert_fields(got: dict, want: dict, ctx, exact=True):
    assert got.keys() == want.keys(), ctx
    for f in got:
        a, b = got[f], want[f]
        assert a.shape == b.shape, (ctx, f)
        if f in CLOSE and not exact:
            np.testing.assert_allclose(a, b, err_msg=str((ctx, f)), **TOL)
        else:
            assert np.array_equal(a, b), (ctx, f)


# ------------------------------- the group --------------------------------

def test_transport_is_named():
    with pytest.raises(ValueError, match="transport"):
        ts.DistMesh(0, 1, "file:///nonexistent", transport="mpi",
                    device="cpu")
    with pytest.raises(ValueError, match="one card per rank"):
        ts.DistMesh(0, 1, "file:///nonexistent", transport="nccl",
                    device="cpu")


def test_group_matches_thread_group():
    """Rank-ordered float sums bit-equal to ThreadGroup's, host scalars,
    gathers, a ppermute with zeros where no rank sends, the merge and the
    control message; byte counts equal ThreadGroup's."""
    rng = np.random.default_rng(0)
    xs = [torch.tensor(rng.standard_normal(7) * 10.0 ** rng.integers(-3, 4, 7),
                       dtype=torch.float32) for _ in range(N_RANKS)]
    perm = [(0, 1), (1, 2), (2, 3)]          # nobody sends to rank 0
    outs = _spawn(dr.group_ops, xs, perm)
    mesh = _thread_mesh()
    tg = ts.ThreadGroup(mesh)

    def body(g, x):
        return {"psum": g.psum(x), "pmax": g.pmax(x),
                "psum_host": g.psum(float(x[0])),
                "pmax_host": g.pmax(int(g.axis_index())),
                "flag": g.pmax(g.axis_index() == 2),
                "tiled": g.all_gather(x),
                "stacked": g.all_gather(x, tiled=False),
                "permute": g.ppermute((x, x.to(torch.int32)), perm)}

    want = tg.run(body, [(x,) for x in xs])
    for r, out in enumerate(outs):
        assert out["rank"] == r and out["size"] == N_RANKS
        assert out["devices"] == ["cpu"] * N_RANKS
        for key in ("psum", "pmax", "tiled", "stacked"):
            assert torch.equal(out[key], want[r][key]), (r, key)
        for key in ("psum_host", "pmax_host", "flag"):
            assert out[key] == want[r][key], (r, key)
            assert type(out[key]) is type(want[r][key]), (r, key)
        for a, b in zip(out["permute"], want[r]["permute"]):
            assert torch.equal(a, b) and a.dtype == b.dtype, r
        assert torch.equal(out["merge"],
                           torch.cat([x[:2] for x in xs]))
        assert out["control"] == ["rank", 0]
        assert out["long"] == {"rank": 0, "n": list(range(20000))}
        assert out["bytes"] == tg.bytes and out["calls"] == tg.calls, r
        # the merge and the control message are moved, never counted
        assert "merge" not in out["bytes"] and out["moved"]["merge"] > 0
    assert not outs[0]["permute"][0].any()   # zeros where no rank sends
    # the float sum in rank order, bit for bit
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    assert torch.equal(outs[3]["psum"], acc)


@pytest.mark.parametrize("how", ["raise", "kill", "out_of_step"])
def test_failure_reaches_every_rank(how):
    """A rank that raises, whose process dies, or that falls out of step
    (another op on a payload of the same size: the header check) fails
    every other rank well within a 10 s mesh timeout: no rank hangs."""
    with pytest.raises(ts.SpawnError) as ei:
        _spawn(dr.failing_rank, how, timeout=10.0)
    codes = ei.value.exitcodes
    assert None not in codes, codes                  # none was killed
    assert all(c != 0 for c in codes), codes
    errors = ei.value.errors
    if how == "raise":
        assert "rank 2 fails on purpose" in errors[2]
    if how == "out_of_step":
        assert "fell out of step" in errors[2], errors[2]
    for r in (0, 1, 3):
        assert "RankFailure" in errors[r], errors[r]


def test_body_failure_reaches_every_rank():
    arrays, _ = _graph()
    with pytest.raises(ts.SpawnError) as ei:
        _spawn(dr.failing_body, arrays, timeout=10.0)
    codes, errors = ei.value.exitcodes, ei.value.errors
    assert None not in codes and all(c != 0 for c in codes), codes
    assert "rank 1's body fails on purpose" in errors[1]
    for r in (0, 2, 3):
        assert "RankFailure" in errors[r], errors[r]


def test_front_end_metrics_and_journal_are_rank_zeros():
    arrays, _ = _graph()
    outs = _spawn(dr.front_end_on_mesh, arrays)
    for r, out in enumerate(outs):
        assert out["same_mesh"]
        assert out["front_end"].startswith("built"), out["front_end"]
        if r:
            assert "rank 0 admits" in out["refused"], out["refused"]
        assert out["metrics"] == (r == 0)
        if r:
            assert "only rank 0 journals" in out["journal"]


# --------------------------- views and queries ----------------------------

@pytest.fixture(scope="module")
def dist_views():
    arrays, ops = _graph()
    return arrays, ops, _spawn(dr.views_and_queries, arrays, SRCS, ops)


@pytest.fixture(scope="module")
def thread_views(dist_views):
    """The same calls on ThreadGroup in this process."""
    arrays, ops, _ = dist_views
    state = tc.state_from_numpy(*arrays, device="cpu")
    return dr.query_set(_thread_mesh(), state, SRCS, ops)


def test_each_process_holds_one_band(dist_views):
    *_, outs = dist_views
    for r, out in enumerate(outs):
        want = [i == r for i in range(N_RANKS)]
        assert out["slots"] == want and out["occ_slots"] == want
        assert out["refreshed_slots"] == want
        vp = out["vp"]
        assert out["band_shape"] == (vp // N_RANKS, vp) == (
            out["band"], vp)
        assert out["rows_per_shard"] == vp // (N_RANKS * TILE)


def test_views_match_thread_group(dist_views, thread_views):
    *_, outs = dist_views
    for out in outs:
        assert out["stats"] == thread_views["stats"]
        for key in ("gathered", "refreshed"):
            for a, b in zip(out[key], thread_views[key]):
                assert np.array_equal(a, b), key


@pytest.mark.parametrize("phase", ["cold", "delta"])
def test_queries_match_thread_group(dist_views, thread_views, phase):
    """Bit for bit, BC delta and scores included, on every rank."""
    *_, outs = dist_views
    for r, out in enumerate(outs):
        for kind, want in thread_views[phase].items():
            _assert_fields(out[phase][kind], want, (r, phase, kind))


def test_collective_bytes_match_thread_group(dist_views, thread_views):
    """The same op names, calls and bytes per kind as ThreadGroup (so
    ``collective_bytes`` is the same under both groups); what the transport
    moved is counted apart, n x the operand for a reduction."""
    *_, outs = dist_views
    for out in outs:
        for kind, (nbytes, calls, _) in thread_views["counts"].items():
            got_bytes, got_calls, moved = out["counts"][kind]
            assert (got_bytes, got_calls) == (nbytes, calls), kind
            if "all-reduce" in nbytes:
                assert moved["all-reduce"] > nbytes["all-reduce"], kind
        assert out["moved"]["merge"] > 0 and out["moved"]["control"] > 0


_REFERENCE = """
import numpy as np
import repro.core as jc
from repro.core.updates import dirty_vertices
from repro.data import load_rmat_graph
import repro.shard as js

mesh = js.as_graph_mesh()
assert mesh.devices.size == 4
g = load_rmat_graph(256, 2000, seed=3)
g, _ = jc.apply_ops(g, [(jc.REME, int(g.esrc[5]), int(g.edst[5])),
                        (jc.REME, int(g.esrc[40]), int(g.edst[40])),
                        (jc.REMV, 7), (jc.REMV, 33)])
ops = [(jc.PUTE, 0, 140, 2.0), (jc.REME, 1, int(g.edst[20])),
       (jc.PUTE, 20, 155, 1.0), (jc.REMV, 12), (jc.PUTE, 147, 18, 3.0),
       (jc.PUTE, 230, 3, 1.0)]
srcs = np.asarray(SRCS, np.int32)
view = js.build_sharded_view(g, mesh, tile=TILE)
p = dict(bfs=js.bfs(view, g, srcs), sssp=js.sssp(view, g, srcs))
for m in ("gather", "ring"):
    p["bc_" + m] = js.bc_batched(view, g, srcs, src_chunk=3, bc_mode=m)
g2, _ = jc.apply_ops(g, ops)
d = dirty_vertices(g, g2)
view = js.refresh_sharded_view(g2, view, d)
r = dict(bfs=js.delta_bfs_sharded(view, g2, p["bfs"], d, srcs),
         sssp=js.delta_sssp_sharded(view, g2, p["sssp"], d, srcs))
for m in ("gather", "ring"):
    r["bc_" + m] = js.delta_bc_sharded(view, g2, p["bc_" + m], d, srcs,
                                       src_chunk=3, bc_mode=m)
res = {}
for tag, group in (("cold", p), ("delta", r)):
    for k, v in group.items():
        for f, x in zip(type(v)._fields, v):
            res[tag + "/" + k + "/" + f] = np.asarray(x)
np.savez(OUT, **res)
"""


def test_queries_match_reference_on_four_devices(dist_views, tmp_path):
    """The reference's four-device program and the port's four processes:
    levels, sigma and distances exact, BC delta and scores to 1e-5."""
    out_path = tmp_path / "ref.npz"
    run_multidevice(_REFERENCE.replace("SRCS", repr(SRCS))
                    .replace("TILE", str(TILE))
                    .replace("OUT", repr(str(out_path))))
    ref = np.load(out_path)
    *_, outs = dist_views
    for r, out in enumerate(outs):
        for phase in ("cold", "delta"):
            for kind, fields in out[phase].items():
                want = {f: ref[f"{phase}/{kind}/{f}"] for f in fields}
                _assert_fields(fields, want, (r, phase, kind), exact=False)


# ------------------------------- the service ------------------------------

def _same_across_ranks(outs, key):
    first = outs[0][key]
    assert all(o[key] == first for o in outs), [o[key] for o in outs]
    return first


@pytest.mark.parametrize("bc_mode,seed,neg_frac", [
    ("gather", 7, 0.0), ("ring", 7, 0.0), ("ring", 11, 0.08)])
def test_service_stream_matches_local(bc_mode, seed, neg_frac):
    """The reference's four-device stream (``test_stream_differential.py
    ::test_stream_differential_multidevice``: n = 32, 6 steps, both modes,
    then negative weights in ring mode) through ``ShardedGraphService`` on
    a DistMesh: every reply equals the local GraphService's on every rank,
    and the rung tallies agree across ranks."""
    steps = 4 if neg_frac else 6
    outs = _spawn(dr.stream, seed, 32, steps, bc_mode, neg_frac,
                  0 if neg_frac else 6)
    tallies = _same_across_ranks(outs, "tallies")
    _same_across_ranks(outs, "stats")
    _same_across_ranks(outs, "coll_bytes")
    assert all(o["checked"] == steps * 9 for o in outs)
    if not neg_frac:
        for mode in ("unchanged", "delta", "full"):
            assert tallies[mode] > 0, tallies
        for o in outs[1:]:
            for a, b in zip(o["scores"], outs[0]["scores"]):
                assert torch.equal(a, b) or torch.allclose(
                    a, b, equal_nan=True, rtol=0, atol=0)
    for o in outs[1:]:
        for a, b in zip(o["state"], outs[0]["state"]):
            assert torch.equal(a, b)


def test_breaker_quarantines_on_every_rank():
    """As the reference's ``test_resil.py::
    test_breaker_quarantines_sharded_delta_path``, on four processes."""
    outs = _spawn(dr.breaker, 32)
    for o in outs:
        assert o["retries"] == [1, 1] and o["state"] == "open"
        assert o["mode"] == "full" and o["reply_retries"] == 0
        assert o["equal"] and o["trips"] == 1
    _same_across_ranks(outs, "stats")


def test_chaos_and_journaled_recovery(tmp_path):
    """The reference's ``test_stream_differential_multidevice_chaos_recovery``
    on four processes: FaultPlan(seed=5, rate=0.2) over the stream, rank 0
    journaling with rotation and compaction; every reply is correct or a
    validated stale one, the tallies agree, and recover() in every process
    from rank 0's directory gives a ring latest bit-identical to the live
    one on every rank."""
    outs = _spawn(dr.stream, 7, 32, 4, "ring", 0.0, 0,
                  (5, 0.2), str(tmp_path), 3, 1200)
    assert all(o["fired"] > 0 for o in outs)
    _same_across_ranks(outs, "fired")
    _same_across_ranks(outs, "tallies")
    stats = _same_across_ranks(outs, "stats")
    assert stats["errors"] + stats["retries"] > 0, stats
    j = outs[0]["journal"]
    assert j["rotations"] > 0 and j["compactions"] > 0, j
    assert all("journal" not in o for o in outs[1:])
    for o in outs:
        assert o["recovered_version"] == o["version"] == outs[0]["version"]
        assert o["recovered_pending"] == o["pending"]
        for a, b, c in zip(o["recovered"], o["state"], outs[0]["recovered"]):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_adaptive_thresholds_driven_apart_agree():
    """Walls driven apart per process pull each rank's adaptive crossover
    to another clamp, so alone the ranks would pick different rungs; the
    rung is rank 0's on every rank, so the tallies, stats and collective
    bytes agree and every reply equals the local service's."""
    outs = _spawn(dr.stream, 7, 32, 6, "gather", 0.0, 0, None, None, None,
                  None, True)
    thresholds = [o["thresholds"] for o in outs]
    assert thresholds[0] != thresholds[1], thresholds
    _same_across_ranks(outs, "tallies")
    _same_across_ranks(outs, "stats")
    _same_across_ranks(outs, "coll_bytes")
    for r, o in enumerate(outs):
        assert all(got == outs[0]["decisions"][i][0]
                   for i, (_, got) in enumerate(o["decisions"]))
        if r:
            assert any(local != got for local, got in o["decisions"]), r
