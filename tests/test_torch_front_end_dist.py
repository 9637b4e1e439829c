"""The async front end over a mesh of processes
(``repro_torch.serve.AsyncGraphService`` over ``ShardedGraphService`` on
a ``DistMesh``): four gloo ranks on the CPU, started by
``repro_torch.shard.spawn``; rank 0 admits and sequences, the other ranks
``follow()`` its commands (rank bodies in ``tests/dist_ranks.py``).

  * the schedule of ``chip_smoke.py``'s 3g front end -- three clients ask
    BFS/SSSP/BC from three sources, 27 requests, while two commits land:
    every reply equals the single-source query of each of its sources at
    the version it names (BFS/SSSP bit for bit, BC delta to 1e-5) with
    the agreement flag, the dedup and fallback tallies add up to the
    requests, no pin is left, and every rank ends with the same tallies;
  * ``FaultPlan(seed=7, rate=0.25)`` active on every rank, in ring mode
    on a ring of depth 2 (pinned versions park as commits rotate them
    out): faults fire on every rank alike (the same decisions at the same
    hits) and every rank ends with the same stats, evictions and control
    bytes;
  * a 2 ms admission deadline: every rank finishes the same requests as
    expired;
  * a crash of rank 0's dispatcher reaches every follower as
    ``RankFailure`` at once;
  * one client waiting for each reply (fixed versions): the replies of
    the reference's ``AsyncGraphService`` over its ``ShardedGraphService``
    on four placeholder devices (a JAX subprocess), levels and distances
    exact, BC delta to 1e-5.
"""
import numpy as np
import pytest

import repro.core as jc
from repro.data import load_rmat_graph
import repro_torch.shard as ts

import dist_ranks as dr
from conftest import run_multidevice

N_RANKS = 4
MESH_TIMEOUT = 30.0
JOIN = 240.0
TOL = dict(rtol=1e-5, atol=1e-5)
SOURCES = (0, 1, 5)
KINDS = ("bfs", "sssp", "bc")
# 3g's schedule: each kind from each source, and two one-op commits
ASKS = [(kind, [src]) for src in SOURCES for kind in KINDS]
CHUNKS = [[(jc.PUTE, SOURCES[0], SOURCES[2], 1.0)],
          [(jc.PUTE, SOURCES[1], SOURCES[0], 2.0)]]
# test_torch_shard's front end under faults: multi-source asks
CHAOS_ASKS = [("bfs", [0, 1]), ("sssp", [0]), ("bc", [0, 3]),
              ("bfs", [0, 1]), ("sssp", [5]), ("bc", [0, 3])]


def _run(chunks, asks, bc_mode="gather", chaos=None, deadline_ms=None,
         sequential=False, ring_depth=8):
    return ts.spawn(dr.front_end, N_RANKS, device="cpu", transport="gloo",
                    timeout=MESH_TIMEOUT, join_timeout=JOIN,
                    args=(_arrays(), chunks, asks, bc_mode, 3, chaos,
                          deadline_ms, sequential, ring_depth))


def _arrays(seed=21):
    g = load_rmat_graph(256, 1600, seed=seed)
    return [np.asarray(x) for x in g]


def _chaos_chunks(seed=22):
    rng = np.random.default_rng(seed)
    return [[(jc.PUTE, int(rng.integers(0, 64)), int(rng.integers(0, 256)),
              float(rng.integers(1, 9))) for _ in range(4)]
            for _ in range(6)]


def _agree(outs):
    """Every rank ends with the same tallies, control bytes and version,
    and no pin."""
    r0 = outs[0]
    for out in outs:
        for key in ("serve", "stats", "control", "version", "expired",
                    "dedup", "fired", "log", "evictions"):
            assert out[key] == r0[key], (out["rank"], key, out[key], r0[key])
        assert out["pinned"] == []
    for out in outs[1:]:
        assert out["commands"] > 0


def _held(replies, allow_errors=False):
    answered = [r for r in replies if len(r) > 3]
    for kind, srcs, version, mode, validated, degraded, _, same in answered:
        assert same, (kind, srcs, version, mode)
        assert degraded or validated, (kind, srcs, version, mode)
    if not allow_errors:
        assert len(answered) == len(replies), [r for r in replies
                                               if len(r) == 3]
    return answered


def test_front_end_serves_the_mesh():
    outs = _run(CHUNKS, ASKS)
    _agree(outs)
    replies = outs[0]["replies"]
    assert len(replies) == 27
    _held(replies)
    r0 = outs[0]
    assert r0["version"] == 2 and r0["stats"]["errors"] == 0
    assert r0["serve"]["admitted"] == 27
    assert r0["dedup"] + r0["serve"]["fallbacks"] == 27
    assert {r[2] for r in replies} <= {0, 1, 2}


def test_front_end_on_the_mesh_under_faults():
    outs = _run(_chaos_chunks(), CHAOS_ASKS, bc_mode="ring",
                chaos=(7, 0.25), ring_depth=2)
    _agree(outs)
    r0 = outs[0]
    assert r0["fired"] > 0 and any(fire for _, _, fire in r0["log"])
    assert r0["serve"]["fallbacks"] > 0 or r0["stats"]["retries"] > 0
    answered = _held(r0["replies"], allow_errors=True)
    assert answered and r0["version"] == 6


def test_deadline_expiry_agrees_across_ranks():
    outs = _run(CHUNKS, ASKS, deadline_ms=2.0)
    _agree(outs)
    r0 = outs[0]
    assert r0["serve"]["deadline_expired"] == len(r0["expired"]) > 0
    _held(r0["replies"], allow_errors=True)


def test_rank_zero_crash_reaches_every_follower():
    with pytest.raises(ts.SpawnError) as ei:
        ts.spawn(dr.front_end_crash, N_RANKS, device="cpu",
                 transport="gloo", timeout=10.0, join_timeout=JOIN,
                 args=(_arrays(),))
    codes, errors = ei.value.exitcodes, ei.value.errors
    assert None not in codes and all(c != 0 for c in codes), codes
    assert "InjectedCrash" in errors[0], errors[0]
    for r in range(1, N_RANKS):
        assert "RankFailure" in errors[r], errors[r]


def test_front_end_matches_reference_front_end(tmp_path):
    """One client waits for each reply and a commit lands after each round
    of the 9 asks: the versions are fixed, and the port's replies are the
    reference front end's over its sharded service on four placeholder
    devices."""
    out = tmp_path / "ref.npz"
    run_multidevice(f"""
import numpy as np
import repro.core as jc
from repro.data import load_rmat_graph
import repro.shard as js
from repro.serve import AsyncGraphService

g = load_rmat_graph(256, 1600, seed=21)
svc = js.ShardedGraphService(g, js.as_graph_mesh(), tile={dr.TILE},
                             batch_size=1)
res = {{}}
with AsyncGraphService(svc, max_batch=16) as srv:
    for i, ops in enumerate({CHUNKS!r} + [None]):
        for j, (kind, srcs) in enumerate({ASKS!r}):
            rep = srv.query(kind, srcs, timeout=600)
            res[f"{{i}}/{{j}}/version"] = np.asarray(rep.version)
            for f, x in zip(type(rep.result)._fields, rep.result):
                res[f"{{i}}/{{j}}/{{f}}"] = np.asarray(x)
        if ops is not None:
            srv.submit_many([tuple(op) for op in ops])
            srv.flush()
np.savez({str(out)!r}, **res)
print("REF OK")
""")
    ref = np.load(out)
    outs = _run(CHUNKS, ASKS, sequential=True)
    _agree(outs)
    replies = _held(outs[0]["replies"])
    assert len(replies) == 3 * len(ASKS)
    for n, (kind, srcs, version, mode, _, _, fields, _) in enumerate(
            replies):
        i, j = divmod(n, len(ASKS))
        assert version == int(ref[f"{i}/{j}/version"]) == i
        for f, got in fields.items():
            want = ref[f"{i}/{j}/{f}"]
            assert got.shape == want.shape, (kind, f)
            if f in ("delta", "scores"):
                np.testing.assert_allclose(got, want, **TOL)
            else:
                assert np.array_equal(got, want), (kind, srcs, i, f)
