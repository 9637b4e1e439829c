"""Port parity: the distributed query front end (``repro_torch.core.partition``),
the edge-sharded oracle (``repro_torch.core.partition_legacy``) and the
launch layer's graph mesh (``repro_torch.launch.mesh``) against the
reference on the same numpy inputs.

The port runs on ``GraphMesh(["cpu"] * 4)``; the reference in process on
its one CPU device.  Every compared field is bit for bit except BC
``delta`` / ``scores``, to ``rtol = atol = 1e-5`` (f32 summation order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import jax
import repro.core as jc
import repro.core.partition as jp
import repro.core.partition_legacy as jl
import repro.shard as js
from repro.data import load_rmat_graph
import repro_torch.core as tc
import repro_torch.core.partition as tp
import repro_torch.core.partition_legacy as tl
import repro_torch.core.queries as tq
import repro_torch.shard as ts
from repro_torch.launch.mesh import make_graph_mesh

TOL = dict(rtol=1e-5, atol=1e-5)
TILE = 16
MESH = ts.GraphMesh(["cpu"] * 4)


def _np(x):
    return np.asarray(x)


def _graphs(n=256, edges=2000, seed=3):
    g = load_rmat_graph(n, edges, seed=seed)
    g, _ = jc.apply_ops(g, [(jc.REME, int(g.esrc[5]), int(g.edst[5])),
                            (jc.REMV, 7), (jc.REMV, 33), (jc.PUTE, 3, 9, -1.0)])
    return g, tc.state_from_numpy(*map(_np, g), device="cpu")


def test_make_distributed_query_rejects_unknown_kind():
    with pytest.raises(ValueError) as ei:
        tp.make_distributed_query(MESH, "pagerank")
    msg = str(ei.value)
    assert "pagerank" in msg
    assert tp.SUPPORTED_KINDS == jp.SUPPORTED_KINDS
    for kind in tp.SUPPORTED_KINDS:
        assert kind in msg


@pytest.mark.parametrize("kind", ["bfs", "sssp", "bc", "bc_ring"])
def test_distributed_query_matches_reference(kind):
    """``build_query_inputs`` + ``make_distributed_query``'s fn against the
    reference's fn on the same snapshot: every output, padded columns
    included, in the layouts ``query_shardings`` names."""
    jg, tg = _graphs()
    srcs = [0, 2, 7, 40, 100, 255, 33, 12]
    jfn, _, _ = jp.make_distributed_query(js.as_graph_mesh(), kind,
                                          tile=TILE, src_chunk=3)
    jout = jfn(*jp.build_query_inputs(jg, js.as_graph_mesh(), srcs,
                                      tile=TILE))
    tfn, in_l, out_l = tp.make_distributed_query(MESH, kind, tile=TILE,
                                                 src_chunk=3)
    args = tp.build_query_inputs(tg, MESH, srcs, tile=TILE)
    assert len(args) == len(in_l) and len(args[0]) == 4  # four bands
    tout = tfn(*args)
    assert len(tout) == len(jout) == len(out_l)
    close = (1, 4) if kind.startswith("bc") else ()
    for i, (a, b) in enumerate(zip(jout, tout)):
        a = _np(a)
        assert a.shape == tuple(b.shape), (kind, i)
        if i in close:
            np.testing.assert_allclose(b.numpy(), a, **TOL)
        else:
            assert np.array_equal(a, b.numpy()), (kind, i)


def test_distributed_query_specs_give_the_band_layout():
    """The reference's shapes and types, and what each rank holds."""
    jspecs = jp.distributed_query_specs(250, js.as_graph_mesh(), tile=TILE,
                                        n_sources=8)
    tspecs = tp.distributed_query_specs(250, MESH, tile=TILE, n_sources=8)
    vp = 256  # 250 padded to a multiple of 4 ranks x 16
    for a, b in zip(jspecs, tspecs):
        assert b.shape == tuple(a.shape)
        assert str(b.dtype) == f"torch.{a.dtype}"
    assert tspecs[0].shape == (vp, vp) and tspecs[0].rank_shape == (64, vp)
    assert tspecs[1].shape == (16, 16) and tspecs[1].rank_shape == (4, 16)
    assert [s.layout for s in tspecs] == ["band", "band", "replicated",
                                         "replicated", "replicated",
                                         "replicated"]


@pytest.mark.parametrize("query", ["bfs", "sssp"])
def test_legacy_oracle_matches_reference(query):
    """The edge-sharded oracle on four CPU ranks against the reference's on
    its one device, and against the tile-sharded queries: two
    decompositions agreeing on one snapshot."""
    jg, tg = _graphs()
    jgl, tgl = jl.shard_edges(jg, 1), tl.shard_edges(tg, 4)
    assert tgl.ecap % 4 == 0 and tgl.ecap >= tg.ecap
    assert tl.shard_edges(tg, 1) is tg
    jmesh = Mesh(np.asarray(jax.devices()).reshape(1, 1), ("data", "model"))
    jfn, _, _ = jl.make_distributed_query(jmesh, query)
    tfn, in_l, out_l = tl.make_distributed_query(MESH, query)
    assert in_l[2:5] == ("split",) * 3 and set(out_l) == {"replicated"}
    view = ts.build_sharded_view(tg, MESH, tile=TILE)
    for src in (0, 7, 100, 255, -1):
        jout = jax.jit(jfn)(jgl.alive, jgl.ecnt, jgl.esrc, jgl.edst, jgl.ew,
                            jnp.int32(src))
        tout = tfn(tgl.alive, tgl.ecnt, tgl.esrc, tgl.edst, tgl.ew, src)
        for i, (a, b) in enumerate(zip(jout, tout)):
            assert np.array_equal(_np(a), b.numpy()), (query, src, i)
        if src < 0:
            continue
        if query == "bfs":
            sharded = ts.bfs(view, tg, [src])
            assert torch.equal(tout[1], sharded.dist[0])
            assert torch.equal(tout[2], sharded.parent[0])
        else:
            sharded = ts.sssp(view, tg, [src])
            assert torch.equal(tout[1], sharded.dist[0])
            assert bool(tout[2]) == bool(sharded.negcycle[0])
    specs = tl.distributed_query_specs(tg.vcap, 4001, MESH)
    assert specs[2].shape == (4004,) and specs[2].rank_shape == (1001,)


def test_make_graph_mesh():
    mesh = make_graph_mesh(["cpu"] * 4)
    assert mesh == MESH and make_graph_mesh(mesh) is mesh
    if torch.cuda.is_available():
        assert make_graph_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_graph_mesh()


def test_sharded_bc_scores_match_bc_map():
    """Exact all-vertex BC through the sharded ring equals the per-source
    baseline of both packages (``bc(method="map")``)."""
    jg, tg = _graphs(n=64, edges=400)
    svc = ts.ShardedGraphService(tg, MESH, tile=TILE, bc_mode="ring")
    scores, _ = svc.bc_scores()
    for v in (0, 3, 9, 33, 60):
        want = _np(jc.bc(jg, v, method="map"))
        got = float(scores[v])
        if np.isnan(want):
            assert np.isnan(got)
        else:
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_allclose(
                got, float(tq.bc(tg, v, method="map")), **TOL)
