"""Port parity: the batched-dense BFS and SSSP queries.

``bfs_batched_dense`` / ``sssp_batched_dense`` of ``repro_torch`` against
``repro`` on the same snapshots (dead vertices, tombstoned edges, a
reachable negative cycle), dense and with a tile view's occupancy grid.
Distances and the negative-cycle flags must be equal bit for bit, and
equal the per-source COO queries."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as jc
import repro.core.queries as jq
import repro.core.tiles as jt
import repro_torch.core.queries as tq
import repro_torch.core.tiles as tt
from repro_torch.kernels import bool_mm as tbool
from repro_torch.kernels import minplus_mm as tmin

from test_torch_queries import _churned_graph, _to_torch

SRCS = np.array([0, 5, 7, 30, 31, 63, 12, -1, 70], np.int32)  # dead, range


def _views(g, t, tiled, tile=16):
    if tiled:
        jview, tview = jt.build_tile_view(g, tile=tile), tt.build_tile_view(
            t, tile=tile)
        jam, jw, jalive = jt.dense_views_from_tiles(g, jview)
        tam, tw, talive = tt.dense_views_from_tiles(t, tview)
        return ((jam, jw, jalive, dict(amask=jview.occ, tile=tile)),
                (tam, tw, talive, dict(amask=tview.occ, tile=tile)))
    jam, jw, jalive = jq.dense_views(g)
    tam, tw, talive = tq.dense_views(t)
    return (jam, jw, jalive, {}), (tam, tw, talive, {})


@pytest.mark.parametrize("neg", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_batched_bfs_sssp_match_reference(neg, tiled):
    g = _churned_graph(seed=21, neg=neg)
    t = _to_torch(g)
    (jam, jw, jalive, jkw), (tam, tw, talive, tkw) = _views(g, t, tiled)
    srcs = jnp.asarray(SRCS)
    exp_bfs = np.asarray(jq.bfs_batched_dense(jam, srcs, jalive, **jkw))
    exp_d, exp_neg = map(np.asarray, jq.sssp_batched_dense(jw, srcs, jalive,
                                                           **jkw))
    tsrcs = torch.tensor(SRCS)
    got_bfs = tq.bfs_batched_dense(tam, tsrcs, talive, **tkw)
    got_d, got_neg = tq.sssp_batched_dense(tw, tsrcs, talive, **tkw)
    assert got_bfs.dtype == torch.int32 and got_d.dtype == torch.float32
    assert got_neg.dtype == torch.bool and got_neg.shape == (len(SRCS),)
    assert np.array_equal(got_bfs.numpy(), exp_bfs)
    assert np.array_equal(got_d.numpy(), exp_d)
    assert np.array_equal(got_neg.numpy(), exp_neg)
    assert bool(got_neg[3]) == neg  # the cycle is reachable from 30
    # the plain route gives the same answers as the kernel route
    assert torch.equal(tq.bfs_batched_dense(tam, tsrcs, talive,
                                            use_kernel=False, **tkw), got_bfs)
    d_plain, n_plain = tq.sssp_batched_dense(tw, tsrcs, talive,
                                             use_kernel=False, **tkw)
    assert torch.equal(d_plain, got_d) and torch.equal(n_plain, got_neg)


def test_batched_queries_equal_coo_queries():
    g = _churned_graph(seed=8)
    t = _to_torch(g)
    tview = tt.build_tile_view(t, tile=16)
    am, w, alive = tt.dense_views_from_tiles(t, tview)
    srcs = torch.arange(64, dtype=torch.int32)
    dist = tq.bfs_batched_dense(am, srcs, alive, amask=tview.occ, tile=16)
    sdist, neg = tq.sssp_batched_dense(w, srcs, alive, amask=tview.occ,
                                       tile=16)
    assert not bool(neg.any())
    for s in range(64):
        assert torch.equal(dist[s], tq.bfs(t, s).dist), s
        assert torch.equal(sdist[s], tq.sssp(t, s).dist), s


def test_batched_queries_match_reference_kernel_path():
    """The reference's Pallas route (``use_kernel=True``, interpret mode)
    and the port's kernel route on a masked R-MAT snapshot."""
    from repro.data import load_rmat_graph
    g = load_rmat_graph(64, 400, seed=5)
    g, _ = jc.apply_ops(g, [(jc.REMV, 3), (jc.REME, 0, 1)])
    t = _to_torch(g)
    (jam, jw, jalive, jkw), (tam, tw, talive, tkw) = _views(g, t, True, 32)
    srcs = np.arange(0, 64, 5, dtype=np.int32)
    exp_bfs = jq.bfs_batched_dense(jam, jnp.asarray(srcs), jalive,
                                   use_kernel=True, **jkw)
    exp_d, exp_neg = jq.sssp_batched_dense(jw, jnp.asarray(srcs), jalive,
                                           use_kernel=True, **jkw)
    got_bfs = tq.bfs_batched_dense(tam, torch.tensor(srcs), talive,
                                   use_kernel=True, **tkw)
    got_d, got_neg = tq.sssp_batched_dense(tw, torch.tensor(srcs), talive,
                                           use_kernel=True, **tkw)
    assert np.array_equal(got_bfs.numpy(), np.asarray(exp_bfs))
    assert np.array_equal(got_d.numpy(), np.asarray(exp_d))
    assert np.array_equal(got_neg.numpy(), np.asarray(exp_neg))


def test_batched_loops_take_one_product_per_level_or_pass():
    """One product per BFS level / relax pass; on the CPU the kernel
    modules run their plain versions and count no launch."""
    g = _churned_graph(seed=2)
    t = _to_torch(g)
    am, w, alive = tq.dense_views(t)
    a = (am & alive[:, None] & alive[None, :]).float()
    big = torch.where(alive[:, None] & alive[None, :], w, float("inf"))
    calls = {"bfs": 0, "sssp": 0}

    def bfs_mm(x):
        calls["bfs"] += 1
        return (x @ a > 0).float()

    def sssp_mm(x):
        calls["sssp"] += 1
        return torch.amin(x[:, :, None] + big[None], dim=1)

    srcs = torch.tensor([0, 1, 2], dtype=torch.int32)
    dist = tq.bfs_batched_ops(bfs_mm, srcs, alive, t.vcap)
    assert torch.equal(dist, tq.bfs_batched_dense(am, srcs, alive))
    assert calls["bfs"] == int(dist.max()) + 1  # last level finds nothing
    sd, neg = tq.sssp_batched_ops(sssp_mm, srcs, alive, t.vcap)
    assert torch.equal(sd, tq.sssp_batched_dense(w, srcs, alive)[0])
    assert 1 <= calls["sssp"] < t.vcap and not bool(neg.any())
    assert tbool.LAUNCHES == {"bool_mm": 0, "bool_mm_masked": 0}
    assert tmin.LAUNCHES == {"minplus_mm": 0, "minplus_mm_masked": 0}
