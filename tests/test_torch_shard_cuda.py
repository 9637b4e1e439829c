"""Card-only tests of the sharded engine (``repro_torch.shard``): the rank
streams' event waits, and the sharded queries through the kernels on four
ranks of one card against the local batched path.  Marked ``cuda``; they
skip without a CUDA device.  The file imports neither JAX nor the
reference (the card's machine has neither)."""
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_thread_group_streams(cuda_device):
    """Four ranks on one card, each on its own stream: a collective reads
    what another rank's stream wrote only after that rank's event, and the
    caller reads every rank's output only after its last event.  Each
    rank's operand is the end of a long chain of kernels on its stream, so
    a missing wait would read it unfinished."""
    from repro_torch.shard import GraphMesh, ThreadGroup

    mesh = GraphMesh(["cuda:0"] * 4)
    base = torch.arange(1 << 20, dtype=torch.float32, device=cuda_device)

    def body(g, x):
        r = g.axis_index()
        for _ in range(200):  # keep the rank's stream busy
            x = x * 1.0 + 0.0
        x = x + r
        got = g.ppermute(x, [(j, (j + 1) % 4) for j in range(4)])
        return g.psum(x), got, g.all_gather(x[None])

    for _ in range(3):
        outs = ThreadGroup(mesh).run(body, [(base.clone(),)] * 4)
        total = 4 * base + 6
        for r, (s, got, gathered) in enumerate(outs):
            assert torch.equal(s, total)
            assert torch.equal(got, base + (r - 1) % 4)
            assert torch.equal(gathered[2], base + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("bc_mode", ["gather", "ring"])
def test_cuda_sharded_queries_match_local(cuda_device, bc_mode):
    """The sharded engine on four ranks of one card, through the kernels:
    BFS/SSSP and BC level/sigma equal the local batched path bit for bit
    (BC delta to 1e-5), and every delta answer equals the full sharded
    recompute."""
    from repro_torch.core import PUTE, REME, apply_ops, dense_views
    from repro_torch.core import queries as tq
    from repro_torch.core.updates import dirty_vertices
    from repro_torch.data import load_rmat_graph
    from repro_torch.kernels import count_mm as kc
    from repro_torch.shard import (GraphMesh, bc_batched, bfs,
                                   build_sharded_view, delta_bc_sharded,
                                   delta_bfs_sharded, delta_sssp_sharded,
                                   refresh_sharded_view, sssp,
                                   validate_incremental_sharded)

    g = load_rmat_graph(2048, 20480, seed=4, device="cuda")
    mesh = GraphMesh(["cuda:0"] * 4)
    view = build_sharded_view(g, mesh)
    srcs = torch.tensor([0, 5, 100, 1500, 2047, 7, 9], dtype=torch.int32,
                        device=cuda_device)
    am, wd, alive = dense_views(g)
    kc.reset_launches()
    r = bfs(view, g, srcs)
    assert torch.equal(r.dist, tq.bfs_batched_dense(am, srcs, alive))
    s = sssp(view, g, srcs)
    dref, nref = tq.sssp_batched_dense(wd, srcs, alive)
    assert torch.equal(s.dist, dref) and torch.equal(s.negcycle, nref)
    b = bc_batched(view, g, srcs, src_chunk=2, bc_mode=bc_mode)
    delta, sigma, level, ok = tq.bc_batched_dense(am, srcs, alive,
                                                  src_chunk=2)
    assert torch.equal(b.level, level) and torch.equal(b.sigma, sigma)
    assert torch.equal(b.ok, ok) and bool(b.agree)
    assert torch.allclose(b.delta, delta, rtol=1e-5, atol=1e-5)
    assert kc.LAUNCHES["count_mm_masked"] > 0
    ops = [(PUTE, 3, 1800, 1.0), (REME, int(g.esrc[10]), int(g.edst[10])),
           (PUTE, 1200, 9, 2.0), (PUTE, 700, 701, 1.0)]
    g2, _ = apply_ops(g, ops)
    dirty = dirty_vertices(g, g2)
    view = refresh_sharded_view(g2, view, dirty)
    for kind, res in (
            ("bfs", delta_bfs_sharded(view, g2, r, dirty, srcs)),
            ("sssp", delta_sssp_sharded(view, g2, s, dirty, srcs)),
            ("bc", delta_bc_sharded(view, g2, b, dirty, srcs, src_chunk=2,
                                    bc_mode=bc_mode))):
        assert validate_incremental_sharded(view, g2, srcs, res, kind,
                                            src_chunk=2, bc_mode=bc_mode)
