"""Distributed graph queries over a graph mesh -- tile-grid sharding (port
of ``repro.core.partition``).

The paper's 56 CPU threads become the ranks of a
:class:`~repro_torch.shard.GraphMesh`.  This front end rides the sharded
tile-grid engine (``repro_torch.shard``): the ``TileView`` grid is
partitioned by tile *rows* over a 1-D graph axis, each rank runs local
tile-skipping semiring work per level, and ONE vcap-sized collective merges
frontiers -- collective bytes per level O(S x vcap), independent of E.  The
version agreement is psum-validated so all ranks agree on the snapshot.

``make_distributed_query`` gives the distributed program for a mesh and a
query kind (``"bfs"`` | ``"sssp"`` | ``"bc"`` | ``"bc_ring"``); the
round-robin *edge* sharding survives in ``partition_legacy`` as the
cross-implementation oracle.
"""
from __future__ import annotations

import torch

from repro_torch.shard.queries import ArgSpec, query_fn, query_shardings
from repro_torch.shard.tile_shard import (
    _padded_dim,
    as_graph_mesh,
    build_sharded_view,
)
from .tiles import TILE

from .partition_legacy import shard_edges  # noqa: F401  (legacy oracle API)

SUPPORTED_KINDS = ("bfs", "sssp", "bc", "bc_ring")


def make_distributed_query(mesh, kind: str = "bfs", *, tile: int = TILE,
                           use_kernel=None, src_chunk: int | None = None):
    """The distributed query for ``mesh``: ``(fn, in_layouts,
    out_layouts)``, where ``fn(w, occ, alive, ecnt, srcs, version)`` takes
    a :class:`~repro_torch.shard.ShardedTileView`'s bands built on the same
    mesh, the vertex arrays and the sources (for bc, a multiple of the rank
    count long), and the layouts say how each argument and output is laid
    over the ranks (``repro_torch.shard.query_shardings``)."""
    if kind not in SUPPORTED_KINDS:
        raise ValueError(
            f"unknown query kind {kind!r}; supported kinds: "
            f"{', '.join(SUPPORTED_KINDS)}")
    gmesh = as_graph_mesh(mesh)
    in_l, out_l = query_shardings(gmesh, kind)
    return query_fn(gmesh, kind, tile, use_kernel, src_chunk), in_l, out_l


def build_query_inputs(state, mesh, srcs, *, tile: int = TILE):
    """Snapshot -> the argument tuple ``make_distributed_query``'s fn wants
    (building the sharded view on the mesh)."""
    view = build_sharded_view(state, as_graph_mesh(mesh), tile)
    srcs = torch.atleast_1d(torch.as_tensor(srcs, dtype=torch.int32,
                                            device=state.device))
    return (view.w, view.occ, state.alive, state.ecnt, srcs, state.version)


def distributed_query_specs(vcap: int, mesh, *, tile: int = TILE,
                            n_sources: int = 8):
    """The arguments of ``make_distributed_query``'s fn, allocated nowhere:
    per argument an :class:`~repro_torch.shard.queries.ArgSpec` with its
    global shape, its layout and the shape each rank holds -- the per-rank
    band layout (the reference returns shardings for an AOT lowering).
    ``n_sources`` must be a multiple of the rank count for ``"bc"``."""
    n = as_graph_mesh(mesh).size
    vp = _padded_dim(vcap, tile, n)
    nt = vp // tile
    return (
        ArgSpec((vp, vp), torch.float32, "band", (vp // n, vp)),      # w
        ArgSpec((nt, nt), torch.int32, "band", (nt // n, nt)),        # occ
        ArgSpec((vcap,), torch.bool, "replicated", (vcap,)),          # alive
        ArgSpec((vcap,), torch.int32, "replicated", (vcap,)),         # ecnt
        ArgSpec((n_sources,), torch.int32, "replicated",              # srcs
                (n_sources,)),
        ArgSpec((), torch.int32, "replicated", ()),                   # version
    )
