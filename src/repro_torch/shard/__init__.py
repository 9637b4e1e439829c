"""Sharded tile-grid engine: multi-device tile-sparse graph analytics (port
of ``repro.shard``).

The tile-sparse semiring path (``repro_torch.core.tiles`` +
``repro_torch.kernels``) partitioned over a 1-D graph mesh: tile *rows* ->
ranks, so each rank owns a contiguous band of source vertices plus that
band's occupancy grid, and BFS/SSSP/BC run as per-rank bodies -- local
tile-skipping semiring work, one vcap-sized collective per level -- on one
thread and one CUDA stream per rank (``group.ThreadGroup``).
"""
from .group import GraphMesh, ThreadGroup  # noqa: F401
from .tile_shard import (  # noqa: F401
    GRAPH_AXIS,
    REFRESH_BATCH,
    RefreshStats,
    ShardedTileView,
    as_graph_mesh,
    build_sharded_view,
    gather_view,
    refresh_sharded_view,
    refresh_stats,
    sharded_occupancy_stats,
)
from .queries import (  # noqa: F401
    BC_MODES,
    ShardedBCResult,
    ShardedBFSResult,
    ShardedSSSPResult,
    bc_batched,
    bfs,
    delta_bc_sharded,
    delta_bfs_sharded,
    delta_sssp_sharded,
    query_fn,
    query_shardings,
    sssp,
    validate_incremental_sharded,
)
from .service import ShardedGraphService  # noqa: F401
