"""The port's core: versioned graph state, batched updates, queries, the
tile view and the semiring layer (mirrors ``repro.core``)."""
from .graph_state import (  # noqa: F401
    INF,
    NOKEY,
    GraphState,
    compact,
    densify,
    from_edge_list,
    grow_edges,
    grow_vertices,
    live_edge_mask,
    make_graph,
    state_from_numpy,
    state_to_numpy,
)
from .updates import (  # noqa: F401
    GETE,
    GETV,
    NOP,
    PUTE,
    PUTV,
    REME,
    REMV,
    OpBatch,
    OpResults,
    apply_batch,
    apply_ops,
    dirty_vertices,
    dirty_vertices_padded,
    get_e,
    get_v,
    make_batch,
)
from .queries import (  # noqa: F401
    BCResult,
    BFSResult,
    SSSPResult,
    bc,
    bc_batched_dense,
    bc_dependencies,
    bfs,
    dense_views,
    sssp,
)
from .tiles import (  # noqa: F401
    TILE,
    TileView,
    build_tile_view,
    dense_views_from_tiles,
    occupancy_stats,
    refresh_tile_view,
)
from .snapshot import ScanStats  # noqa: F401
