"""Incremental analytics engine: version ring + delta queries + scheduler
(mirrors ``repro.engine``).

  * :mod:`repro_torch.engine.version_ring` -- MVCC ring of committed
    snapshots with per-commit dirty-vertex sets;
  * :mod:`repro_torch.engine.incremental` -- delta BFS / SSSP / BC reusing
    a prior result, with full-recompute fallback and cmp_tree validation;
  * :mod:`repro_torch.engine.scheduler` -- op-log coalescing the update
    stream into fixed-size committed batches;
  * :mod:`repro_torch.engine.service` -- the ``GraphService``
    submit()/query() front end with PG-Icn / PG-Cn modes and ``bc_scores``.
"""
from .version_ring import PinnedSnapshot, RingEntry, VersionRing  # noqa: F401
from .incremental import (  # noqa: F401
    IncrementalStats,
    delta_bc,
    delta_bfs,
    delta_sssp,
    incremental_bc,
    incremental_bfs,
    incremental_sssp,
    results_equal,
    validate_incremental,
)
from .scheduler import SchedulerStats, StreamScheduler  # noqa: F401
from .service import GraphService, QueryReply, ServiceStats  # noqa: F401
