"""Per-query scan statistics (port of ``repro.core.snapshot.ScanStats``).

The reference's collect/CMPTREE machinery (``collect_*``, ``cmp_tree``,
the PG-Cn / PG-Icn collect modes) is not ported yet; ``GraphService`` runs its
own double-collect loop and carries these counters on every reply.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ScanStats:
    """Per-query statistics mirroring the paper's Fig 12/13."""
    collects: int = 0               # TREECOLLECT invocations in the SCAN
    interrupting_updates: int = 0   # committed batches during the query
    validated: bool = True
