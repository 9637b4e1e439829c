"""The graph mesh of the port's launch layer (port of
``repro.launch.mesh.make_graph_mesh``).

The reference's production mesh (``make_production_mesh``, 16 x 16 chips
a pod) and its sharding-spec sanitizers belong to the LM stack's sharding
and are not ported yet.  Importing this module touches no device.
"""
from __future__ import annotations

from repro_torch.shard.group import GraphMesh, as_graph_mesh


def make_graph_mesh(mesh=None) -> GraphMesh:
    """The 1-D ``graph`` axis the sharded tile-grid engine
    (``repro_torch.shard``) partitions over: ``mesh``'s devices flattened,
    or every visible CUDA device when ``None``."""
    return as_graph_mesh(mesh)
