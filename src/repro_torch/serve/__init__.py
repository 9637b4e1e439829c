"""Non-blocking async serving front end (port of ``repro.serve``).

``AsyncGraphService`` wraps a :class:`repro_torch.engine.GraphService`
with concurrent admission: queries pin a ring version at arrival and
resolve as Futures; a dispatcher batches compatible queries (same kind,
same pinned version) into single lane-batched calls, on a CUDA stream of
its own on the card; updates commit through the (thread-safe) scheduler
without ever blocking in-flight reads on older versions.  See
``serve.async_service`` for the admission -> pin -> batch -> dispatch
lifecycle and ``serve.batch`` for the bit-identity argument.
"""
from .async_service import AsyncGraphService, ServeStats
from .batch import Lane, classify_local, dispatch_local_group, pad_pow2

__all__ = [
    "AsyncGraphService", "Lane", "ServeStats", "classify_local",
    "dispatch_local_group", "pad_pow2",
]
