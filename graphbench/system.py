"""The system under test, reached through its public entry points only:
``repro_torch.core.from_edge_list`` and ``repro_torch.engine.GraphService``
(``submit_many``, ``flush``, ``bc_scores``, ``bc_scores_stats``).
"""
from __future__ import annotations

from . import traffic

#: the ``bc_scores_stats`` modes read as counters
BC_MODES = ("unchanged", "delta", "full")


def check_interface() -> None:
    """The op codes the traffic carries are the program's."""
    from repro_torch.core import updates

    ours = (traffic.NOP, traffic.PUTV, traffic.REMV, traffic.PUTE,
            traffic.REME)
    theirs = (updates.NOP, updates.PUTV, updates.REMV, updates.PUTE,
              updates.REME)
    if ours != theirs:
        raise RuntimeError(f"op codes {ours} are not the program's {theirs}")


def build(config: dict, n: int, src, dst, w, ecap: int, device: str):
    """The deployment's ``GraphService`` over the loaded initial graph."""
    from repro_torch.core import from_edge_list
    from repro_torch.engine import GraphService

    svc_cfg = config["service"]
    state = from_edge_list(n, ecap, src, dst, w, device=device)
    return GraphService(state, ring_depth=int(svc_cfg["ring_depth"]),
                        batch_size=int(svc_cfg["batch_size"]))


def counters(svc) -> dict:
    return {f"bc_scores.{m}": int(svc.bc_scores_stats[m]) for m in BC_MODES}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}
