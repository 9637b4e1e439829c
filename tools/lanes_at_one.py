#!/usr/bin/env python3
"""What the sequential ladder would pay if its single-source queries ran
as the lane forms at one lane, on one NVIDIA GPU.

    python3 tools/lanes_at_one.py

The serving front end's lane forms (``queries.bfs_lanes``, ``sssp_lanes``,
``bc_dependencies_lanes``, ``incremental.delta_bfs_lanes``,
``delta_sssp_lanes``, ``delta_bc_at_cut_lanes``) answer lane ``i`` bit for
bit as the single-source functions do, so the single-source functions
could be one-lane calls of them.  This replays ``chip_smoke.py``'s phase
3a traffic (its R-MAT GraphService, commit stream and query sources, with
that script's own constants and ``ladder_round``) through fresh services
in the order single, lanes, lanes, single, where

  * ``single`` is the port as it is, and
  * ``lanes`` routes ``bfs``/``sssp``/``bc_dependencies`` and the delta
    rung's ``delta_bfs``/``delta_sssp``/``_delta_bc_at_cut`` through their
    lane forms at ``L = 1`` for the run (module attributes patched and
    restored).

For each run it times every ladder round unprofiled (CUDA synchronised),
profiles round ``RING_DEPTH`` with ``torch.profiler`` (kernel launches,
device time: ``profile_port.profile_window``) and counts the host reads
of round ``RING_DEPTH + 1`` (``chip_smoke.host_reads``).  It checks that
both routes give the same replies bit for bit, prints each run and one
JSON line.  It needs CUDA and exits nonzero without it.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("single", "lanes", "lanes", "single")


def lane_routes(queries, inc):
    """``{(module, name): one-lane replacement}`` for the lane route."""
    def one(res):
        return type(res)(*(x[0] for x in res))

    def stack(res):
        return type(res)(*(x[None] for x in res))

    def src1(state, src):
        return queries._as_src(state, src).reshape(1)

    def full(lanes):
        return lambda state, src: one(lanes(state, src1(state, src)))

    routes = {}
    for mod in (queries, inc):
        routes[mod, "bfs"] = full(queries.bfs_lanes)
        routes[mod, "sssp"] = full(queries.sssp_lanes)
        routes[mod, "bc_dependencies"] = full(queries.bc_dependencies_lanes)
    routes[inc, "delta_bfs"] = lambda state, prior, dirty, src: one(
        inc.delta_bfs_lanes(state, stack(prior), dirty[None],
                            src1(state, src)))
    routes[inc, "delta_sssp"] = lambda state, prior, dirty, src: one(
        inc.delta_sssp_lanes(state, stack(prior), dirty[None],
                             src1(state, src)))
    routes[inc, "_delta_bc_at_cut"] = lambda state, prior, cut, src: one(
        inc.delta_bc_at_cut_lanes(state, stack(prior), [int(cut)],
                                  src1(state, src)))
    return routes


class routed:
    """Patch the module attributes of ``routes`` for a ``with`` block."""

    def __init__(self, routes):
        self.routes = routes
        self.saved = {}

    def __enter__(self):
        for (mod, name), fn in self.routes.items():
            self.saved[mod, name] = getattr(mod, name)
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def run(torch, smoke, profile_window, state, stream, sources, label):
    """One service through the whole stream: per-round walls, one
    profiled round, one round's host reads, and every reply."""
    from repro_torch.engine import GraphService

    svc = GraphService(state, ring_depth=smoke.RING_DEPTH,
                       batch_size=smoke.BATCH_SIZE)
    walls, replies, row, reads = [], [], None, None
    for i, ops in enumerate(stream):
        def rnd(i=i, ops=ops):
            replies.extend(smoke.ladder_round(svc, ops, sources, i))

        if i == smoke.RING_DEPTH:
            row = profile_window(torch, f"ladder round {i}, {label}", rnd)
        elif i == smoke.RING_DEPTH + 1:
            reads = smoke.host_reads(torch, rnd)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rnd()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    return {"route": label, "round_ms": walls, "sum_ms": sum(walls),
            "profiled": row, "host_reads": reads,
            "modes": svc.stats.as_dict()}, replies


def same_replies(torch, a, b) -> bool:
    return len(a) == len(b) and all(
        ka == kb and sa == sb and ma == mb and ra.version == rb.version
        and ra.mode == rb.mode
        and all(torch.equal(x, y) for x, y in zip(ra.result, rb.result))
        for (ka, sa, ma, ra), (kb, sb, mb, rb) in zip(a, b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("lanes_at_one: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import numpy as np

    import chip_smoke as smoke
    from profile_port import profile_window
    from repro_torch.core import queries
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.engine import incremental as inc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    state = load_rmat_graph(smoke.N_VERTICES, smoke.N_EDGES, seed=smoke.SEED,
                            device="cuda")
    stream, hot_base = smoke.commit_stream(
        np, np.random.default_rng(smoke.SEED), smoke.N_VERTICES)
    sources = smoke.query_sources(torch, state, hot_base)
    routes = {"single": {}, "lanes": lane_routes(queries, inc)}

    # warm-up: each route's ops and kernels once, untimed
    for label in ("single", "lanes"):
        svc = GraphService(state, ring_depth=smoke.RING_DEPTH,
                           batch_size=smoke.BATCH_SIZE)
        with routed(routes[label]):
            for i in range(2):
                smoke.ladder_round(svc, stream[i], sources, i)
    del svc

    out, first = [], {}
    for label in ORDER:
        with routed(routes[label]):
            row, replies = run(torch, smoke, profile_window, state, stream,
                               sources, label)
        first.setdefault(label, replies)
        p = row["profiled"]
        print(f"  {label}: rounds {row['sum_ms']:.1f} ms unprofiled over "
              f"{len(row['round_ms'])} (median "
              f"{sorted(row['round_ms'])[len(row['round_ms']) // 2]:.2f}); "
              f"profiled round {p['launches']} launches, {p['device_ms']:.2f}"
              f" ms device; {row['host_reads']} host reads a round; "
              f"{row['modes']}", flush=True)
        out.append(row)
    same = same_replies(torch, first["single"], first["lanes"])
    print(f"  replies bit-identical across routes: {same}", flush=True)
    print(json.dumps({"device": smi, "n": smoke.N_VERTICES, "same": same,
                      "runs": out}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
