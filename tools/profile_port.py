#!/usr/bin/env python3
"""Where the port's main path spends its time on one NVIDIA GPU.

    python3 tools/profile_port.py

Replays ``chip_smoke.py``'s main-path traffic with that script's own
constants and helpers: the same R-MAT GraphService, a cold all-vertex
``bc_scores``, then the first ``RING_DEPTH`` batches of its commit stream,
each followed by its BFS/SSSP/BC queries.  Then it profiles, with
``torch.profiler`` (CPU + CUDA activities):

  * ``bc_scores delta`` -- the delta ``bc_scores`` call the smoke makes
    after those commits;
  * ``ladder round``   -- the stream's next batch and its nine queries.

For each window it prints the host wall time, the summed device time of
every kernel, the device busy share (device time / wall; the profiler's
own host overhead lengthens the wall), and the kernels that take the most
device time, then one JSON line with the same numbers.
It needs CUDA and exits nonzero without it.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_window(torch, name, fn, top=8):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Only device-side events: a CPU op (aten::*) also carries the device
    # time of the kernels it launched, which would count them twice.
    rows = [(evt.key, evt.count, _device_us(evt))
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    device_us = sum(r[2] for r in rows)
    print(f"== {name}: wall {wall_us / 1e3:.1f} ms, device {device_us / 1e3:.1f}"
          f" ms, busy {device_us / wall_us:.3f}", flush=True)
    for key, count, us in rows[:top]:
        print(f"  {us / 1e3:10.2f} ms  {us / device_us:6.3f}  x{count:<6d} "
              f"{key[:90]}", flush=True)
    return {"window": name, "wall_ms": wall_us / 1e3,
            "device_ms": device_us / 1e3, "busy": device_us / wall_us,
            "top": [{"kernel": k[:120], "count": c, "ms": us / 1e3}
                    for k, c, us in rows[:top]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_port: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    import chip_smoke as smoke
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    state = load_rmat_graph(smoke.N_VERTICES, smoke.N_EDGES, seed=smoke.SEED,
                            device="cuda")
    svc = GraphService(state, ring_depth=smoke.RING_DEPTH,
                       batch_size=smoke.BATCH_SIZE)
    rng = np.random.default_rng(smoke.SEED)
    stream, hot_base = smoke.commit_stream(np, rng, smoke.N_VERTICES)
    sources = smoke.query_sources(torch, state, hot_base)

    svc.bc_scores(src_chunk=smoke.SRC_CHUNK)
    for i in range(smoke.RING_DEPTH):
        smoke.ladder_round(svc, stream[i], sources, i)
    nxt = smoke.RING_DEPTH
    out = [profile_window(torch, "bc_scores delta",
                          lambda: svc.bc_scores(src_chunk=smoke.SRC_CHUNK)),
           profile_window(torch, "ladder round",
                          lambda: smoke.ladder_round(svc, stream[nxt],
                                                     sources, nxt))]
    print(f"  bc_scores modes {svc.bc_scores_stats}; ladder {vars(svc.stats)}")
    print(json.dumps({"device": smi, "n": smoke.N_VERTICES, "windows": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
