#!/usr/bin/env python3
"""How far every vertex's betweenness lands from the float64 reference when
it is computed in a lower precision (on the card).

    python3 tools/bc_lower_precision.py [--workload ssca2_s14.paper_churn]
        [--seed N] [--versions 0,16,32]

Draws the cell's initial graph and its first batches in the order the seed
gives them, and at each version computes the scores as
``graphbench.reference.bc_all`` does, in float64, and again with the
adjacency, the counts, the dependencies and the products held in float32,
bfloat16 and float16.  Prints, per precision and version, the numbers the
cell's check compares with the float64 scores (``bc_score_gap``,
``alive_mismatch``), each beside its limit, and one JSON object last.
"""
import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

PRECISIONS = ("float32", "bfloat16", "float16")


def bc_scores(e, dtype, device, block: int = 4096):
    """``bc_all.bc_scores`` with every array and product in ``dtype``."""
    import torch

    n, dev = e.n, torch.device(device)
    a = torch.zeros((n, n), dtype=dtype, device=dev)
    a[torch.as_tensor(e.src, device=dev),
      torch.as_tensor(e.dst, device=dev)] = 1.0
    alive = torch.as_tensor(e.alive, device=dev)
    scores = torch.zeros(n, dtype=torch.float64, device=dev)
    for s0 in range(0, n, block):
        srcs = torch.arange(s0, min(n, s0 + block), device=dev)
        rows = torch.arange(srcs.numel(), device=dev)
        ok = alive[srcs]
        sigma = torch.zeros((srcs.numel(), n), dtype=dtype, device=dev)
        sigma[rows, srcs] = ok.to(dtype)
        level = torch.full(sigma.shape, -1, dtype=torch.int32, device=dev)
        level[rows[ok], srcs[ok]] = 0
        front, lvl = sigma, 0
        while bool(front.any()):
            adds = front @ a
            newly = (adds > 0) & (level < 0)
            sigma = torch.where(newly, adds, sigma)
            level[newly] = lvl + 1
            front = torch.where(newly, sigma, 0.0)
            lvl += 1
        safe = torch.where(sigma > 0, sigma, 1.0)
        delta = torch.zeros_like(sigma)
        for l in range(lvl - 1, -1, -1):
            g = torch.where(level == l + 1, (1.0 + delta) / safe, 0.0)
            delta += torch.where(level == l, sigma * (g @ a.t()), 0.0)
        delta[level == 0] = 0.0
        scores += delta.sum(dim=0, dtype=torch.float64)
    return torch.where(alive, scores, math.nan)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="ssca2_s14.paper_churn")
    ap.add_argument("--seed", type=int, default=4330000001)
    ap.add_argument("--versions", default="0,16,32")
    args = ap.parse_args()
    import numpy as np
    import torch

    from graphbench import check, graphs, spec, traffic
    from graphbench.reference import bc_all
    from graphbench.reference.graph import Graph

    if not torch.cuda.is_available():
        sys.exit("bc_lower_precision: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cell = spec.resolve(ROOT, args.workload)
    cfg, upd = cell.config, cell.traffic["updates"]
    rngs = traffic.streams(args.seed, cfg["data_seed"])
    n, src, dst, w = graphs.draw(cfg, rngs.graph, ROOT)
    base = traffic.hot_base(rngs.hot, n, upd)
    versions = sorted(int(v) for v in args.versions.split(","))
    batches = traffic.update_batches(
        rngs.updates, n, max(64, versions[-1]), upd,
        graphs.weight_draw(cfg, ROOT), base, rngs.order, ROOT)
    g = Graph(n, src, dst, w)
    out = {"card": card, "workload": cell.name, "seed": args.seed,
           "limits": cell.limits, "gaps": {}}
    for v in versions:
        while g.version < v:
            g.apply(batches[g.version])
        e = g.arrays()
        want = bc_all.bc_scores(e, device="cuda").cpu().numpy()
        for name in PRECISIONS:
            got = bc_scores(e, getattr(torch, name), "cuda").cpu().numpy()
            gap = check.rel_gap(got, want)
            mismatch = int((np.isnan(got) != np.isnan(want)).sum())
            out["gaps"].setdefault(name, []).append(
                {"version": v, "bc_score_gap": gap,
                 "alive_mismatch": mismatch})
            print(f"{name} version {v}: bc_score_gap {gap!r} limit "
                  f"{cell.limits.get('bc_score_gap')!r}, alive_mismatch "
                  f"{mismatch} limit {cell.limits.get('alive_mismatch')!r}",
                  flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
