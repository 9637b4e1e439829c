#!/usr/bin/env python3
"""The masked counting product of one BC refresh, in several trees, on one
GPU.

    python3 tools/count_mm_ab.py [--src DIR ...] [--workload CELL]
        [--seed N] [--steps K] [--device cuda|cpu] [--root DIR]

Each ``--src`` (the ``src`` directory of a tree whose ``repro_torch`` is
measured; default this checkout's) runs in a process of its own, in the
order given, so that two trees are compared on one card in turns (A, B, B,
A).  In each:

  * one cold refresh of the benchmark cell's initial graph, drawn by
    ``graphbench`` as the cell draws it (``--root``: the directory holding
    ``BENCHMARK.json``, this checkout by default), with every counting
    product that ``semiring.count_mm_against`` builds recorded: a SHA-256
    of each left operand and of each output, and, after the refresh, each
    product run again on its own operand (kept on the host meanwhile): the
    median of REPS CUDA-event timings (after one warm-up) and its kernels'
    device time by ``torch.profiler``;
  * ``K`` batches of the cell's update stream (drawn from ``--seed`` as
    the cell draws them), each committed and followed by a delta refresh,
    with a SHA-256 of each refresh's scores;
  * the raw ``count_mm_masked`` at 16384^3 with every pair dead, timed the
    same way: once with the left mask all live and ``amask`` all zero, once
    the other way round.  The left operand is all ones, so that every slab
    holds entries and only the masks kill the pairs.

Then it prints whether every tree gave the same digests (products and
scores equal bit for bit where they do) and each tree's times.  The last line is one JSON
object with the card's name and power limit.  ``--device cpu`` rehearses
the digests alone on the CPU (use a small ``--root``, such as the one
``graphbench/tests/gb_tiny.py`` makes) and times nothing.
"""
import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
DEAD_N = 16384


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def time_ms(torch, fn) -> float:
    """Median of REPS CUDA-event timings of ``fn``, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_ms(torch, fn) -> dict:
    """Device ms per call of ``fn`` by kernel name, over REPS profiled
    calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us and ("count_mm" in e.key or "split3" in e.key):
            out[e.key] = us / 1e3 / REPS
    return out


def worker(args) -> dict:
    """One tree's digests and times (run in a process of its own)."""
    (src_dir,) = args.src
    sys.path[:0] = [os.path.abspath(src_dir), ROOT]
    import torch

    from graphbench import graphs, spec, system, traffic
    from repro_torch.core import semiring
    from repro_torch.engine import GraphService
    from repro_torch.kernels import count_mm as kc

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.exit("count_mm_ab: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.resolve(args.root, args.workload)
    cfg = cell.config
    rngs = traffic.streams(args.seed, cfg["data_seed"])
    n, src, dst, w = graphs.draw(cfg, rngs.graph, cell.root)
    svc = system.build(cfg, n, src, dst, w,
                       graphs.edge_capacity(cfg, len(src)), args.device)
    svc.bc_scores()                      # builds the kernels
    fresh = GraphService(svc.ring.latest.state, **{
        k: int(v) for k, v in cfg["service"].items()})
    del svc
    products = []
    orig = semiring.count_mm_against

    def recorded(a, *pa, **kw):
        product = orig(a, *pa, **kw)

        def run(x):
            out = product(x)
            kept = x.detach().cpu()       # the host holds every operand
            products.append((product, kept, digest(kept), digest(out)))
            return out
        return run

    semiring.count_mm_against = recorded
    try:
        fresh.bc_scores()
    finally:
        semiring.count_mm_against = orig
    res = {"src": os.path.relpath(os.path.abspath(src_dir), ROOT),
           "digests": [[dx, do] for _, _, dx, do in products],
           "shapes": [list(x.shape) for _, x, _, _ in products]}
    upd = cell.traffic["updates"]
    for ops in traffic.update_batches(
            rngs.updates, n, args.steps, upd,
            graphs.weight_draw(cfg, cell.root),
            traffic.hot_base(rngs.hot, n, upd), rngs.order, cell.root):
        fresh.submit_many(ops)
        fresh.flush()
        scores, version = fresh.bc_scores()
        res["digests"].append([version, digest(scores)])
    if not cuda:
        return res
    if hasattr(kc, "read_pairs"):
        kc.reset_pairs()
    res["product_ms"], res["refresh_kernel_ms"] = [], {}
    for product, kept, _, _ in products:
        x = kept.to(args.device)
        res["product_ms"].append(time_ms(torch, lambda: product(x)))
        for name, ms in kernel_ms(torch, lambda: product(x)).items():
            res["refresh_kernel_ms"][name] = res["refresh_kernel_ms"].get(
                name, 0.0) + ms
        del x
    if hasattr(kc, "read_pairs"):
        tally = kc.read_pairs()
        res["kernel_live_pair_share"] = tally["live_pairs"] / tally["pairs"]
        res["zero_tiles_per_product"] = tally["zero_tiles"] / tally[
            "launches"]
    del products
    s = torch.ones((DEAD_N, DEAD_N), device="cuda")
    a = torch.zeros((DEAD_N, DEAD_N), device="cuda")
    planes = kc.right_planes(a)
    nb_m, nb_k, nb_n = DEAD_N // kc.BM, DEAD_N // kc.BK, DEAD_N // kc.BN
    ones = torch.ones((nb_m, nb_k), dtype=torch.int32, device="cuda")
    res["dead"] = {}
    for case, sm, am in (
            ("smask live, amask zero", ones,
             torch.zeros((nb_k, nb_n), dtype=torch.int32, device="cuda")),
            ("smask zero, amask live", torch.zeros_like(ones),
             torch.ones((nb_k, nb_n), dtype=torch.int32, device="cuda"))):
        def call(sm=sm, am=am):
            return kc.count_mm_masked(s, a, sm, am, planes)
        assert not call().any()
        res["dead"][case] = {"call_ms": time_ms(torch, call),
                             "kernel_ms": kernel_ms(torch, call)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append")
    ap.add_argument("--workload", default="graph500_s14.bc_refresh")
    ap.add_argument("--seed", type=int, default=4290000001)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args)), flush=True)
        return 0
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
    runs = []
    for src in args.src or [os.path.join(ROOT, "src")]:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", "--src",
             src, "--workload", args.workload, "--seed", str(args.seed),
             "--steps", str(args.steps),
             "--device", args.device, "--root", args.root],
            capture_output=True, text=True)
        if done.returncode:
            sys.stderr.write(done.stderr[-6000:])
            sys.exit(f"count_mm_ab: the run of {src} failed")
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        print(f"{r['src']}: {len(r['shapes'])} products, "
              f"{len(r['digests']) - len(r['shapes'])} delta refreshes, "
              f"ms {r.get('product_ms')}, sum "
              f"{sum(r.get('product_ms', [0.0])):.3f}, kernels "
              f"{r.get('refresh_kernel_ms')}, live share "
              f"{r.get('kernel_live_pair_share')}, dead {r.get('dead')}",
              flush=True)
    same = all(r["digests"] == runs[0]["digests"] for r in runs)
    print(f"digests equal across every run: {same}", flush=True)
    print(json.dumps({"card": card, "workload": args.workload,
                      "seed": args.seed, "bit_identical": same,
                      "runs": runs}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
