#!/usr/bin/env python3
"""The min-plus product at the shapes its paths give it, on one GPU.

    python3 tools/minplus_mm_shapes.py [--src DIR] [--time] [--rows M,...]

``DIR`` (default: this checkout's ``src``) is the ``src`` directory of the
tree whose ``repro_torch`` is measured, so that two trees can be compared
in one run on one card (run them in turns: A, B, B, A).  The operands are
``chip_smoke.py``'s own, made with its constants and its ``Capture``: the
live weights of R-MAT(16384, 163840, seed 0) (+inf where there is no edge)
and the distance matrix of the widest relax pass of ``sssp_batched_ops``
from sources 0 .. 2047 (pass 3, 17.51% of it finite, as the
``captured:`` line of ``chip_smoke.py`` prints it for the 3b queries),
found with the tree's own dense product.  Everything goes through
``ops.minplus_mm_against``, as the queries call it:

  * static  -- one row (source 0's distances at that pass) against the
               weights with no mask: the call that the Section 5
               workload's static mode makes on every relax pass;
  * dense   -- S = 2048, no mask: ``sssp_batched_dense`` without a tile
               view;
  * masked  -- S = 2048 with the tile view's 128-tile occupancy, as 3b's
               masked query runs it.

Each is held bit for bit against the tree's plain ``minplus_mm_plain``
(on the first 256 rows for S = 2048).  With ``--time`` it also prints the
median of REPS CUDA-event timings of one product after one warm-up (its
padding, slab mask and launch included, as the queries pay them), and for
each of ``--rows`` a dense product of that many rows of the pass (the
choice between the kernel's skinny and wide forms), and reads the card's
SM clock and power draw with nvidia-smi while LOAD_CALLS dense S = 2048
products run (the bound assumes the boost clock).  The last line is one
JSON object with the card's name and power limit.  It needs CUDA and exits
nonzero without it.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
LOAD_CALLS = 30


def time_ms(torch, fn) -> float:
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


def smi_query(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--rows", default="",
                    help="comma-separated row counts to time densely")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("minplus_mm_shapes: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as smoke
    from repro_torch.core import queries
    from repro_torch.core.tiles import build_tile_view, dense_views_from_tiles
    from repro_torch.data import load_rmat_graph
    from repro_torch.kernels import minplus_mm as kmp
    from repro_torch.kernels import ops as kops

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_query("name,power.limit")
    V = smoke.N_VERTICES
    state = load_rmat_graph(V, smoke.N_EDGES, seed=smoke.SEED, device="cuda")
    view = build_tile_view(state)
    _, w, alive = dense_views_from_tiles(state, view)
    big = torch.where(alive[:, None] & alive[None, :], w,
                      torch.tensor(float("inf"), device="cuda"))
    del w, state
    dense = kops.minplus_mm_against(big)
    masked = kops.minplus_mm_against(big, amask=view.occ, tile=view.tile)
    cap = smoke.Capture(dense, big, torch.isfinite)
    srcs = torch.arange(smoke.SRC_CHUNK, dtype=torch.int32, device="cuda")
    queries.sssp_batched_ops(cap, srcs, alive, V)
    d = cap.wide
    finite = float(torch.isfinite(d).float().mean())
    out = {"src": os.path.relpath(os.path.abspath(args.src), ROOT),
           "device": smi, "bm": kmp.BM, "pass": cap.wide_level,
           "finite": finite, "shapes": []}
    print(f"  widest pass {cap.wide_level} of {cap.calls}: {d.shape[0]} x "
          f"{V}, {finite:.4f} finite", flush=True)
    d1 = d[:1].contiguous()
    dr = d[:smoke.PLAIN_ROWS]
    for what, product, x, plain_x in (("static", dense, d1, d1),
                                      ("dense", dense, d, dr),
                                      ("masked", masked, d, dr)):
        got = product(x)
        exp = kmp.minplus_mm_plain(plain_x, big)
        torch.cuda.synchronize()
        if not torch.equal(got[:plain_x.shape[0]], exp):
            raise AssertionError(f"minplus_mm {what} != minplus_mm_plain")
        row = {"what": what, "m": x.shape[0], "k": V, "n": V,
               "bit_exact": True}
        if args.time:
            row["ms"] = time_ms(torch, lambda: product(x))
        print(f"  {what} ({x.shape[0]} x {V} x {V}): bit-exact against "
              f"minplus_mm_plain" + (f", {row['ms']:.4f} ms" if args.time
                                     else ""), flush=True)
        out["shapes"].append(row)
        del got, exp
    for m in (int(r) for r in args.rows.split(",") if r):
        x = d[:m].contiguous()
        row = {"what": "rows", "m": m, "k": V, "n": V}
        if args.time:
            row["ms"] = time_ms(torch, lambda: dense(x))
            print(f"  rows {m}: {row['ms']:.4f} ms", flush=True)
        out["shapes"].append(row)
    if args.time:
        for _ in range(LOAD_CALLS):  # queued: the card runs them while
            dense(d)                 # nvidia-smi reads it
        out["under_load"] = smi_query("clocks.sm,power.draw")
        torch.cuda.synchronize()
        print(f"  during {LOAD_CALLS} dense products: clocks.sm, power.draw "
              f"= {out['under_load']}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
