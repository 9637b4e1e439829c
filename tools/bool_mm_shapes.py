#!/usr/bin/env python3
"""The boolean product at the two shapes its paths give it, on one GPU.

    python3 tools/bool_mm_shapes.py [--src DIR] [--time]

``DIR`` (default: this checkout's ``src``) is the ``src`` directory of the
tree whose ``repro_torch`` is measured, so that two trees can be compared
in one run on one card (run them in turns: A, B, B, A).  Two shapes, K = N
= 16384 against a random {0,1} adjacency of R-MAT's density (10 edges per
vertex, seed 0):

  * M = 128  -- the Section 5 workload's static mode: one source padded to
                a row block (row 0 a one-hot, the rest zero);
  * S = 2048 -- the batched BFS: a frontier with 16% of its entries set,
                the density of the widest level of ``chip_smoke.py`` 3b.

For each it runs the tree's raw ``bool_mm`` once and holds it bit for bit
against ``bool_mm_ref``.  Where the tree packs its right operand
(``bool_mm.pack_right``), the pack is made once outside the product, as
``ops.bool_mm_against`` does.  With ``--time`` it also prints the median
of REPS CUDA-event timings of one product (after one warm-up), and of
each pack on its own.  The last line is one JSON object with the card's
name and power limit.  It needs CUDA and exits nonzero without it.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, DEGREE, SEED, FRONTIER_DENSITY = 16384, 10, 0, 0.16
REPS = 20


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("bool_mm_shapes: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import bool_mm as kb

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = (torch.rand((V, V), generator=g, device="cuda")
         < DEGREE / V).float()
    packs = hasattr(kb, "pack_right")
    packed = kb.pack_right(a) if packs else None
    kw = {} if packed is None else {"packed": packed}
    out = {"src": os.path.relpath(os.path.abspath(args.src), ROOT),
           "device": smi, "packs": packs, "shapes": []}
    for m, what in ((128, "static, one source"), (2048, "batched")):
        if m == 128:
            f = torch.zeros((m, V), device="cuda")
            f[0, 0] = 1.0
        else:
            f = (torch.rand((m, V), generator=g, device="cuda")
                 < FRONTIER_DENSITY).float()
        got = kb.bool_mm(f, a, **kw)
        exp = kb.bool_mm_ref(f, a)
        torch.cuda.synchronize()
        if not torch.equal(got, exp):
            raise AssertionError(f"bool_mm at M = {m} != bool_mm_ref")
        row = {"m": m, "k": V, "n": V, "what": what, "bit_exact": True}
        if args.time:
            row["ms"] = time_ms(torch, lambda: kb.bool_mm(f, a, **kw))
            if packs:
                row["pack_left_ms"] = time_ms(torch, lambda: kb.pack_left(f))
        print(f"  M = {m} ({what}): bit-exact against bool_mm_ref"
              + (f", {row['ms']:.4f} ms" if args.time else ""), flush=True)
        out["shapes"].append(row)
        del f, got, exp
    if args.time and packs:
        out["pack_right_ms"] = time_ms(torch, lambda: kb.pack_right(a))
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
