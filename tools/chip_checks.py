#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s checks alone, on one NVIDIA GPU, in a few
minutes instead of the whole script's twenty.

    python3 tools/chip_checks.py [--dist-only] [--commits 2]
                                 [--ring-commits 2]

It builds the kernels, then (unless ``--dist-only``) holds and times
``flash_attention`` at the mesh's prefill shapes (``mesh_flash_shapes``)
and runs phase 3i's resume from the reference's checkpoint layout
(``reference_resume``); then phases 3g and 3j (the front end over the
processes included) with the commit stream cut to ``--commits`` commits
and 3j's ring run to ``--ring-commits`` (3j's delta-rung check needs at
least 2).  The checks are ``chip_smoke.py``'s own functions, so what they
hold is what the whole script holds.  It needs CUDA and exits nonzero
without it.
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dist-only", action="store_true",
                    help="skip the flash shapes and the resume")
    ap.add_argument("--commits", type=int, default=2)
    ap.add_argument("--ring-commits", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_checks: torch.cuda.is_available() is false")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    build.load_all(sorted({src for src, _ in cs.KERNELS.values()}))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if not args.dist_only:
        t0 = time.perf_counter()
        cs.mesh_flash_shapes(torch, cs.ErrLog())
        print(f"mesh flash shapes {time.perf_counter() - t0:.1f} s",
              flush=True)
        root = tempfile.mkdtemp()
        try:
            print("resume launches", cs.reference_resume(torch, {}, root),
                  flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    cs.COMMITS = cs.GATHER_COMMITS = args.commits
    cs.RING_COMMITS = args.ring_commits
    timings = {}
    t0 = time.perf_counter()
    _, ref = cs.sharded_phase(torch, np, timings)
    print(f"3g {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(cs.dist_phase(torch, np, timings, ref), flush=True)
    print(f"3j {time.perf_counter() - t0:.1f} s", timings, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
