#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` for the program and for the
control, on several seeds, in one process.

    python3 graphbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10

For each seed one run of the cell at its own load (``--seconds`` long),
then the comparison twice on the same sample: the program's replies
against the reference, and the control's (the reference's answer at a
neighbouring version standing in the program's place) against the
reference.  One JSON line per seed.  The benchmark's own runs never run
the control.
"""
import argparse
import json
import os
import sys


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    from graphbench import harness, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("control: torch.cuda.is_available() is false")
    cell = spec.resolve(root, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = harness.run_cell(cell, seed, args.seconds, trace=False,
                               control=True)
        print(json.dumps({
            "seed": seed, "correct": out["correct"],
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": out["control"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "notes": out["notes"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
