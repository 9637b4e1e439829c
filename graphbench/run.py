#!/usr/bin/env python3
"""Run one cell of the benchmark once (see ``graphbench/harness.py``).

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout: the program is read from ``src/``.
"""
import os
import sys
import time

T_START = time.perf_counter()


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    from graphbench import harness

    return harness.main(sys.argv[1:], root,
                        min(T_START, harness.process_start()))


if __name__ == "__main__":
    sys.exit(main())
