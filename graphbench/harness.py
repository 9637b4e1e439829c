"""Run one cell once and print its result line.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (process start to the window's opening: imports, CUDA, the graph
drawn and loaded, kernels built or loaded, warm-up on the cell's own
traffic), the window, then, once the window has closed and the peak memory
has been read, the comparison with the plain reference.  With ``--trace
0`` the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiled slice of the window and the
program's counters.  The last line on standard output is one JSON object;
the compared numbers, each with its limit, end standard error and the
result line.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from dataclasses import dataclass, field

from . import check, drivers, graphs, profiling, spec, system, traffic

#: top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux: from
    ``/proc``), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules(modules=None):
    """Loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclass
class Context:
    """What a driver gets: the cell's files, the generated graph and the
    service over it."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    rngs: object                     # traffic.Streams
    n: int = 0
    src: object = None
    dst: object = None
    w: object = None
    weights: object = None           # the deployment's weight draw
    hot_base: int = 0
    svc: object = None
    history: list = field(default_factory=list)

    @staticmethod
    def before_window() -> None:
        """Move every object the set-up made (the imports' hundreds of
        thousands among them) out of the collector's reach: a full
        collection then scans only what the window allocates, instead of
        stopping every thread for a tenth of a second or more."""
        gc.collect()
        gc.freeze()

    def memory_peak(self) -> int:
        if self.device == "cpu":
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated())

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic


@dataclass
class Readings:
    """What a per-layer metric reader gets."""

    counters: dict
    trace: object
    work: list
    work_trace: object
    e2e: dict


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             control: bool = False) -> dict:
    """Run ``cell`` once; the result line as a dict (with ``control``, the
    control's numbers under ``"control"``)."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    system.check_interface()
    rngs = traffic.streams(seed, cell.config["data_seed"])
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, rngs=rngs)
    ctx.n, ctx.src, ctx.dst, ctx.w = graphs.draw(cell.config, rngs.graph,
                                                 cell.root)
    ctx.weights = graphs.weight_draw(cell.config, cell.root)
    ctx.hot_base = traffic.hot_base(rngs.hot, ctx.n,
                                    cell.traffic["updates"])
    ecap = graphs.edge_capacity(cell.config, len(ctx.src))
    ctx.svc = system.build(cell.config, ctx.n, ctx.src, ctx.dst, ctx.w, ecap,
                           device)
    if device != "cpu":
        torch.cuda.synchronize()
        if trace:
            profiling.initialize()
        torch.cuda.reset_peak_memory_stats()
    try:
        run = drivers.DRIVERS[cell.traffic["kind"]](ctx)
    finally:
        gc.unfreeze()
    setup_s = run.t0 - t_start
    peak = run.memory_peak

    metrics = {}
    if trace:
        readings = Readings(run.counters, run.trace, run.work,
                            run.work_trace, run.e2e)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # the comparison, once the program's state is freed
    ctx.svc = None
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = _numbers(ctx, run, control)
    run.notes["check_s"] = time.perf_counter() - t_check
    ctrl = None
    if control:
        numbers, ctrl = numbers
    correct, checks = check.verdict(numbers, cell.limits)
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["notes"] = run.notes
    if ctrl is not None:
        out["control"] = ctrl
    out["checks"] = checks
    return out


def _numbers(ctx, run, control):
    def graph0():
        from .reference.graph import Graph
        return Graph(ctx.n, ctx.src, ctx.dst, ctx.w)

    return check.refresh_numbers(graph0, run, ctx.rngs.check,
                                 ctx.traffic["check"], ctx.device,
                                 control=control)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(out: dict) -> None:
    """The compared numbers on standard error, then the result line."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv, root: str, t_start: float) -> int:
    args = parse(argv)
    import torch

    cell = spec.resolve(root, args.workload)
    if not torch.cuda.is_available():
        print("graphbench: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"graphbench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"graphbench: the measuring process loaded {bad}",
              file=sys.stderr)
        return 3
    emit(out)
    return 0
