"""A profiled slice of a run: what ran on the device, when, and what the host
was doing in the device's idle gaps (``torch.profiler``, CPU and CUDA
activities).

Device time is the union of the intervals of every device operation the
trace holds (kernels, copies, sets); ranges the profiler draws on the
device timeline for a host annotation are left out, since they only span
other operations.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

from . import stats


@dataclass
class Trace:
    """Device and host intervals of one slice, in seconds from its start."""

    window_s: float
    device: list = field(default_factory=list)   # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name)
    untraced: str = "no traced host op"          # a gap no host span meets

    @property
    def busy_s(self) -> float:
        w = self.window_s
        return stats.union_length([(max(s, 0.0), min(e, w))
                                   for s, e, _ in self.device])

    def device_seconds(self, match) -> float:
        """Summed duration of the device operations whose name ``match``
        accepts."""
        return sum(e - s for s, e, name in self.device if match(name))

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for s, e, name in self.device:
            by[short(name)] += e - s
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The ``k`` longest idle gaps, each named by the device operations
        around it and the host operation that overlaps it most."""
        ivs = sorted((s, e) for s, e, _ in self.device)
        gaps = stats.gaps(ivs, 0.0, self.window_s)
        gaps.sort(key=lambda g: g[0] - g[1])
        ends = sorted((e, name) for s, e, name in self.device)
        out = []
        for g0, g1 in gaps[:k]:
            before = [name for e, name in ends if e <= g0 + 1e-9]
            prev = short(before[-1]) if before else "start"
            host = _busiest_host(self.host, g0, g1, self.untraced)
            out.append([f"after {prev}; host: {host}", g1 - g0])
        return out


def short(name: str, width: int = 80) -> str:
    name = " ".join(name.split())
    return name if len(name) <= width else name[:width - 3] + "..."


def _busiest_host(host, g0: float, g1: float, untraced: str) -> str:
    best, best_len = untraced, 0.0
    for s, e, name in host:
        if e - s > 2.0 * (g1 - g0) + 0.05:
            continue            # a range around everything says nothing
        ov = min(e, g1) - max(s, g0)
        if ov > best_len:
            best, best_len = short(name, 60), ov
    return best


def _is_annotation(evt) -> bool:
    return bool(getattr(evt, "is_user_annotation", False))


def initialize() -> None:
    """One empty profiling session at set-up: the profiler sets itself up
    here, not inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


class Slice:
    """``with Slice() as sl: ...`` profiles the body; ``sl.read()`` parses
    the intervals afterwards (parsing many events holds the interpreter
    for seconds, so a slice is read after the work it covers).
    ``Slice(enabled=False)`` profiles nothing and reads ``None``."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.window = 0.0
        self._prof = None

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import torch

        torch.cuda.synchronize()
        self.window = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)
        return False

    def read(self):
        """The slice's ``Trace``."""
        if self._prof is None:
            return None
        from torch.autograd import DeviceType

        events = self._prof.events()
        # event times count from the profiler's start (microseconds); an
        # older profiler that gives absolute times counts from its first
        starts = [e.time_range.start for e in events]
        base = min(starts, default=0.0)
        base = 0.0 if base < 60e6 else base
        dev, host = [], []
        for e in events:
            s = (e.time_range.start - base) / 1e6
            t = (e.time_range.end - base) / 1e6
            if e.device_type == DeviceType.CUDA:
                if not _is_annotation(e):
                    dev.append((s, t, e.name))
            elif e.device_type == DeviceType.CPU and not _is_annotation(e):
                host.append((s, t, e.name))
        self._prof = None
        return Trace(self.window, dev, host)
