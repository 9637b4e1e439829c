"""Heartbeat / straggler detection (port of the ``HeartbeatMonitor`` of
``repro.runtime.fault_tolerance``).

``HeartbeatMonitor`` keeps a rolling window of latencies; a measurement
slower than ``factor`` x the rolling median raises a straggler flag.  Its
consumer is the serving stack: pass one as ``StreamScheduler(monitor=...)``
(or the ``monitor=`` keyword of ``GraphService``) and it watches **commit
latency** -- a slow ``apply_ops``/ring append flags the commit, bumps the
``scheduler_stragglers`` counter, and annotates the commit's trace span
with ``straggler=True``.

The reference's ``RestartableLoop`` wraps a training step with checkpoint
and restart; it waits for the port's training loop.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from typing import Callable, Optional


class HeartbeatMonitor:
    """Rolling-median latency watchdog (``start()``/``stop(step)`` around
    each unit of work).  ``stop`` returns the measured seconds and, once
    the window has >= 8 samples, counts/calls back on measurements over
    ``factor`` x the median."""

    def __init__(self, window: int = 32, factor: float = 3.0,
                 on_straggler: Optional[Callable] = None):
        self.window = deque(maxlen=window)
        self.factor = factor
        self.on_straggler = on_straggler
        self.stragglers = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int):
        dt = time.perf_counter() - self._t0
        if len(self.window) >= 8:
            med = statistics.median(self.window)
            if dt > self.factor * med:
                self.stragglers += 1
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.window.append(dt)
        return dt
