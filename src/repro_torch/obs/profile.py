"""Per-span device-time attribution (port of ``repro.obs.profile``).

The query spans measure host wall time.  The reference attributes device
time by the dispatch gap: a jitted collect returns as soon as its programs
are enqueued, and the time spent in ``block_until_ready`` afterwards is
device work the host had not waited for.  That reading means nothing here:
the port's ladder synchronises inside every rung (``bool(...)`` and
``int(...)`` of device scalars decide the next step), so a block after the
fact finds the stream already drained and reads about 0.

:class:`DeviceTimer` therefore brackets the work instead.  ``region(name,
device)`` is a context around one collect:

  * on a CUDA device it records a ``torch.cuda.Event(enable_timing=True)``
    on the current stream of the calling thread at entry and another at
    exit, and ``us`` reads ``start.elapsed_time(end)`` once the end event
    has synchronised.  That is the stream's elapsed time between the two
    records, host gaps included: on a host-bound ladder it is close to the
    wall, and it is never 0 for a collect that launched anything;
  * on the CPU it reads ``time.perf_counter`` at entry and exit: CPU ops
    run synchronously, so the interval is the work itself.  This is the
    clock of a CPU result, not a fallback: a CUDA result is never timed on
    the host.

The events are recorded on the stream current in the thread that launches
the work, so a query issued from a dispatcher thread is timed on that
thread's stream.  ``measure(result)`` keeps the reference's dispatch-gap
reading for API parity (it synchronises the result's device and times
the wait).  Every region is wrapped in ``torch.profiler.record_function``
named after its span, so a :func:`profiler_trace` timeline carries the
same boundaries the JSONL trace does.

:class:`NullDeviceTimer` is the null object: no events, no
synchronisation, ``us`` 0.0.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch

__all__ = ["DeviceTimer", "NullDeviceTimer", "block_until_ready",
           "profiler_trace"]


def _tensors(tree):
    """Every tensor in a (nested) tuple / list / dict / NamedTuple."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Wait for every CUDA device that holds a tensor of ``tree``; returns
    ``tree`` (the counterpart of ``jax.block_until_ready``)."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class _Region:
    """One timed interval; ``us`` is read lazily, after the work."""

    __slots__ = ("cuda", "_start", "_end", "_t0", "_t1", "_us")

    def __init__(self, device):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._us: Optional[float] = None
        if self.cuda:
            stream = torch.cuda.current_stream(device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(stream)
        else:
            self._t0 = time.perf_counter()

    def close(self, device) -> None:
        if self.cuda:
            self._end.record(torch.cuda.current_stream(device))
        else:
            self._t1 = time.perf_counter()

    @property
    def us(self) -> float:
        if self._us is None:
            if self.cuda:
                self._end.synchronize()
                self._us = self._start.elapsed_time(self._end) * 1e3
            else:
                self._us = (self._t1 - self._t0) * 1e6
        return self._us


class _NullRegion:
    __slots__ = ()
    cuda = False
    us = 0.0


_NULL_REGION = _NullRegion()


class DeviceTimer:
    """Device-time attribution by bracketing (the default).

    ``region(name, device)`` times the work inside it on ``device``'s own
    clock (module docstring); ``measure(result, name)`` synchronises the
    result's device and returns the wait.  ``total_us`` and ``measures``
    accumulate over both, so a caller can difference them per query.
    """

    blocking = True

    def __init__(self, annotate: bool = True):
        self.annotate = annotate
        self.total_us = 0.0
        self.measures = 0

    def _annotation(self, name: str):
        return (torch.profiler.record_function(name) if self.annotate
                else nullcontext())

    @contextmanager
    def region(self, name: str = "device", device=None):
        """Time the block on ``device`` (CUDA events, or the host clock for
        the CPU); read the yielded region's ``us`` after the block."""
        reg = _Region(device)
        try:
            with self._annotation(name):
                yield reg
        finally:
            reg.close(device)
        self.total_us += reg.us
        self.measures += 1

    def measure(self, result, name: str = "device") -> float:
        t0 = time.perf_counter()
        with self._annotation(name):
            block_until_ready(result)
        us = (time.perf_counter() - t0) * 1e6
        self.total_us += us
        self.measures += 1
        return us


class NullDeviceTimer:
    """No events, no synchronisation: every reading is 0.0."""

    blocking = False
    total_us = 0.0
    measures = 0

    @contextmanager
    def region(self, name: str = "device", device=None):
        yield _NULL_REGION

    def measure(self, result, name: str = "device") -> float:
        return 0.0


def profiler_trace(logdir: str) -> Optional[object]:
    """Start a ``torch.profiler`` session (CPU, plus CUDA when available).

    Returns a closer whose ``.close()`` stops the session and exports a
    Chrome trace to ``logdir/trace.json``, or ``None`` when the profiler
    cannot start: the session is extra visibility, never a dependency.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception:
        return None

    class _Session:
        path = os.path.join(logdir, "trace.json")

        def close(self):
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(self.path)

    return _Session()
