"""Per-program cost accounting (the port's counterpart of ``repro.obs.hlo``).

The reference re-lowers each jitted query program the first time its
signature is seen and reads XLA's ``cost_analysis`` and
``memory_analysis``.  Torch has no compiled program to ask, so the
accountant here measures the real call instead, once per signature, while
it runs: on a CUDA device the first call of a key runs between
``torch.cuda.reset_peak_memory_stats`` and
``torch.cuda.max_memory_allocated``.  The call is never re-run.  The
result is the reference's cost dict, with the reference's keys:

    {"collective_bytes": int, "collectives": {op: bytes, ...},
     "temp_bytes": int | None, "peak_bytes": int | None,
     "flops": None}

  * ``peak_bytes``: the tensor bytes of the call's arguments plus the
    allocator's high-water mark above what was allocated at entry (the
    reference's arguments + outputs + temporaries); ``temp_bytes``: the
    high-water mark above what is still allocated at exit (the
    temporaries).  ``None`` for a CPU call: the CPU has no allocator
    statistics.
  * ``flops`` is ``None``, the reference's own contract for a backend
    without the analysis.  The COO ladder queries are gathers, scatters
    and compares with no flop formula, and the hand-written kernels are
    bound through ctypes, out of any torch-level counter's sight: no op of
    the local service has flops to count.
  * ``collective_bytes`` is 0 and ``collectives`` ``{}`` here: the local
    service runs no collective.  The sharded service's queries overlay
    the bytes their collective group counted during the call
    (``repro_torch.shard.queries._account``).

Measuring resets the device's process-wide peak-memory statistics: a
reader of ``torch.cuda.max_memory_allocated`` in the same process loses
its reading at every first call of a signature.  Measurements are
serialised under one module lock, so two threads that meet new
signatures at once do not reset each other's peaks.

Costs are cached per signature, process-wide by default, like the
reference's; ``last`` holds the cost of the most recent call so the
service picks it up without widening the query functions' return types.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch

from .profile import _tensors

__all__ = ["CostAccountant", "account_call"]


#: Serialises measurements: each resets the device's peak statistics.
_MEASURE_LOCK = threading.Lock()


def _empty_cost() -> dict:
    return {"collective_bytes": 0, "collectives": {},
            "temp_bytes": None, "peak_bytes": None, "flops": None}


def measure_call(fn: Callable, *args):
    """Run ``fn(*args)`` once under the allocator's peak statistics:
    ``(result, cost dict)``.  A CUDA call holds the module lock
    throughout; a CPU call has no statistics to read."""
    cost = _empty_cost()
    tensors = list(_tensors(args))
    dev = next((t.device for t in tensors if t.is_cuda), None)
    if dev is None:
        return fn(*args), cost
    with _MEASURE_LOCK:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        result = fn(*args)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        after = torch.cuda.memory_allocated(dev)
        arg_bytes = sum(t.numel() * t.element_size() for t in tensors)
        cost["peak_bytes"] = int(arg_bytes + peak - before)
        cost["temp_bytes"] = int(peak - after)
    return result, cost


class CostAccountant:
    """Cache of program signature -> cost dict (module docstring).

    ``shared=True`` (default) keys into one process-wide cache: a
    re-created service does not measure a signature again.
    """

    _SHARED: Dict[tuple, dict] = {}

    def __init__(self, shared: bool = True):
        self._cache = CostAccountant._SHARED if shared else {}
        self.last: Optional[dict] = None

    def call(self, key: tuple, fn: Callable, *args):
        """``fn(*args)``, measured the first time ``key`` is seen."""
        cost = self._cache.get(key)
        if cost is None:
            result, cost = measure_call(fn, *args)
            self._cache[key] = cost
        else:
            result = fn(*args)
        self.last = cost
        return result

    def snapshot(self) -> dict:
        return {repr(k): v for k, v in self._cache.items()}


def account_call(accountant: Optional[CostAccountant], key: tuple,
                 fn: Callable, *args):
    """``fn(*args)``, its cost deposited with ``accountant`` (the
    counterpart of the reference's ``account_jit``, which compiles the
    program a second time; this measures the call itself).  Without an
    accountant it is the bare call, so the untelemetered path pays one
    ``None`` check."""
    if accountant is None:
        return fn(*args)
    return accountant.call(key, fn, *args)
