"""Fault tolerance: heartbeat / straggler detection and the restartable
step loop (port of ``repro.runtime.fault_tolerance``).

``HeartbeatMonitor`` keeps a rolling window of latencies; a measurement
slower than ``factor`` x the rolling median raises a straggler flag.  Its
consumer is the serving stack: pass one as ``StreamScheduler(monitor=...)``
(or the ``monitor=`` keyword of ``GraphService``) and it watches **commit
latency** -- a slow ``apply_ops``/ring append flags the commit, bumps the
``scheduler_stragglers`` counter, and annotates the commit's trace span
with ``straggler=True``.  The trainer (``launch/train.py``) wires the same
monitor around its step function.

``RestartableLoop`` wraps any step function with periodic asynchronous
checkpoints and resume-from-latest: a crash (or a SIGTERM preemption)
anywhere re-enters at the last committed step, with data that is a pure
function of the step (``data/pipeline.py``).
"""
from __future__ import annotations

import signal
import statistics
import time
from collections import deque
from typing import Callable, Optional

from repro_torch.checkpoint import Checkpointer


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


class RestartableLoop:
    """Run ``state = step_fn(state, step_idx)`` with checkpoint/restart.

    ``state`` is a tree of tensors (params, opt, ...); ``state_like`` gives
    its structure and dtypes for the restore, onto ``device`` (default
    ``"cuda"``).  Preemption (SIGTERM) and injected failures
    checkpoint-and-raise; calling ``run`` again resumes.  With ``mesh`` (a
    mesh of processes) and ``specs`` (a tree of ``launch.mesh.P`` like
    ``state_like``, whose shapes are then the whole ones), ``state`` holds
    this process's blocks: saves gather them (rank 0 writes) and restores
    reshard onto the mesh, whatever wrote the checkpoint.
    """

    def __init__(self, ckpt_dir: str, step_fn, state_like,
                 ckpt_every: int = 50, mesh=None, specs=None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 device="cuda"):
        self.ckpt = Checkpointer(ckpt_dir)
        self.step_fn = step_fn
        self.state_like = state_like
        self.ckpt_every = ckpt_every
        self.mesh = mesh
        self.specs = specs
        self.shardings = None
        if mesh is not None:
            from repro_torch.launch.mesh import sanitize_shardings
            self.shardings = sanitize_shardings(specs, state_like, mesh)
        self.device = device
        self.monitor = monitor or HeartbeatMonitor()
        self._preempted = False

    def _handle_sigterm(self, *_):
        self._preempted = True

    def run(self, state, total_steps: int, start_step: int = 0,
            fail_at: Optional[int] = None):
        """Returns (final_state, last_step_done). ``fail_at`` injects a crash
        (for tests / chaos drills)."""
        prev = signal.signal(signal.SIGTERM, self._handle_sigterm)
        try:
            resume_step, restored = self.ckpt.restore_latest(
                self.state_like, self.mesh, self.specs, device=self.device)
            if restored is not None and resume_step >= start_step:
                state, start_step = restored, resume_step
            saved = None
            for step in range(start_step, total_steps):
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"injected failure at step {step}")
                self.monitor.start()
                state = self.step_fn(state, step)
                self.monitor.stop(step)
                if (step + 1) % self.ckpt_every == 0 or self._preempted:
                    self._save(step + 1, state)
                    saved = step + 1
                if self._preempted:
                    self.ckpt.wait(self.mesh)
                    raise SystemExit("preempted; checkpointed at step "
                                     f"{step + 1}")
            if saved != total_steps:  # else the last save is the final one
                self._save(total_steps, state, blocking=True)
            return state, total_steps
        finally:
            # drain any in-flight async checkpoint so a crash/preemption
            # always leaves a consistent latest-step index behind (on a
            # mesh, for every process: rank 0 writes)
            self.ckpt.wait()
            if self.mesh is not None and not self.mesh.broken:
                self.mesh.barrier()
            signal.signal(signal.SIGTERM, prev)

    def _save(self, step: int, state, blocking: bool = False):
        self.ckpt.save(step, state, blocking, mesh=self.mesh,
                       shardings=self.shardings)
