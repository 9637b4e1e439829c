"""AsyncGraphService: non-blocking serving front end over the engine (port
of ``repro.serve.async_service``).

Many clients submit updates and queries concurrently; the paper's
property -- a writer never blocks a reader -- becomes the serving
lifecycle **admission -> pin -> batch -> dispatch**:

  * **admission** (any client thread): ``query_async`` atomically reads
    the latest ring version and takes a refcounted pin on it
    (``VersionRing.pin``: one critical section, so the version cannot
    evict between read and pin), stamps the request's deadline from the
    resilience policy, and enqueues it.  The caller gets a
    ``concurrent.futures.Future`` at once.
  * **pin**: the pin holds the version resident (parked past ring
    rotation if needed) and shields the request's cache slot from LRU
    pruning, while updates keep committing through the scheduler --
    in-flight reads on older versions never block a commit, and vice
    versa.
  * **batch** (dispatcher thread): queued requests are drained and
    grouped by ``(kind, version)``; each group is classified onto the
    unchanged / delta / full rungs with the sequential ladder's own gates
    (``serve.batch.classify_local``).
  * **dispatch**: each rung that has lanes runs as ONE lane-batched call
    over the stacked sources (full) or stacked ``(prior, dirty, src)``
    lanes (delta); then per-request results are sliced out, cached,
    counted, traced, and the futures resolved.  A dispatch failure
    (including the ``serve.dispatch`` fault point) degrades to the
    per-request resilient path (``service.query``), so a poisoned batch
    loses throughput, never a request.

Updates flow through ``submit``/``submit_many`` from any thread: the
scheduler's lock serializes the op-log and whichever client fills a batch
carries out the commit, overlapping the dispatcher's query work.

Consistency: every reply is exact at the ring version it claims -- the
lanes are bit-identical to sequential single-source collects (see
``serve.batch``) -- and each request linearizes at its admission point
(local service) or at dispatch (fallback path, which answers at the
then-latest version and says so in ``reply.version``).

Streams (on the card): the dispatcher runs its lane work on a CUDA stream
of its own.  Before a group reads anything it waits for the ring's commit
events up to the group's version, and before it reads a cached prior it
waits for the event stored with that slot (``classify_local``), whichever
thread's stream computed it.  It synchronizes its stream before a result
is cached or a future resolves, and releases a pin only after that, so
nothing it wrote is read early and nothing it read is freed early.  Every
result it caches is marked as used by the default stream
(``record_stream``), so the caching allocator never hands the block back
to the dispatcher while work on the default stream may still read it.
The fallback and dedup paths run the service's own collect on the default
stream, as a direct ``service.query`` would.  On the CPU there is no
stream and the same code runs without one.

Telemetry (when the wrapped service carries it): ``serve_queue_depth``
gauge, ``serve_batch_size`` histogram (lanes per dispatch),
``serve_request_us`` histogram (admission -> reply), the
``serve_batched_dispatches`` counter, per-group ``dispatch`` spans and
per-request ``query`` records with ``batched=True`` -- the conservation
invariant ``unchanged + delta + full == queries == clean query trace
records`` holds for batched queries exactly as for sequential ones.
Fallbacks are counted in ``ServeStats`` only, as the reference's code
does.
"""
from __future__ import annotations

import contextlib
import contextvars
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core.snapshot import ScanStats
from repro_torch.engine.service import GraphService, QueryReply
from repro_torch.obs.trace import maybe_span
from repro_torch.resil.faults import P_SERVE_DISPATCH, InjectedCrash, \
    inject
from repro_torch.shard.dist import DistMesh

from .batch import classify_local, dispatch_local_group

__all__ = ["AsyncGraphService", "ServeStats"]

#: seconds an admission waits for room in a full queue before refusing
_ADMIT_TIMEOUT_S = 5.0


@dataclass
class _Request:
    kind: str
    src: object
    version: int
    pin: object                      # PinnedSnapshot (refcounted handle)
    future: Future
    t_admit: float
    deadline_at: Optional[float]     # absolute perf_counter bound, or None
    lane: object = None

    def expired(self) -> bool:
        return (self.deadline_at is not None
                and time.perf_counter() >= self.deadline_at)


@dataclass
class ServeStats:
    """Host-side tallies of the front end itself (the per-query ladder
    tallies stay on the wrapped service's ``ServiceStats``)."""

    admitted: int = 0
    batched_dispatches: int = 0      # calls serving >= 2 lanes
    dispatches: int = 0              # calls, any width
    fallbacks: int = 0               # requests served by the resilient path
    deadline_expired: int = 0
    max_batch_seen: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)


class AsyncGraphService:
    """Threaded serving front end over a :class:`GraphService` (or any
    service with the base hooks, batching by request dedup -- see
    ``_dispatch_group``).

    Use as a context manager (``with AsyncGraphService(svc) as srv:``) or
    call ``start()``/``stop()``.  ``query_async`` returns a Future;
    ``query`` blocks on it.  ``submit``/``flush`` pass through to the
    (thread-safe) scheduler from any thread.
    """

    def __init__(self, service, *, max_batch: int = 32,
                 poll_ms: float = 2.0, max_queue: int = 4096):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if isinstance(getattr(service, "mesh", None), DistMesh):
            raise NotImplementedError(
                "AsyncGraphService over a DistMesh is not built: its "
                "threads order queries per process, and the processes must "
                "run the same collects in the same order, which needs a "
                "rank-0 dispatcher that broadcasts each dispatch (ROADMAP "
                "queue 1, 'the front end over a DistMesh')")
        self.service = service
        self.max_batch = max_batch
        self.poll_s = max(poll_ms, 0.1) / 1e3
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._running = False
        self._inflight = 0               # admitted, not yet resolved
        self._inflight_lock = threading.Lock()
        self._drained = threading.Condition(self._inflight_lock)
        self.stats = ServeStats()
        #: local services get the lane-batched fast path; anything else
        #: batches by dedup.
        self._local = isinstance(service, GraphService)

    # ----------------------------- lifecycle -----------------------------

    def start(self) -> "AsyncGraphService":
        if self._thread is not None:
            raise RuntimeError("front end already started")
        device = self.service.ring.latest.state.device
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._running = True
        # The dispatcher runs in a copy of the STARTING thread's context:
        # contextvars (the active fault plan, tracing nesting defaults)
        # propagate into dispatch, so a chaos scope wrapped around
        # start() exercises batched dispatch too.
        ctx = contextvars.copy_context()
        self._thread = threading.Thread(
            target=lambda: ctx.run(self._loop), name="serve-dispatcher",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the dispatcher (after draining, by default).  ``timeout``
        bounds the drain and the join; a dispatcher still alive after it
        raises ``TimeoutError``."""
        if self._thread is None:
            return
        if drain:
            self.drain(timeout=timeout)
        self._running = False
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError("the dispatcher did not stop in time")
        self._thread = None
        # Anything still queued (stop(drain=False)) must not leak pins.
        while True:
            try:
                req = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            self._fail(req, RuntimeError("front end stopped"))

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has resolved (an in-flight
        count, not a queue peek -- a request popped by the dispatcher but
        not yet answered still holds the drain)."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        with self._drained:
            while self._inflight > 0:
                rem = (None if deadline is None
                       else deadline - time.perf_counter())
                if rem is not None and rem <= 0:
                    return False
                self._drained.wait(timeout=rem)
        return True

    def __enter__(self) -> "AsyncGraphService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc[0] is None)

    # ------------------------------ updates ------------------------------

    def submit(self, op) -> int:
        """Thread-safe update intake: the scheduler lock serializes the
        op-log; a filled batch commits on THIS caller's thread, overlapped
        with the dispatcher's pinned-version query work."""
        return self.service.submit(op)

    def submit_many(self, ops) -> list:
        return self.service.submit_many(ops)

    def flush(self):
        return self.service.flush()

    # ------------------------------ queries ------------------------------

    def query_async(self, kind: str, src, mode: str = "icn") -> Future:
        """Admit one query: pin the latest version, enqueue, return a
        Future resolving to a :class:`QueryReply` exact at that version
        (or at the fallback path's dispatch version, which the reply
        names).  Only PG-Icn admission is served here; PG-Cn's
        double-collect loop needs the sequential path."""
        if self._thread is None:
            raise RuntimeError("front end not started")
        if mode != "icn":
            raise ValueError("async admission serves icn queries; use "
                             "service.query(..., mode='cn') directly")
        if kind not in self.service._kinds:
            raise KeyError(f"unknown query kind {kind!r}")
        self.service._check_srcs(kind, src)
        pol = self.service.policy
        pin = self.service.ring.pin()        # atomic read-latest + pin
        now = time.perf_counter()
        deadline = (now + pol.deadline_ms / 1e3
                    if pol is not None and pol.deadline_ms != float("inf")
                    else None)
        req = _Request(kind, src, pin.version, pin, Future(), now, deadline)
        with self._inflight_lock:
            self._inflight += 1
        try:
            self._queue.put(req, timeout=_ADMIT_TIMEOUT_S)
        except queue_mod.Full:
            self._done()
            pin.release()
            raise RuntimeError("admission queue full") from None
        with self.stats._lock:
            self.stats.admitted += 1
        self._observe_queue_depth()
        return req.future

    def _done(self) -> None:
        with self._drained:
            self._inflight -= 1
            if self._inflight <= 0:
                self._drained.notify_all()

    def query(self, kind: str, src, mode: str = "icn",
              timeout: Optional[float] = None) -> QueryReply:
        return self.query_async(kind, src, mode).result(timeout=timeout)

    # ------------------------------ streams ------------------------------

    def _wait_for_commits(self, version: int) -> None:
        """Order the dispatcher's stream after the commits up to
        ``version`` (their events): the states and dirty sets a group at
        that version reads."""
        if self._stream is None:
            return
        for event in self.service.ring.ready_events(version):
            self._stream.wait_event(event)

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _sync_current(self) -> None:
        if self._stream is not None:
            torch.cuda.current_stream(self._stream.device).synchronize()

    def _on_default_stream(self):
        """Run the service's own collect where ``service.query`` runs it."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.default_stream(
            self._stream.device))

    def _hand_off(self, result) -> None:
        """Mark a result made on the dispatcher's stream as used by the
        default stream, which reads cached priors."""
        if self._stream is None:
            return
        default = torch.cuda.default_stream(self._stream.device)
        for t in result:
            t.record_stream(default)

    # ----------------------------- dispatcher ----------------------------

    def _telemetry(self):
        return self.service.telemetry

    def _observe_queue_depth(self) -> None:
        tel = self._telemetry()
        if tel is not None:
            tel.registry.gauge(
                "serve_queue_depth",
                service=self.service._service_name).set(self._queue.qsize())

    def _loop(self) -> None:
        with torch.cuda.stream(self._stream):
            while True:
                try:
                    first = self._queue.get(timeout=self.poll_s)
                except queue_mod.Empty:
                    if not self._running:
                        return
                    continue
                batch = [first]
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue_mod.Empty:
                        break
                self._observe_queue_depth()
                try:
                    self._dispatch(batch)
                except InjectedCrash:
                    # simulated process death: the dispatcher dies like
                    # the process would; unresolved futures stay pending,
                    # exactly as a crashed server leaves its clients
                    raise
                except Exception as exc:  # pragma: no cover - defensive
                    # _dispatch_group degrades per request; anything that
                    # still escapes must not kill the dispatcher silently.
                    for req in batch:
                        if not req.future.done():
                            self._fail(req, exc)

    def _dispatch(self, batch) -> None:
        groups = {}
        for req in batch:
            groups.setdefault((req.kind, req.version), []).append(req)
        # Ascending version order: a group's cache stores must never be
        # overwritten by an older group of the same batch.
        for (kind, version), reqs in sorted(groups.items(),
                                            key=lambda kv: kv[0][1]):
            live = []
            for req in reqs:
                if req.expired():
                    self._finish_expired(req)
                else:
                    live.append(req)
            if live:
                self._dispatch_group(kind, version, live)

    def _dispatch_group(self, kind: str, version: int, reqs) -> None:
        svc = self.service
        tel = self._telemetry()
        tracer = tel.tracer if tel is not None else None
        entry = svc.ring.get_entry(version)  # pinned => resident
        try:
            with maybe_span(tracer, "dispatch",
                            service=svc._service_name, kind=kind,
                            version=version, batch=len(reqs)) as sp:
                inject(P_SERVE_DISPATCH)
                if entry is None:
                    raise RuntimeError(
                        f"pinned version {version} vanished")
                if self._local:
                    sizes = self._dispatch_local(kind, version, entry,
                                                 reqs)
                else:
                    sizes = self._dispatch_dedup(kind, version, reqs)
                sp.set(**{f"lanes_{k}": v for k, v in sizes.items()})
        except InjectedCrash:
            raise
        except Exception:
            # The batch is poisoned, the requests are not: each one NOT
            # yet answered (a failure can land mid-batch, after some
            # futures resolved) retries on the per-request resilient
            # ladder.
            for req in reqs:
                if not req.future.done():
                    self._fallback(req)

    def _dispatch_local(self, kind: str, version: int, entry, reqs):
        """The lane-batched fast path (local service): classify, batch,
        slice."""
        svc = self.service
        state = entry.state
        self._wait_for_commits(version)
        for i, req in enumerate(reqs):
            req.lane = classify_local(svc, kind, req.src, version, state)
            req.lane.index = i
        lanes = [req.lane for req in reqs]
        results, sizes = dispatch_local_group(svc, kind, state, lanes)
        # Complete before anything else can read a result through the
        # cache or a future.
        self._sync()
        self._note_dispatch(kind, sizes)
        for req, res in zip(reqs, results):
            self._hand_off(res)
            svc._cache_store((kind, req.src), version, res)
            self._finish(req, res, req.lane.mode, version,
                         validated=False)
        return sizes

    def _dispatch_dedup(self, kind: str, version: int, reqs):
        """Non-local service: identical ``(kind, src)`` requests at one
        version share a single collect (the service's own, at the latest
        version); a group pinned behind the latest version answers
        per-request at latest through the resilient path (the reply names
        its version)."""
        svc = self.service
        by_key = {}
        for req in reqs:
            by_key.setdefault(svc._key(kind, req.src), []).append(req)
        sizes = {"dedup": 0}
        for key, shared in by_key.items():
            if version == svc.ring.latest.version:
                with self._on_default_stream():
                    entry, res, mode = svc._traced_collect(
                        kind, shared[0].src, key)
                    self._sync_current()
                self._note_dispatch(kind, {"dedup": len(shared)})
                sizes["dedup"] += len(shared)
                for req in shared:
                    self._finish(req, res, mode, entry.version,
                                 validated=svc._icn_validated(res))
            else:
                for req in shared:
                    self._fallback(req)
        return sizes

    # ----------------------------- completion ----------------------------

    def _note_dispatch(self, kind: str, sizes) -> None:
        tel = self._telemetry()
        for rung, n in sizes.items():
            with self.stats._lock:
                self.stats.dispatches += 1
                self.stats.max_batch_seen = max(self.stats.max_batch_seen,
                                                n)
                if n >= 2:
                    self.stats.batched_dispatches += 1
            if tel is not None:
                tel.registry.histogram(
                    "serve_batch_size", service=self.service._service_name,
                    kind=kind, rung=rung).observe(n)
                if n >= 2:
                    tel.registry.counter(
                        "serve_batched_dispatches",
                        service=self.service._service_name,
                        kind=kind).inc()

    def _finish(self, req: _Request, result, mode: str, version: int,
                validated: bool) -> None:
        """Resolve one request from the batched path: stats, trace record,
        latency observation, future, pin release -- the same bookkeeping
        contract as ``BaseGraphService.query``."""
        svc = self.service
        svc.stats.queries += 1
        svc.stats.collects += 1
        svc.stats.count(mode)
        reply = QueryReply(result, version, mode, validated,
                           ScanStats(collects=1))
        tel = self._telemetry()
        if tel is not None:
            with tel.tracer.span("query", service=svc._service_name,
                                 kind=req.kind, cn=False) as sp:
                sp.set(version=version, mode=mode, collects=1,
                       batched=True, validated=validated,
                       wait_us=round(
                           (time.perf_counter() - req.t_admit) * 1e6, 1))
        self._resolve(req, reply)

    def _fallback(self, req: _Request) -> None:
        """Serve one request on the sequential resilient path (counts,
        traces, and degrades exactly as a direct ``service.query``)."""
        with self.stats._lock:
            self.stats.fallbacks += 1
        try:
            with self._on_default_stream():
                reply = self.service.query(req.kind, req.src)
                self._sync_current()
        except InjectedCrash:
            raise
        except Exception as exc:
            self._fail(req, exc)
            return
        self._resolve(req, reply)

    def _finish_expired(self, req: _Request) -> None:
        """Deadline passed while queued: stale-serve if the policy allows
        (degraded, exact at the version it names), else a TimeoutError --
        never silent, never a torn read."""
        svc = self.service
        with self.stats._lock:
            self.stats.deadline_expired += 1
        reply = (svc._stale_reply(req.kind, req.src)
                 if svc.policy is not None and svc.policy.allow_stale
                 else None)
        if reply is not None:
            svc.stats.degraded += 1
            tel = self._telemetry()
            if tel is not None:
                # same record shape as a sync degraded reply, so the
                # trace/stats reconciliation survives expiry
                with tel.tracer.span("query", service=svc._service_name,
                                     kind=req.kind, cn=False) as sp:
                    sp.set(version=reply.version, mode=reply.mode,
                           collects=0, batched=True, degraded=True,
                           stale_version=reply.stale_version,
                           validated=False)
            self._resolve(req, reply)
            return
        self._fail(req, TimeoutError(
            f"query ({req.kind}, {req.src}) missed its deadline before "
            f"dispatch"))

    def _fail(self, req: _Request, exc: BaseException) -> None:
        try:
            self._release(req)
        finally:
            req.future.set_exception(exc)
            self._done()

    def _resolve(self, req: _Request, reply: QueryReply) -> None:
        tel = self._telemetry()
        if tel is not None:
            tel.registry.histogram(
                "serve_request_us",
                service=self.service._service_name,
                kind=req.kind).observe(
                    (time.perf_counter() - req.t_admit) * 1e6)
        self._release(req)
        req.future.set_result(reply)
        self._done()

    def _release(self, req: _Request) -> None:
        """Drop the request's pin once no work that read its version can
        still be running."""
        try:
            self._sync()
        finally:
            req.pin.release()
