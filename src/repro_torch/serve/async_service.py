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

**Over a** :class:`~repro_torch.shard.dist.DistMesh` (a
``ShardedGraphService`` with one process per rank) every process must run
the same commits and collects in the same order, so rank 0 sequences and
the other ranks follow.  Only rank 0 admits: ``query_async``, ``submit``,
``submit_many`` and ``flush`` raise on another rank.  Rank 0's
dispatcher is the one place that orders all work: each dispatch group
``(kind, version, sources)``, after rank 0's clock has decided which of
its requests expired, and each update (``submit_many``'s ops, a
``flush``; the submitter waits for its turn) becomes a command, which
rank 0 broadcasts (``DistMesh.broadcast``, framed) and then executes.
The other ranks call :meth:`AsyncGraphService.follow`, which executes
each command with the same calls in the same order -- the same
``_dispatch_group`` (its fault-plan consults and the breaker's), the
same collects with their nested control messages, the same per-request
fallbacks -- on stand-ins for rank 0's requests, and returns at the stop
command ``stop()`` sends after its drain.  Each command also carries the
versions rank 0's admissions pinned since the last one (admissions never
overlap a commit), so a follower pins them where rank 0 did and holds
the same versions resident.  An idle dispatcher sends an empty command a
quarter of the mesh's timeout apart, so a follower's receive never times
out while rank 0 waits for clients; a crash of rank 0's dispatcher
(``InjectedCrash``) aborts the mesh, and every follower raises
``RankFailure`` at once.
"""
from __future__ import annotations

import contextlib
import contextvars
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core.snapshot import ScanStats
from repro_torch.engine.service import GraphService, QueryReply
from repro_torch.obs.trace import maybe_span
from repro_torch.resil.faults import P_SERVE_DISPATCH, InjectedCrash, \
    inject
from repro_torch.shard.dist import DistMesh, RankFailure

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
    aid: int = -1                    # admission number (DistMesh)

    def expired(self) -> bool:
        return (self.deadline_at is not None
                and time.perf_counter() >= self.deadline_at)


@dataclass
class _Update:
    """An update command on a DistMesh's rank 0, waiting for its turn in
    the dispatcher's order: ``{"c": "u", "ops": [...]}`` or ``{"c":
    "f"}`` (flush)."""

    cmd: dict
    future: Future


def _wire(src):
    """A query's sources as the command channel carries them (JSON)."""
    if src is None:
        return None
    if isinstance(src, (list, tuple)) or getattr(src, "ndim", 0) > 0:
        return [int(s) for s in (src.tolist() if hasattr(src, "tolist")
                                 else src)]
    return int(src)


def _wire_op(op) -> list:
    return [x.item() if hasattr(x, "item") else x for x in op]


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
    (thread-safe) scheduler from any thread.  Over a ``DistMesh``, rank 0
    does all of this and the other ranks call ``follow()`` (module
    docstring).
    """

    def __init__(self, service, *, max_batch: int = 32,
                 poll_ms: float = 2.0, max_queue: int = 4096):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        mesh = getattr(service, "mesh", None)
        #: the mesh of processes whose rank 0 sequences, or None
        self._mesh = mesh if isinstance(mesh, DistMesh) else None
        self._lead = self._mesh is None or self._mesh.rank == 0
        # Rank 0: admissions since the last command ([admission, version])
        # and admissions released before dispatch; admissions and commits
        # never overlap.  A follower: its pins per admission.
        self._admit_lock = threading.RLock()
        self._admitted: list = []
        self._released: list = []
        self._next_aid = 0
        self._pins: dict = {}
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

    def _require_lead(self, what: str) -> None:
        if not self._lead:
            raise RuntimeError(
                f"rank {self._mesh.rank} of a DistMesh does not {what}: rank "
                "0 admits every request and update and sequences them; the "
                "other ranks call follow()")

    def _open_stream(self) -> None:
        device = self.service.ring.latest.state.device
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def start(self) -> "AsyncGraphService":
        self._require_lead("start a dispatcher")
        if self._thread is not None:
            raise RuntimeError("front end already started")
        self._open_stream()
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
        with the dispatcher's pinned-version query work.  Over a
        ``DistMesh`` the dispatcher commits it, in its order of commands,
        and the caller waits for that."""
        if self._mesh is None:
            return self.service.submit(op)
        return self._sequenced({"c": "u", "ops": [_wire_op(op)]})[0]

    def submit_many(self, ops) -> list:
        if self._mesh is None:
            return self.service.submit_many(ops)
        return self._sequenced({"c": "u", "ops": [_wire_op(op)
                                                  for op in ops]})

    def flush(self):
        if self._mesh is None:
            return self.service.flush()
        return self._sequenced({"c": "f"})

    def _sequenced(self, cmd: dict):
        """Rank 0: queue an update command behind the requests already
        admitted and wait until the dispatcher has run it."""
        self._require_lead("submit updates")
        if self._thread is None:
            raise RuntimeError("front end not started")
        upd = _Update(cmd, Future())
        try:
            self._queue.put(upd, timeout=_ADMIT_TIMEOUT_S)
        except queue_mod.Full:
            raise RuntimeError("admission queue full") from None
        thread = self._thread
        while True:
            try:
                return upd.future.result(timeout=self.poll_s * 50)
            except FutureTimeout:
                if thread is None or not thread.is_alive():
                    raise RuntimeError("the dispatcher ended before the "
                                       "update ran") from None

    def _run_update(self, cmd: dict):
        """Every rank: one update command."""
        if cmd["c"] == "f":
            return self.service.flush()
        return self.service.submit_many([tuple(op) for op in cmd["ops"]])

    # ------------------------------ queries ------------------------------

    def query_async(self, kind: str, src, mode: str = "icn") -> Future:
        """Admit one query: pin the latest version, enqueue, return a
        Future resolving to a :class:`QueryReply` exact at that version
        (or at the fallback path's dispatch version, which the reply
        names).  Only PG-Icn admission is served here; PG-Cn's
        double-collect loop needs the sequential path."""
        self._require_lead("admit queries")
        if self._thread is None:
            raise RuntimeError("front end not started")
        if mode != "icn":
            raise ValueError("async admission serves icn queries; use "
                             "service.query(..., mode='cn') directly")
        if kind not in self.service._kinds:
            raise KeyError(f"unknown query kind {kind!r}")
        self.service._check_srcs(kind, src)
        if self._mesh is not None:
            src = _wire(src)
        pol = self.service.policy
        with self._admit_lock:
            pin = self.service.ring.pin()    # atomic read-latest + pin
            aid = self._next_aid
            self._next_aid += 1
            if self._mesh is not None:
                self._admitted.append([aid, pin.version])
        now = time.perf_counter()
        deadline = (now + pol.deadline_ms / 1e3
                    if pol is not None and pol.deadline_ms != float("inf")
                    else None)
        req = _Request(kind, src, pin.version, pin, Future(), now, deadline,
                       aid=aid)
        with self._inflight_lock:
            self._inflight += 1
        try:
            self._queue.put(req, timeout=_ADMIT_TIMEOUT_S)
        except queue_mod.Full:
            self._done()
            with self._admit_lock:
                if [aid, pin.version] in self._admitted:
                    self._admitted.remove([aid, pin.version])
                elif self._mesh is not None:
                    self._released.append(aid)
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
        idle_s = None if self._mesh is None else self._mesh.timeout / 4
        with torch.cuda.stream(self._stream):
            last = time.perf_counter()
            while True:
                try:
                    first = self._queue.get(timeout=self.poll_s)
                except queue_mod.Empty:
                    if not self._running:
                        if self._mesh is not None:
                            self._command({"c": "s"})   # followers return
                        return
                    if (idle_s is not None
                            and time.perf_counter() - last >= idle_s):
                        self._command({"c": "i"})   # keep followers alive
                        last = time.perf_counter()
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
                except (InjectedCrash, RankFailure):
                    # simulated process death: the dispatcher dies like
                    # the process would; unresolved futures stay pending,
                    # exactly as a crashed server leaves its clients (and
                    # a mesh's followers see their next receive fail)
                    if self._mesh is not None:
                        self._mesh.abort()
                    raise
                except Exception as exc:  # pragma: no cover - defensive
                    # _dispatch_group degrades per request; anything that
                    # still escapes must not kill the dispatcher silently.
                    for req in batch:
                        if not req.future.done():
                            self._fail(req, exc)
                last = time.perf_counter()

    def _dispatch(self, batch) -> None:
        """Requests in groups; an update (a DistMesh's rank 0) keeps its
        place between the requests queued before and after it."""
        reqs = []
        for item in batch:
            if isinstance(item, _Update):
                self._dispatch_requests(reqs)
                reqs = []
                self._sequence_update(item)
            else:
                reqs.append(item)
        self._dispatch_requests(reqs)

    def _dispatch_requests(self, batch) -> None:
        groups = {}
        for req in batch:
            groups.setdefault((req.kind, req.version), []).append(req)
        # Ascending version order: a group's cache stores must never be
        # overwritten by an older group of the same batch.
        for (kind, version), reqs in sorted(groups.items(),
                                            key=lambda kv: kv[0][1]):
            expired = [req.expired() for req in reqs]   # rank 0's clock
            if self._mesh is not None:
                self._command({"c": "q", "k": kind, "v": version,
                               "a": [req.aid for req in reqs],
                               "s": [req.src for req in reqs],
                               "x": [i for i, e in enumerate(expired) if e]})
            self._run_group(kind, version, reqs, expired)

    def _run_group(self, kind: str, version: int, reqs, expired) -> None:
        live = []
        for req, gone in zip(reqs, expired):
            if gone:
                self._finish_expired(req)
            else:
                live.append(req)
        if live:
            self._dispatch_group(kind, version, live)

    # ----------------------- the mesh's command channel -------------------

    def _command(self, cmd: dict) -> dict:
        """Rank 0: broadcast ``cmd`` with the admissions pinned and
        released since the last command; returns it as every rank has
        it."""
        with self._admit_lock:
            cmd["p"], self._admitted = self._admitted, []
            cmd["r"], self._released = self._released, []
            return self._mesh.broadcast(cmd)

    def _sequence_update(self, upd: _Update) -> None:
        """Rank 0: broadcast and run an update command; no admission pins
        a version until it has committed, so each pin lands between the
        same two commands on every rank."""
        with self._admit_lock:
            cmd = self._command(upd.cmd)
            try:
                res = self._run_update(cmd)
            except Exception as exc:    # the followers see the same
                upd.future.set_exception(exc)
                return
            except BaseException as exc:
                upd.future.set_exception(exc)
                raise
            upd.future.set_result(res)

    def follow(self) -> int:
        """A rank other than 0 of a DistMesh: execute rank 0's commands in
        its order until its stop command; returns the number executed
        (module docstring).  Any failure but ``RankFailure`` aborts the
        mesh before it propagates, so rank 0 never waits on this rank."""
        if self._mesh is None or self._lead:
            raise RuntimeError("follow() runs on a rank other than 0 of a "
                               "DistMesh; rank 0 start()s the dispatcher")
        self._open_stream()
        count = 0
        try:
            with torch.cuda.stream(self._stream):
                while True:
                    count += 1
                    if self._follow(self._mesh.broadcast(None)):
                        return count
        except RankFailure:
            raise
        except BaseException:
            self._mesh.abort()
            raise
        finally:
            for pin in self._pins.values():
                pin.release()
            self._pins.clear()

    def _follow(self, cmd: dict) -> bool:
        """One of rank 0's commands on a follower; True at the stop."""
        for aid, version in cmd["p"]:
            self._pins[aid] = self.service.ring.pin(version)
        for aid in cmd["r"]:
            self._pins.pop(aid).release()
        kind = cmd["c"]
        if kind == "s":
            return True
        if kind in ("u", "f"):
            try:
                self._run_update(cmd)
            except Exception:   # rank 0's submitter sees it
                pass
        elif kind == "q":
            now = time.perf_counter()
            reqs = [_Request(cmd["k"], src, cmd["v"], self._pins.pop(aid),
                             Future(), now, None, aid=aid)
                    for aid, src in zip(cmd["a"], cmd["s"])]
            with self.stats._lock:
                self.stats.admitted += len(reqs)
            with self._inflight_lock:
                self._inflight += len(reqs)
            gone = set(cmd["x"])
            try:
                self._run_group(cmd["k"], cmd["v"], reqs,
                                [i in gone for i in range(len(reqs))])
            except Exception as exc:  # pragma: no cover - as rank 0's loop
                for req in reqs:
                    if not req.future.done():
                        self._fail(req, exc)
        return False

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
        if isinstance(req, _Update):
            req.future.set_exception(exc)
            return
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
