"""The graph mesh and the collective group of the sharded engine.

The reference runs each sharded query as one ``shard_map`` program whose
per-shard body calls ``lax.psum`` / ``lax.pmax`` / ``lax.all_gather`` /
``lax.ppermute`` over a 1-D ``graph`` axis, with every device of the
process on the axis (``jax.devices()``; its tests force four placeholder
CPU devices).  The port keeps those per-shard bodies and hands them a
:class:`ThreadGroup`, the counterpart of the axis:

  * :class:`GraphMesh` is an ordered list of torch devices, repeats
    allowed: ``GraphMesh(["cuda:0"] * 4)`` is four shards on one card (the
    torch counterpart of the reference's placeholder devices), and
    ``GraphMesh(["cpu"] * 4)`` four shards on the CPU.
  * :meth:`ThreadGroup.run` runs the body once per rank, each on a Python
    thread of its own (rank 0 on the calling thread) and, on the card, on
    a CUDA stream of its own.  A collective meets at a
    ``threading.Barrier``; every rank reduces the deposited values itself,
    in rank order, so the result does not depend on thread timing and
    each rank gets it on its own device.  If a rank raises, the barrier is
    aborted and every other rank fails at its next collective; every wait
    has the mesh's timeout.
  * The group counts the bytes of each collective it performs under the
    reference's HLO op names (``all-reduce``, ``all-gather``,
    ``collective-permute``): the result bytes of one rank's call, the
    per-device figure ``repro.obs.hlo.parse_collective_bytes`` reads off
    the compiled program -- here counted as the collectives run, so a
    collective inside a loop counts once per iteration.

Streams (on the card).  Rank ``r > 0`` first waits for an event recorded
on the caller's stream, so it reads what the caller wrote; the caller's
stream waits for each rank's last event before ``run`` returns, and every
tensor a rank hands back is marked as used by the caller's stream
(``record_stream``), so the caching allocator never reuses its block
under the caller.  In a collective a rank records an event after its
deposit; a reader waits for that event on its own stream and marks the
tensor as used by it before reading.  Tensors on one device pass by
reference (a ring hop hands the band over as it is); between devices
they are copied.

A ``torch.distributed`` group with the same methods (NCCL on four cards)
would run the same bodies unchanged; it is not built here.
"""
from __future__ import annotations

import contextvars
import threading
from typing import Callable, Sequence

import torch

#: seconds any one wait of the group (a barrier, a rank's join) may take
DEFAULT_TIMEOUT_S = 600.0


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available on this machine; build "
                "the mesh from CPU devices (GraphMesh(['cpu'] * n))")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _flatten(devices):
    for d in devices:
        if isinstance(d, (list, tuple)):
            yield from _flatten(d)
        else:
            yield d


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    """Bytes of a collective's operand: a tensor's, a tuple's sum, and a
    host scalar as the reference's int32 / f32 / bool scalar."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 1 if isinstance(x, bool) else 4


class GraphMesh:
    """The 1-D graph axis: rank ``i`` runs on ``devices[i]``.

    ``devices`` may nest (a production mesh's grid is flattened, as
    ``repro.shard.as_graph_mesh`` flattens ``mesh.devices``) and may
    repeat.  ``timeout`` bounds every wait of a group run on the mesh.
    """

    def __init__(self, devices: Sequence, timeout: float = DEFAULT_TIMEOUT_S):
        devs = tuple(_device(d) for d in _flatten(devices))
        if not devs:
            raise ValueError("a graph mesh needs at least one device")
        self.devices = devs
        self.timeout = timeout
        self._streams: dict = {}
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, GraphMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"GraphMesh({[str(d) for d in self.devices]})"

    def stream(self, rank: int) -> torch.cuda.Stream:
        """Rank ``rank``'s own CUDA stream (made at first use)."""
        with self._lock:
            s = self._streams.get(rank)
            if s is None:
                s = torch.cuda.Stream(self.devices[rank])
                self._streams[rank] = s
            return s


class ThreadGroup:
    """One run of a per-rank body over a :class:`GraphMesh` (module
    docstring).  ``bytes`` / ``calls`` hold the collectives' counts per op
    name after the run."""

    def __init__(self, mesh: GraphMesh):
        self.mesh = mesh
        n = mesh.size
        self._barrier = threading.Barrier(n, timeout=mesh.timeout)
        # Two slot lists, by collective parity: a rank writes list g % 2 at
        # its g-th collective, which no rank reaches before every rank has
        # passed collective g - 1's barrier, having read that list.
        self._slots = ([None] * n, [None] * n)
        self._gen = [0] * n
        self._tls = threading.local()
        self.bytes: dict = {}
        self.calls: dict = {}

    # ------------------------------- axis --------------------------------

    def axis_index(self) -> int:
        return self._tls.rank

    def size(self) -> int:
        return self.mesh.size

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[self.axis_index()]

    # ---------------------------- collectives ----------------------------

    def _count(self, op: str, nbytes: int) -> None:
        if self.axis_index() == 0:  # every rank makes the same calls
            self.bytes[op] = self.bytes.get(op, 0) + nbytes
            self.calls[op] = self.calls.get(op, 0) + 1

    def _exchange(self, payload) -> list:
        """Deposit ``payload``, meet every rank, and return every rank's
        ``(payload, ready event)`` in rank order."""
        r = self.axis_index()
        if self.size() == 1:
            return [(payload, None)]
        ready = None
        if any(t.is_cuda for t in _tensors(payload)):
            ready = torch.cuda.current_stream(self.device).record_event()
        g = self._gen[r]
        self._gen[r] += 1
        slots = self._slots[g % 2]
        slots[r] = (payload, ready)
        self._barrier.wait()
        return list(slots)

    def _receive(self, item, mine: bool):
        """A deposited payload as this rank may read it (module
        docstring: streams)."""
        payload, ready = item
        if mine:
            return payload
        dev = self.device
        if ready is not None and dev.type == "cuda":
            torch.cuda.current_stream(dev).wait_event(ready)

        def one(t):
            if t.device == dev:
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(dev))
                return t
            return t.to(dev)

        if isinstance(payload, torch.Tensor):
            return one(payload)
        if isinstance(payload, (list, tuple)):
            return type(payload)(one(t) for t in payload)
        return payload

    def _gathered(self, x) -> list:
        r = self.axis_index()
        return [self._receive(item, i == r)
                for i, item in enumerate(self._exchange(x))]

    def _reduce(self, x, combine):
        vals = self._gathered(x)
        out = vals[0]
        for v in vals[1:]:  # rank order: the same result on every rank
            out = combine(out, v)
        return out

    def psum(self, x):
        """Sum over the ranks (a tensor, or a host scalar)."""
        self._count("all-reduce", _nbytes(x))
        return self._reduce(x, lambda a, b: a + b)

    def pmax(self, x):
        """Elementwise maximum over the ranks (a tensor, or a host
        scalar)."""
        self._count("all-reduce", _nbytes(x))
        if isinstance(x, torch.Tensor):
            return self._reduce(x, torch.maximum)
        return self._reduce(x, max)

    def all_gather(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        """Every rank's ``x`` in rank order: concatenated along axis 0
        (``tiled``) or stacked on a new leading axis."""
        self._count("all-gather", self.size() * _nbytes(x))
        vals = self._gathered(x)
        return torch.cat(vals) if tiled else torch.stack(vals)

    def ppermute(self, x, perm):
        """``lax.ppermute``: rank ``d`` receives the ``x`` of rank ``s`` for
        each ``(s, d)`` in ``perm``, zeros where no rank sends to it.  ``x``
        is a tensor or a tuple of tensors."""
        r = self.axis_index()
        src = {d: s for s, d in perm}
        if any(s == r for s, _ in perm):
            self._count("collective-permute", _nbytes(x))
        items = self._exchange(x)
        if r not in src:
            if isinstance(x, torch.Tensor):
                return torch.zeros_like(x)
            return type(x)(torch.zeros_like(t) for t in x)
        return self._receive(items[src[r]], src[r] == r)

    # -------------------------------- run --------------------------------

    def run(self, body: Callable, rank_args: Sequence[tuple]) -> list:
        """``[body(self, *rank_args[r]) for every rank r]``, the ranks
        running at once (module docstring).  Re-raises the first rank's
        error; a hung rank raises ``TimeoutError``."""
        mesh = self.mesh
        n = mesh.size
        if len(rank_args) != n:
            raise ValueError(f"{len(rank_args)} argument tuples for a mesh "
                             f"of {n} ranks")
        start = {d: torch.cuda.current_stream(d).record_event()
                 for d in set(mesh.devices) if d.type == "cuda"}
        outs = [None] * n
        dones = [None] * n
        errors = [None] * n

        def work(rank: int) -> None:
            self._tls.rank = rank
            dev = mesh.devices[rank]
            try:
                if dev.type != "cuda":
                    outs[rank] = body(self, *rank_args[rank])
                elif rank == 0:  # the caller's stream
                    with torch.cuda.device(dev):
                        outs[rank] = body(self, *rank_args[rank])
                else:
                    stream = mesh.stream(rank)
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        stream.wait_event(start[dev])
                        outs[rank] = body(self, *rank_args[rank])
                        dones[rank] = stream.record_event()
            except BaseException as e:  # noqa: BLE001 - re-raised by run
                errors[rank] = e
                self._barrier.abort()

        threads = [threading.Thread(
            target=contextvars.copy_context().run, args=(work, r),
            name=f"shard-rank-{r}", daemon=True) for r in range(1, n)]
        for t in threads:
            t.start()
        work(0)
        hung = False
        for t in threads:
            t.join(timeout=mesh.timeout)
            if t.is_alive():
                hung = True
                self._barrier.abort()
        real = [e for e in errors
                if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if real:
            raise real[0]
        if hung or any(e is not None for e in errors):
            raise TimeoutError(f"a rank of {mesh!r} did not reach a "
                               f"collective within {mesh.timeout} s")
        for rank in range(1, n):
            if dones[rank] is None:
                continue
            cur = torch.cuda.current_stream(mesh.devices[rank])
            cur.wait_event(dones[rank])
            for t in _tensors(outs[rank]):
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
        return outs


def as_graph_mesh(mesh=None) -> GraphMesh:
    """The 1-D graph axis the sharded engine partitions over: ``mesh`` as
    a :class:`GraphMesh` (a sequence of devices, nested sequences
    flattened, as the reference flattens a production mesh's grid), or
    every visible CUDA device when ``None``."""
    if isinstance(mesh, GraphMesh):
        return mesh
    if mesh is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available on this machine; pass "
                "the mesh's devices (GraphMesh(['cpu'] * n))")
        return GraphMesh([f"cuda:{i}"
                          for i in range(torch.cuda.device_count())])
    return GraphMesh(mesh)
