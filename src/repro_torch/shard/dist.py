"""The graph axis across processes: a ``torch.distributed`` group for the
sharded engine (the multi-process form of ``repro.shard``'s ``graph`` axis).

The reference runs each sharded query as one SPMD program whose
``shard_map`` bodies call ``lax.psum`` / ``lax.pmax`` / ``lax.all_gather``
/ ``lax.ppermute``; on a mesh that spans hosts, one controller process per
host runs the same program.  Here one process per rank runs the same
per-rank bodies (``shard.queries``) unchanged, over:

  * :class:`DistMesh` -- this process's rank, the world size, its own
    device and every rank's device (gathered once at init, so the mesh
    compares, hashes and keys the query caches like a
    :class:`~.group.GraphMesh`).  ``timeout`` bounds every collective.
  * :class:`DistGroup` -- :class:`~.group.ThreadGroup`'s interface over
    the process group: ``run`` calls the body once, for this rank.

**Named axes.**  ``DistMesh(shape=, axis_names=)`` (or ``set_axes``) lays
the ranks out rank-major over named axes, as ``jax.make_mesh`` does:
``rank = data_index * n_model + model_index`` on ``("data", "model")``.
Each axis gets one subgroup per line of ranks along it (every process
builds every subgroup, in one order), and ``DistGroup(mesh, axis=name)``
runs the collectives over this process's line only -- ``psum``,
``all_gather``, ``all_to_all`` and ``reduce_scatter`` over ``data`` or
``model``, as the LM stack's sharded step needs them.

**Transports** are named, never guessed, and nothing switches transport
after a failure:

  * ``"nccl"``: CUDA tensors go through NCCL, one card per rank (a mesh
    whose ranks share a card raises); host values go through gloo.
  * ``"gloo"``: every collective is staged through host memory -- the
    rank's tensors are copied into one pinned host buffer, exchanged, and
    copied back to the rank's device on its stream.  Four processes
    sharing one card run this way.  Each gloo payload carries a 16-byte
    header (the op and the collective's sequence number), checked on
    receipt: ranks that fell out of step fail instead of combining
    unrelated tensors.

**Reductions are rank-ordered.**  ``psum`` / ``pmax`` all-gather the
operands and combine them in rank order, as ``ThreadGroup`` does, so a
float sum (BC ``scores``) is bit-equal to ``ThreadGroup``'s on the same
mesh size.  ``dist.all_reduce`` is not used: its order is the library's.

**Byte counts.**  ``bytes`` / ``calls`` count exactly what
``ThreadGroup`` counts (the reference's HLO op names, one rank's result
bytes), so ``collective_bytes`` is the same under both groups.  What the
transport really carries goes in ``moved``, per op: the gathered result a
rank holds (n x the operand for a gather-based reduction), a permute's
received message, the merge of split outputs (``"merge"``), the service's
control messages (``"control"``) and, under gloo with CUDA tensors, the
copies between the card and host memory (``"host-staging"``).
``DistGroup.moved`` holds one launch's; ``DistMesh.moved`` the running
total of the process.

**Failure.**  A collective that fails (a peer died, closed its
connections or missed the timeout) marks the mesh broken and raises
:class:`RankFailure`; so does every later collective.  A body that raises
aborts the process group, so every peer's pending collective fails at
once instead of waiting out the timeout.  ``RankFailure`` derives from
``BaseException``, like the journal's simulated crash: the process group
cannot be trusted after it, and the services' retry ladders must not
retry on it.

Launchers: :func:`spawn` runs ``fn(mesh, *args)`` in ``nprocs`` fresh
processes (``torch.multiprocessing``, ``start_method="spawn"``) with a
``file://`` rendezvous in a temporary directory (no network);
:func:`init_from_env` serves ``torchrun``.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .group import DEFAULT_TIMEOUT_S, _nbytes

TRANSPORTS = ("gloo", "nccl")

_HEADER = 16    # bytes of a gloo payload's header: op code, sequence number
_ALIGN = 8      # each tensor of a payload starts at a multiple of 8 bytes
_CONTROL = 64   # bytes of a control message's first frame
_FRAME = 1 << 16    # bytes of each further frame of a longer one
_OP_CODES = {"all-reduce": 1, "all-gather": 2, "collective-permute": 3,
             "merge": 4, "control": 5, "barrier": 6, "all-to-all": 7,
             "reduce-scatter": 8}


class RankFailure(BaseException):
    """A collective of a :class:`DistMesh` failed, or the mesh was broken
    by an earlier failure: this process cannot take part in the group any
    more (module docstring)."""


def _own_device(device, rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available on this machine; pass "
                "device='cpu' to run the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch: CUDA is not available on this "
                               "machine")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _padded(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _card_bytes(tensors) -> int:
    """Bytes of the tensors that live on a card (what staging copies)."""
    return sum(_nbytes(t) for t in tensors if t.is_cuda)


def _host_scalar(x) -> torch.Tensor:
    """A host scalar as a one-element CPU tensor, exactly (bools and ints
    as int64, floats as float64)."""
    if isinstance(x, float):
        return torch.tensor([x], dtype=torch.float64)
    return torch.tensor([int(x)], dtype=torch.int64)


class DistMesh:
    """The graph axis across processes: this process is rank ``rank`` of
    ``world_size``, on ``device`` (default ``cuda:{LOCAL_RANK %
    device_count}``; ``"cpu"`` only when asked).  Initialises the process
    group from ``init_method`` (a ``file://`` or ``tcp://`` address, or
    ``"env://"`` under ``torchrun``); ``transport`` is ``"nccl"`` or
    ``"gloo"`` (module docstring); ``timeout`` bounds every collective.
    ``shape`` / ``axis_names`` name the axes (module docstring; default
    one ``"graph"`` axis over every rank).  ``close()`` destroys the
    process group."""

    def __init__(self, rank: int, world_size: int, init_method: str, *,
                 transport: str = "nccl", device=None,
                 timeout: float = DEFAULT_TIMEOUT_S, shape=None,
                 axis_names=None):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; supported "
                             f"transports: {', '.join(TRANSPORTS)}")
        dev = _own_device(device, rank)
        if transport == "nccl" and dev.type != "cuda":
            raise ValueError("the nccl transport needs one card per rank; "
                             f"rank {rank} asked for {dev}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "gloo" if transport == "gloo" else "cpu:gloo,cuda:nccl"
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        self.rank = rank
        self._world = world_size
        self.transport = transport
        self.device = dev
        self.timeout = timeout
        self.moved: dict = {}
        self.transport_s = 0.0      # wall spent in the transport's calls
        self.broken = False
        self._seq = 0
        self._open = True
        code = -1 if dev.type == "cpu" else dev.index
        codes = [int(c[0]) for c in self._exchange(
            "control", [torch.tensor([code])], {}, to_device=False)]
        self.devices = tuple(torch.device("cpu") if c < 0
                             else torch.device("cuda", c) for c in codes)
        if transport == "nccl" and len(set(self.devices)) < world_size:
            self.close()
            raise ValueError(
                "the nccl transport needs one card per rank; the ranks' "
                f"devices are {[str(d) for d in self.devices]} (ranks "
                "sharing a card take transport='gloo')")
        self.axis_names: tuple = ("graph",)
        self.shape: tuple = (world_size,)
        self._lines: dict = {}
        self._groups: dict = {}
        if shape is not None:
            self.set_axes(shape, axis_names)

    # -------------------------------- axes --------------------------------

    def set_axes(self, shape, axis_names) -> None:
        """Lay the ranks out over named axes, rank-major (module
        docstring), and build every axis's subgroups.  Collective over the
        world: every rank calls it with the same arguments."""
        shape, names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "do not match")
        if math.prod(shape) != self.size:
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{math.prod(shape)} ranks; the world has "
                             f"{self.size}")
        if self._lines:
            raise ValueError(f"{self!r} already has axes {self.axis_names}")
        lines = {}
        for i, name in enumerate(names):
            others = [range(n) for j, n in enumerate(shape) if j != i]
            for rest in itertools.product(*others):
                members = []
                for k in range(shape[i]):
                    c = list(rest)
                    c.insert(i, k)
                    members.append(self.rank_of(c, shape))
                pg = dist.new_group(members) if shape[i] > 1 else None
                if self.rank in members:
                    lines[name] = (pg, tuple(members))
        self.shape, self.axis_names, self._lines = shape, names, lines

    def group(self, axis: Optional[str] = None) -> "DistGroup":
        """The :class:`DistGroup` over ``axis`` (``None``: every rank),
        made once; all of them count into the world group's tallies."""
        if axis not in self._groups:
            world = self._groups.get(None)
            if world is None:
                world = self._groups[None] = DistGroup(self)
            self._groups[axis] = DistGroup(self, axis, counts=world)
        return self._groups[axis]

    @staticmethod
    def rank_of(coords, shape) -> int:
        r = 0
        for c, n in zip(coords, shape):
            r = r * n + int(c)
        return r

    @property
    def coords(self) -> dict:
        """This rank's index along each axis."""
        out, r = {}, self.rank
        for name, n in reversed(tuple(zip(self.axis_names, self.shape))):
            out[name] = r % n
            r //= n
        return dict(reversed(tuple(out.items())))

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def line(self, axis: Optional[str]):
        """``(process group, member ranks)`` of this rank's line along
        ``axis``; ``None``: the world."""
        if axis is None:
            return None, tuple(range(self.size))
        if axis not in self._lines:
            raise ValueError(f"{self!r} has no axis {axis!r} (axes "
                             f"{self.axis_names})")
        return self._lines[axis]

    # -------------------------------- axis --------------------------------

    @property
    def size(self) -> int:
        return self._world

    def __len__(self) -> int:
        return self._world

    def __eq__(self, other) -> bool:
        return (isinstance(other, DistMesh) and other.rank == self.rank
                and other.devices == self.devices)

    def __hash__(self) -> int:
        return hash(("dist", self.rank, self.devices))

    def __repr__(self) -> str:
        return (f"DistMesh(rank {self.rank} of {self.size}, {self.device}, "
                f"{self.transport})")

    # ----------------------------- transport ------------------------------

    def _tally(self, tally: dict, op: str, nbytes: int) -> None:
        if nbytes:
            for d in (tally, self.moved):
                d[op] = d.get(op, 0) + nbytes

    def _guard(self):
        if self.broken or not self._open:
            raise RankFailure(f"{self!r} is broken by an earlier failure "
                              "or closed")
        self._seq += 1
        return self._seq

    def _fail(self, e: Exception):
        self.broken = True
        return RankFailure(f"{self!r}: a collective failed: {e}")

    def _staged(self, tensors) -> bool:
        return self.transport == "gloo" or any(
            not t.is_cuda for t in tensors)

    def _buffer(self, shape, staged: bool) -> torch.Tensor:
        """A byte buffer: pinned host memory when staged from a card."""
        dev = "cpu" if staged else self.device
        return torch.empty(shape, dtype=torch.uint8, device=dev,
                           pin_memory=staged and self.device.type == "cuda")

    def _pack(self, op: str, seq: int, tensors, staged: bool, out=None):
        """One byte buffer of ``tensors`` (each at an 8-byte offset), with
        the header when staged through host memory; written into ``out``
        when given."""
        head = _HEADER if staged else 0
        sizes = [_padded(_nbytes(t)) for t in tensors]
        buf = self._buffer(head + sum(sizes), staged) if out is None else out
        if head:
            buf[:head].view(torch.int64).copy_(
                torch.tensor([_OP_CODES[op], seq]))
        off = head
        for t, size in zip(tensors, sizes):
            raw = _as_bytes(t)
            buf[off:off + raw.numel()].copy_(raw)
            off += size
        return buf

    def _unpack(self, op: str, seq: int, buf, like, staged: bool,
                to_device: bool, tally: dict) -> list:
        """``like``'s tensors read back out of a received ``buf``."""
        head = _HEADER if staged else 0
        if head:
            got = tuple(int(v) for v in buf[:head].view(torch.int64))
            if got != (_OP_CODES[op], seq):
                self.broken = True
                raise RankFailure(
                    f"{self!r}: collective {seq} ({op}) received the "
                    f"payload of op code {got[0]}, collective {got[1]}: "
                    "the ranks fell out of step")
        out, off = [], head
        for t in like:
            n = _nbytes(t)
            v = buf[off:off + n].view(t.dtype).view(t.shape)
            if to_device and v.device != self.device:
                v = v.to(self.device)
                self._tally(tally, "host-staging", n)
            else:  # a tensor of its own, not a view into the buffer
                v = v.clone()
            out.append(v)
            off += _padded(n)
        return out

    def _exchange(self, op: str, tensors, tally: dict,
                  to_device: bool = True, axis: Optional[str] = None) -> list:
        """Every rank's ``tensors`` (same shapes and types on every rank),
        in rank order: ``[[rank 0's], [rank 1's], ...]``; with ``axis``,
        the ranks of this rank's line along it, in their order."""
        seq = self._guard()
        pg, members = self.line(axis)
        n = len(members)
        if n == 1:
            return [list(tensors)]
        staged = self._staged(tensors)
        try:
            buf = self._pack(op, seq, tensors, staged)
            if staged:
                self._tally(tally, "host-staging", _card_bytes(tensors))
            out = torch.empty((n, buf.numel()), dtype=torch.uint8,
                              device=buf.device, pin_memory=buf.is_pinned())
            t0 = time.perf_counter()
            dist.all_gather(list(out.unbind(0)), buf, group=pg)
            self.transport_s += time.perf_counter() - t0
        except RankFailure:
            raise
        except Exception as e:  # noqa: BLE001 - the transport's failure
            raise self._fail(e) from e
        self._tally(tally, op, n * sum(map(_nbytes, tensors)))
        return [list(tensors) if r == self.rank  # its own, as sent
                else self._unpack(op, seq, out[i], tensors, staged,
                                  to_device, tally)
                for i, r in enumerate(members)]

    def _all_to_all(self, op: str, chunks, tally: dict,
                    axis: Optional[str]) -> list:
        """``chunks[i]`` (one tensor, the same shape and type for every
        ``i``) goes to the ``i``-th rank of this rank's line along
        ``axis``; returns what each of them sent this rank, in line
        order."""
        seq = self._guard()
        pg, members = self.line(axis)
        n, me = len(members), members.index(self.rank)
        if n == 1:
            return list(chunks)
        staged = self._staged(chunks)
        try:
            row = (_HEADER if staged else 0) + _padded(_nbytes(chunks[0]))
            buf = self._buffer((n, row), staged)
            for i, c in enumerate(chunks):
                self._pack(op, seq, [c], staged, out=buf[i])
            if staged:
                self._tally(tally, "host-staging", _card_bytes(
                    [c for i, c in enumerate(chunks) if i != me]))
            out = torch.empty_like(buf)
            t0 = time.perf_counter()
            dist.all_to_all_single(out, buf, group=pg)
            self.transport_s += time.perf_counter() - t0
        except RankFailure:
            raise
        except Exception as e:  # noqa: BLE001 - the transport's failure
            raise self._fail(e) from e
        like = [chunks[0]]
        self._tally(tally, op, (n - 1) * _nbytes(chunks[0]))
        return [chunks[i] if i == me
                else self._unpack(op, seq, out[i], like, staged, True,
                                  tally)[0] for i in range(n)]

    def _permute(self, op: str, tensors, to: Sequence[int],
                 frm: Optional[int], tally: dict):
        """Send ``tensors`` to every rank of ``to`` and receive the same
        shapes from ``frm`` (``None``: nothing); returns what was received
        (or ``None``)."""
        seq = self._guard()
        r = self.rank
        staged = self._staged(tensors)
        try:
            buf = self._pack(op, seq, tensors, staged)
            if staged and any(d != r for d in to):
                self._tally(tally, "host-staging", _card_bytes(tensors))
            ops = [dist.P2POp(dist.isend, buf, d) for d in to if d != r]
            recv = None
            if frm is not None and frm != r:
                recv = torch.empty(buf.numel(), dtype=torch.uint8,
                                   device=buf.device,
                                   pin_memory=buf.is_pinned())
                ops.append(dist.P2POp(dist.irecv, recv, frm))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
        except RankFailure:
            raise
        except Exception as e:  # noqa: BLE001 - the transport's failure
            raise self._fail(e) from e
        if frm is None:
            return None
        if frm == r:
            return list(tensors)
        self._tally(tally, op, sum(map(_nbytes, tensors)))
        return self._unpack(op, seq, recv, tensors, staged, True, tally)

    # ------------------------------ control -------------------------------

    def broadcast(self, value):
        """Rank 0's ``value`` (a JSON value), on every rank: the control
        message that keeps the ranks' clock-driven decisions in step, and
        the front end's commands (``serve.AsyncGraphService``).  Framed:
        a first frame of 64 bytes holds the length and the first bytes,
        and a longer value follows in frames of up to 64 KiB, as many as
        it needs (the other ranks' ``value`` is ignored; they learn the
        length from the first frame).  Counted in ``moved["control"]``,
        never in a group's collective bytes."""
        raw = json.dumps(value).encode() if self.rank == 0 else b""
        head = _CONTROL - 4
        frame = torch.zeros(_CONTROL, dtype=torch.uint8)
        frame[:4] = torch.tensor([len(raw)], dtype=torch.int32).view(
            torch.uint8)
        first = raw[:head]
        if first:
            frame[4:4 + len(first)] = torch.frombuffer(bytearray(first),
                                                       dtype=torch.uint8)
        got = self._exchange("control", [frame], {}, to_device=False)[0][0]
        n = int(got[:4].view(torch.int32)[0])
        out = [bytes(got[4:4 + min(n, head)].tolist())]
        for off in range(head, n, _FRAME):
            size = min(_FRAME, n - off)
            chunk = torch.zeros(size, dtype=torch.uint8)
            if self.rank == 0:
                chunk.copy_(torch.frombuffer(bytearray(raw[off:off + size]),
                                             dtype=torch.uint8))
            out.append(self._exchange("control", [chunk], {},
                                      to_device=False)[0][0].numpy()
                       .tobytes())
        return json.loads(b"".join(out))

    def barrier(self) -> None:
        """Every rank reached this point."""
        self._exchange("barrier", [torch.zeros(1, dtype=torch.uint8)], {},
                       to_device=False)

    def abort(self) -> None:
        """Mark the mesh broken and tear the process group down, so every
        peer's pending collective fails now (a rank's body raised)."""
        self.broken = True
        self.close()

    def close(self) -> None:
        if self._open:
            self._open = False
            if dist.is_initialized():
                dist.destroy_process_group()


class DistGroup:
    """One launch of a per-rank body on a :class:`DistMesh`, with
    :class:`~.group.ThreadGroup`'s methods (module docstring), over every
    rank or, with ``axis``, over this rank's line along that axis.
    ``bytes`` / ``calls`` hold the collectives' counts per op name after
    the run, ``moved`` what the transport carried; ``counts=`` shares
    another group's tallies."""

    def __init__(self, mesh: DistMesh, axis: Optional[str] = None,
                 counts: Optional["DistGroup"] = None):
        self.mesh = mesh
        self.axis = axis
        self._members = mesh.line(axis)[1]
        # ``counts``: another group whose tallies this one adds to (the
        # axes of one mesh, counted together).
        self.bytes: dict = {} if counts is None else counts.bytes
        self.calls: dict = {} if counts is None else counts.calls
        self.moved: dict = {} if counts is None else counts.moved

    # ------------------------------- axis --------------------------------

    def axis_index(self) -> int:
        return self._members.index(self.mesh.rank)

    def size(self) -> int:
        return len(self._members)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ---------------------------- collectives ----------------------------

    def _count(self, op: str, nbytes: int) -> None:
        self.bytes[op] = self.bytes.get(op, 0) + nbytes
        self.calls[op] = self.calls.get(op, 0) + 1

    def _gathered(self, x, op: str) -> list:
        """Every rank's ``x`` in rank order: tensors on this rank's device,
        host scalars as host scalars of ``x``'s type."""
        if isinstance(x, torch.Tensor):
            return [v[0] for v in self.mesh._exchange(op, [x], self.moved,
                                                      axis=self.axis)]
        vals = self.mesh._exchange(op, [_host_scalar(x)], self.moved,
                                   to_device=False, axis=self.axis)
        return [type(x)(v[0][0].item()) for v in vals]

    def _reduce(self, x, combine, op: str = "all-reduce"):
        vals = self._gathered(x, op)
        if isinstance(x, torch.Tensor):
            # One memory layout on every rank (its own operand may be a
            # strided view), so later reductions of the result sum alike.
            vals = [v.contiguous() for v in vals]
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
        vals = self._gathered(x, "all-gather")
        return torch.cat(vals) if tiled else torch.stack(vals)

    def all_to_all(self, x: torch.Tensor, split_axis: int = 0,
                   concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
        """``lax.all_to_all``: ``x`` split into ``size()`` chunks along
        ``split_axis``, chunk ``i`` sent to the ``i``-th rank; the chunks
        received, in rank order, concatenated along ``concat_axis``
        (``tiled``) or stacked on a new axis there."""
        n = self.size()
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        self._count("all-to-all", _nbytes(x))
        chunks = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
        got = self.mesh._all_to_all("all-to-all", chunks, self.moved,
                                    self.axis)
        return torch.cat(got, concat_axis) if tiled else torch.stack(
            got, concat_axis)

    def reduce_scatter(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's block along ``axis`` of the sum of ``x`` over the
        ranks: each rank receives its block from every rank and adds them
        in rank order (the same bits as ``psum`` and a slice)."""
        n = self.size()
        if x.shape[axis] % n:
            raise ValueError(f"reduce_scatter: axis {axis} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        self._count("reduce-scatter", _nbytes(x) // n)
        chunks = [c.contiguous() for c in x.chunk(n, dim=axis)]
        got = self.mesh._all_to_all("reduce-scatter", chunks, self.moved,
                                    self.axis)
        out = got[0]
        for v in got[1:]:
            out = out + v
        return out

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        """A split output concatenated over the ranks, on every process:
        the hand-off of a program's result, not one of the reference's
        in-program collectives (counted in ``moved`` only)."""
        return torch.cat(self._gathered(x, "merge"))

    def ppermute(self, x, perm):
        """``lax.ppermute``: rank ``d`` receives the ``x`` of rank ``s`` for
        each ``(s, d)`` in ``perm``, zeros where no rank sends to it.  ``x``
        is a tensor or a tuple of tensors."""
        r = self.axis_index()
        src = {d: s for s, d in perm}
        if any(s == 0 for s, _ in perm):  # ThreadGroup counts rank 0's
            self._count("collective-permute", _nbytes(x))
        ts = [x] if isinstance(x, torch.Tensor) else list(x)
        got = self.mesh._permute("collective-permute", ts,
                                 [d for s, d in perm if s == r],
                                 src.get(r), self.moved)
        if got is None:
            got = [torch.zeros_like(t) for t in ts]
        return got[0] if isinstance(x, torch.Tensor) else type(x)(got)

    # -------------------------------- run --------------------------------

    def run(self, body: Callable, rank_args: Sequence) -> list:
        """``body(self, *rank_args[rank])`` for this process's rank; the
        other ranks' slots of ``rank_args`` are not read and those of the
        returned list are ``None``.  A body that raises aborts the process
        group (module docstring) and re-raises."""
        mesh = self.mesh
        n = mesh.size
        if len(rank_args) != n:
            raise ValueError(f"{len(rank_args)} argument tuples for a mesh "
                             f"of {n} ranks")
        outs = [None] * n
        try:
            if mesh.device.type == "cuda":
                with torch.cuda.device(mesh.device):
                    outs[mesh.rank] = body(self, *rank_args[mesh.rank])
            else:
                outs[mesh.rank] = body(self, *rank_args[mesh.rank])
        except BaseException:
            mesh.abort()
            raise
        return outs


# ------------------------------- launchers ---------------------------------

def init_from_env(*, transport: str = "nccl", device=None,
                  timeout: float = DEFAULT_TIMEOUT_S) -> DistMesh:
    """The mesh of a ``torchrun`` process: rank and world size from
    ``RANK`` / ``WORLD_SIZE``, the rendezvous from ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``env://``), the card from ``LOCAL_RANK``."""
    return DistMesh(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                    "env://", transport=transport, device=device,
                    timeout=timeout)


class SpawnError(RuntimeError):
    """A process of :func:`spawn` failed or hung.  ``exitcodes[r]`` is rank
    ``r``'s exit code (``None``: killed after ``join_timeout``, or for
    hanging on after another rank failed); ``errors[r]`` its traceback."""

    def __init__(self, msg: str, exitcodes: list, errors: list):
        super().__init__(msg)
        self.exitcodes = exitcodes
        self.errors = errors


def _rank_main(rank: int, fn, nprocs: int, init_method: str, device,
               transport: str, timeout: float, args: tuple,
               outdir: str) -> None:
    """One process of :func:`spawn` (module level: spawn pickles it)."""
    mesh = None
    os.environ["LOCAL_RANK"] = str(rank)  # the default device's index
    try:
        mesh = DistMesh(rank, nprocs, init_method, transport=transport,
                        device=device, timeout=timeout)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(outdir, f"result.{rank}"))
    except BaseException:
        text = traceback.format_exc()
        with open(os.path.join(outdir, f"error.{rank}"), "w") as f:
            f.write(text)
        if mesh is not None:
            mesh.abort()
        # Exit here, not through torch.multiprocessing's wrapper: it would
        # put the traceback on a queue nobody reads, which can block.
        print(f"rank {rank}: {text}", file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(1)
    mesh.close()


def spawn(fn: Callable, nprocs: int, *, device=None, transport: str = "nccl",
          timeout: float = DEFAULT_TIMEOUT_S,
          join_timeout: Optional[float] = None, args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` in ``nprocs`` new processes, one
    :class:`DistMesh` rank each, and return their results in rank order.

    ``fn`` must be a module-level function (the processes are started with
    ``start_method="spawn"``, which pickles it).  ``device``: ``None`` puts
    rank ``r`` on ``cuda:{r % device_count}``, a device name puts every
    rank there (``"cuda:0"``: four ranks on one card; ``"cpu"``).  The
    rendezvous is a ``file://`` in a temporary directory.  ``timeout`` is
    the mesh's (every collective); ``join_timeout`` bounds the whole run.
    Once a process fails, the others have ``timeout`` more seconds to end
    on their own.  Raises :class:`SpawnError` if any process exits non-zero
    or is still running at a deadline; every process it started has ended
    when it returns or raises."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=nprocs, join=False, start_method="spawn",
            args=(fn, nprocs, f"file://{os.path.join(tmp, 'rendezvous')}",
                  device, transport, timeout, tuple(args), tmp))
        procs = ctx.processes
        start = time.monotonic()
        first_failure = None
        killed = [False] * nprocs
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if first_failure is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                first_failure = now
            late = ((join_timeout is not None
                     and now - start > join_timeout)
                    or (first_failure is not None
                        and now - first_failure > timeout + 10.0))
            if late:
                for r, p in enumerate(procs):
                    if p.is_alive():
                        p.kill()
                        killed[r] = True
                break
            time.sleep(0.05)
        for p in procs:
            p.join()
        codes = [None if killed[r] else p.exitcode
                 for r, p in enumerate(procs)]
        if any(c != 0 for c in codes):
            errors = []
            for r in range(nprocs):
                path = os.path.join(tmp, f"error.{r}")
                errors.append(open(path).read() if os.path.exists(path)
                              else "")
            detail = "\n".join(f"rank {r}: exit {c}\n{e}" for r, (c, e)
                               in enumerate(zip(codes, errors)))
            raise SpawnError(f"spawn of {nprocs} ranks failed "
                             f"(exit codes {codes}; None: killed)\n{detail}",
                             codes, errors)
        return [torch.load(os.path.join(tmp, f"result.{r}"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
