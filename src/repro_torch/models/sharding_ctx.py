"""Ambient sharding context (port of ``repro.models.sharding_ctx``), and
the collectives the model code runs on a mesh of processes.

The launcher installs the mesh; layer code asks for the layout with
*logical* tags (``resolve(shape, "dp", None, "tp")``: "dp" -> the batch
axes, "tp" -> ``model``, "xb" -> the batch axes but ``model``), resolved
and dropped from the end as the reference's ``constrain`` does.  In the
reference ``constrain`` asks XLA to lay an activation out so; here every
process runs the same code on its own block, so the layout is the code's
own, ``constrain`` returns ``x`` unchanged, and the sharded code reads
:func:`resolve` where it needs the layout.  Outside a context everything
here is a no-op, so model code never depends on a mesh being present.

On a mesh (ZeRO-3, the reference's ``full_batch`` posture) each process
stores only its block of every parameter (the sanitized specs the step
installs with ``params=``) and :func:`gathered` rebuilds a layer's
parameters where they are used, inside the layer's remat region, so the
backward gathers them again.  The autograd functions here are the
collectives with their transposes: an all-gather's backward is a
reduce-scatter, an all-to-all's an all-to-all, a psum's a psum.  Each
process's loss is its share of the global loss (:func:`batch_share`,
:func:`replicated_share`), so the gradient of the sum of the shares over
the processes -- which the transposes compute -- is the gradient of the
global loss; a leaf replicated over an axis then sums its gradient over it
(``launch.steps``).

In serving (``full_batch=False``) the batch rows are split over the data
axes only and the cache in the reference's layout (the sanitized
``cache_specs``, installed with ``cache=`` by role): a K/V cache's
sequence over ``model`` -- :func:`cache_block` says which rows of the
sequence this process holds, and :func:`pmax_over` / :func:`psum_over`
reduce the blocks' softmax maxima, sums and products -- and an SSM
state's channels or heads over ``model`` -- :func:`whole_state` gathers
a layer's state where it is used and :func:`own_block` keeps this
process's block of the new one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch


class P(tuple):
    """A partition spec: one entry per dimension, ``None`` (replicated),
    an axis name, or a tuple of names (the dimension split over their
    product, the first name major): ``P("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + repr(tuple(self))


def stacked(spec: "P", lead: int = 1) -> "P":
    """The reference's spec of a leaf stacked on ``lead`` leading axes."""
    return P(*((None,) * lead + tuple(spec)))


def unstacked(sh, lead: int = 1):
    """One layer's sharding of a leaf stacked on ``lead`` leading axes."""
    return dataclasses.replace(sh, spec=P(*tuple(sh.spec)[lead:]))


_CTX: dict = {"active": False, "dp": (), "tp": (), "sizes": {},
              "mesh": None, "params": None, "batch": (), "cache": {}}

# The sequence dimension of a stacked K/V cache [L, B, KV, S, D].
CACHE_SEQ_DIM = 3


@contextlib.contextmanager
def sharding_context(mesh, full_batch: bool = False, *, params=None,
                     batch: tuple = (), cache=None):
    """``full_batch=True`` (training): the batch dim shards over EVERY mesh
    axis (ZeRO-3 posture), in the order ("data", "model", "pod"): a dim
    that does not divide drops axes from the END.  ``params``: the tree of
    :class:`~repro_torch.launch.mesh.Sharding` of the parameters each
    process holds blocks of (``gathered`` reads it); ``batch``: the axes
    the local batch rows are split over; ``cache``: the
    :class:`~repro_torch.launch.mesh.Sharding` of each role of the cache
    each process holds a block of -- ``"kv"`` a self-attention K/V
    cache [L, B, KV, S, D], ``"cross"`` a cross-attention one, ``"conv"``
    and ``"ssd"`` one layer's SSM state [B, ...] -- (``cache_block``,
    ``whole_state`` and ``own_block`` read it; a role left out is whole)."""
    names = tuple(mesh.axis_names)
    old = dict(_CTX)
    dp_order = ("data", "model", "pod") if full_batch else ("pod", "data")
    _CTX.update(
        active=True,
        dp=tuple(a for a in dp_order if a in names),
        tp=tuple(a for a in ("model",) if a in names),
        sizes=dict(zip(names, mesh.shape)),
        mesh=mesh,
        params=params,
        batch=tuple(batch),
        cache=dict(cache or {}),
    )
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(old)


def _resolve(tag: Optional[str]):
    if tag is None:
        return None
    if tag == "dp":
        return _CTX["dp"] or None
    if tag == "tp":
        return _CTX["tp"] or None
    if tag == "xb":
        # batch axes excluding the model axis (frees it for vocab/TP use in
        # the same tensor, e.g. chunked-xent logits [b, s, vocab])
        xb = tuple(a for a in _CTX["dp"] if a != "model")
        return xb or None
    return tag


def resolve(shape, *tags) -> Optional[tuple]:
    """The spec ``constrain(x, *tags)`` stands for on an ``x`` of ``shape``
    (the reference's ``with_sharding_constraint`` argument), as a tuple of
    entries; ``None`` outside a context."""
    if not _CTX["active"]:
        return None
    spec = []
    used: set = set()
    for dim, tag in zip(shape, tags):
        r = _resolve(tag)
        if r is None:
            spec.append(None)
            continue
        axes = tuple(a for a in (r if isinstance(r, tuple) else (r,))
                     if a not in used)
        # drop axes from the end until the dim divides evenly
        while axes and dim % math.prod(_CTX["sizes"].get(a, 1)
                                       for a in axes) != 0:
            axes = axes[:-1]
        if not axes:
            spec.append(None)
            continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


def constrain(x: torch.Tensor, *tags) -> torch.Tensor:
    """``x`` as it is: each process already holds its own block."""
    return x


# ------------------------------ the live mesh ------------------------------

def live_mesh():
    """The installed mesh of processes, or ``None``."""
    mesh = _CTX["mesh"] if _CTX["active"] else None
    return mesh if hasattr(mesh, "group") else None


def batch_axes() -> tuple:
    """The axes the local batch rows are split over (``()`` outside)."""
    return _CTX["batch"] if live_mesh() is not None else ()


def _replicas() -> int:
    """How many processes hold the same batch rows."""
    sizes = _CTX["sizes"]
    return math.prod(sizes.values()) // math.prod(
        sizes[a] for a in batch_axes())


def block_of(sh, dim: int, rows: int) -> tuple:
    """``(first index, axes)`` of this process's block along ``dim`` of a
    tensor laid out by the :class:`~repro_torch.launch.mesh.Sharding`
    ``sh``, ``rows`` entries long here: the block's first global index and
    the mesh axes ``dim`` is split over, as ``Sharding.index`` reads them.
    ``(0, ())`` where the dimension is whole (``sh`` None, or no axis)."""
    spec = () if sh is None else tuple(sh.spec)
    entry = spec[dim] if dim < len(spec) else None
    if entry is None or live_mesh() is None:
        return 0, ()
    axes = entry if isinstance(entry, tuple) else (entry,)
    mesh = live_mesh()
    block = 0
    for a in axes:
        block = block * mesh.sizes[a] + mesh.coords[a]
    return block * rows, axes


def _cache_sharding(role: str):
    return _CTX["cache"].get(role) if live_mesh() is not None else None


def cache_block(rows: int, role: str = "kv") -> tuple:
    """``block_of`` the sequence of the K/V cache of ``role`` (``"kv"``
    or ``"cross"``; the installed cache sharding), ``rows`` rows here.
    ``(0, ())`` where the whole sequence is local: outside a mesh, or
    where the sanitized spec dropped the split (a length that ``model``
    does not divide)."""
    return block_of(_cache_sharding(role), CACHE_SEQ_DIM, rows)


def _split_dims(sh):
    """``(dim, axes)`` of each dimension ``sh`` splits but the batch's (the
    local rows: its axes are all batch axes)."""
    out = []
    for dim, entry in enumerate(() if sh is None else sh.spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        if axes and not set(axes) <= set(_CTX["batch"]):
            out.append((dim, axes))
    return out


def whole_state(x: torch.Tensor, role: str) -> torch.Tensor:
    """This process's block ``x`` of a cache leaf of ``role`` gathered
    over the axes its sanitized spec splits, in rank order, but the batch
    rows (this process's own): the whole state of its rows.  ``x`` itself
    outside a mesh, or where the spec splits nothing (a dimension that
    ``model`` does not divide stays whole)."""
    for dim, axes in _split_dims(_cache_sharding(role)):
        for a in reversed(axes):
            x = all_gather(x, a, dim)
    return x.contiguous()


def own_block(x: torch.Tensor, role: str) -> torch.Tensor:
    """This process's block of the whole state ``x`` of ``role`` (a view),
    the layout ``whole_state`` gathered it from."""
    sh = _cache_sharding(role)
    for dim, axes in _split_dims(sh):
        rows = x.shape[dim] // math.prod(live_mesh().sizes[a] for a in axes)
        x = x.narrow(dim, block_of(sh, dim, rows)[0], rows)
    return x


def pmax_over(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the processes of ``axes`` (no
    gradient)."""
    for a in axes:
        x = live_mesh().group(a).pmax(x)
    return x


def psum_over(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """The sum of ``x`` over the processes of ``axes`` in rank order (no
    gradient): every process gets the same bits."""
    for a in axes:
        x = live_mesh().group(a).psum(x)
    return x


def batch_share(x):
    """A term computed on the local batch rows, as its share of the sum
    over the processes: divided by the processes holding the same rows."""
    return x if live_mesh() is None else x / _replicas()


def replicated_share(x):
    """A term every process computes alike, as its share of the sum over
    the processes."""
    mesh = live_mesh()
    return x if mesh is None else x / mesh.size


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """The sum of a local-batch statistic over the whole batch (no
    gradient): a rank-ordered sum over the batch axes."""
    if live_mesh() is None:
        return x
    x = x.detach()
    for a in batch_axes():
        x = live_mesh().group(a).psum(x)
    return x


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim`` over one axis; backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        g = live_mesh().group(axis)
        ctx.group = g
        return g.all_gather(x.movedim(dim, 0)).movedim(0, dim)

    @staticmethod
    def backward(ctx, gy):
        d = ctx.dim
        gx = ctx.group.reduce_scatter(gy.movedim(d, 0)).movedim(0, d)
        return gx.contiguous(), None, None


class _Psum(torch.autograd.Function):
    """Rank-ordered sum over one axis; backward: the same sum."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.group = live_mesh().group(axis)
        return ctx.group.psum(x)

    @staticmethod
    def backward(ctx, gy):
        return ctx.group.psum(gy), None


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all on axis 0 over one axis; backward: the same."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.group = live_mesh().group(axis)
        return ctx.group.all_to_all(x)

    @staticmethod
    def backward(ctx, gy):
        return ctx.group.all_to_all(gy.contiguous()), None


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``, differentiable."""
    return _AllGather.apply(x, axis, dim)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _Psum.apply(x, axis)


def pmean(x: torch.Tensor, axis: str) -> torch.Tensor:
    return psum(x, axis) / live_mesh().sizes[axis]


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``, differentiable (an
    integer ``x`` goes without autograd)."""
    if not x.is_floating_point():
        return live_mesh().group(axis).all_to_all(x)
    return _AllToAll.apply(x, axis)


def gather_leaf(x: torch.Tensor, spec) -> torch.Tensor:
    """The whole parameter from this process's block (``spec``: its
    sanitized :class:`~repro_torch.launch.mesh.P`), laid out as the whole
    parameter is (contiguous), so its products take the one-process
    path's kernels; the backward reduce-scatters the gradient back to the
    block."""
    for dim, entry in enumerate(spec):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        for name in reversed(names):
            x = all_gather(x, name, dim)
    return x.contiguous()


def _tree_gather(tree, shardings):
    if isinstance(tree, dict):
        return {k: _tree_gather(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_gather(v, s) for v, s in zip(tree, shardings)]
    return gather_leaf(tree, shardings.spec)


def param_shardings(*path):
    """The installed shardings of the parameters at ``path`` (``None``
    outside a mesh)."""
    sh = _CTX["params"] if live_mesh() is not None else None
    for k in path:
        if sh is None:
            return None
        sh = sh[k]
    return sh


def gathered(tree, *path, keep: tuple = ()):
    """``tree`` (the parameters at ``path`` of the installed tree) with
    every leaf whole: each gathered over the axes its block is split over,
    but the subtrees under ``keep``'s keys, left as blocks.  ``tree``
    itself outside a mesh."""
    sh = param_shardings(*path)
    if sh is None:
        return tree
    if keep:
        return {k: v if k in keep else _tree_gather(v, sh[k])
                for k, v in tree.items()}
    return _tree_gather(tree, sh)


def relayout(x: torch.Tensor, have: tuple, want: tuple) -> torch.Tensor:
    """The local block of ``x`` (split along axis 0 over ``have``) as the
    block of the layout split over ``want`` instead: gathered over the
    axes of ``have`` past the two layouts' common leading axes, then cut
    to the block of the rest of ``want`` (no collective where ``want``
    only splits ``have``'s blocks further)."""
    have, want = tuple(have), tuple(want)
    if have == want:
        return x
    c = 0
    while c < min(len(have), len(want)) and have[c] == want[c]:
        c += 1
    for a in reversed(have[c:]):
        x = all_gather(x, a, 0)
    mesh = live_mesh()
    block, n = 0, 1
    for a in want[c:]:
        block = block * mesh.sizes[a] + mesh.coords[a]
        n *= mesh.sizes[a]
    rows = x.shape[0] // n
    return x[block * rows:(block + 1) * rows]
