"""Production mesh construction and sharding-spec sanitization (port of
``repro.launch.mesh``), over processes.

The reference lays an LM train state out over a ``("data", "model")``
mesh of devices driven by one program.  Here a mesh is one process per
rank (:class:`~repro_torch.shard.dist.DistMesh` with named axes) and each
process holds only its block of every sharded tensor; a
:class:`Sharding` says which block.  A :class:`MeshLayout` is a mesh's
axes without processes: enough for every spec and shape computation (the
dry run's layouts), as the reference's placeholder devices are.

A spec :class:`P` is a tuple of entries, one per dimension: ``None``
(replicated), an axis name, or a tuple of names (the dimension split over
their product, the first name major).  Importing this module touches no
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.models.sharding_ctx import P
from repro_torch.shard.dist import DistMesh, init_from_env
from repro_torch.shard.group import GraphMesh, as_graph_mesh


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's named axes and sizes, with no processes behind them."""
    shape: tuple
    axis_names: tuple

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(mesh: Optional[DistMesh] = None, *,
                         multi_pod: bool = False, shape=None):
    """16 x 16 ranks a pod; the multi-pod mesh adds a leading 2-pod axis.
    ``shape`` replaces the sizes (the same axes), as the reference's
    placeholder device count does.  With a :class:`DistMesh` its ranks are
    laid out over the axes (collective: every rank calls it), and the
    world size must equal the product; without one, the
    :class:`MeshLayout`."""
    default, names = PRODUCTION[multi_pod]
    shape = tuple(shape) if shape is not None else default
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} for axes {names}")
    if mesh is None:
        return MeshLayout(shape, names)
    if mesh.size != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} processes; the world has "
                         f"{mesh.size}")
    if (mesh.shape, mesh.axis_names) != (shape, names):
        mesh.set_axes(shape, names)
    return mesh


def dp_axes(mesh) -> tuple:
    """The data-parallel axes: batch shards over (pod, data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_graph_mesh(mesh=None) -> GraphMesh | DistMesh:
    """The 1-D ``graph`` axis the sharded tile-grid engine
    (``repro_torch.shard``) partitions over: ``mesh``'s devices flattened,
    or every visible CUDA device when ``None``.  A
    :class:`~repro_torch.shard.dist.DistMesh` is returned as it is, and
    ``"dist"`` builds this process's from a ``torchrun`` environment
    (``init_from_env()``: NCCL, one card per rank)."""
    if isinstance(mesh, str) and mesh == "dist":
        return init_from_env()
    return as_graph_mesh(mesh)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop axes that are absent from the mesh or don't divide the dim
    (from the end of each entry)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    spec = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    out = []
    for dim, entry in zip(shape, spec):
        names = tuple(n for n in _names(entry) if n in sizes)
        while names and dim % math.prod(sizes[n] for n in names) != 0:
            names = names[:-1]
        out.append(None if not names else
                   names[0] if len(names) == 1 else names)
    return P(*out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a sanitized spec: which block of a tensor each rank
    holds.  ``local`` cuts a rank's block out of a whole tensor (or
    numpy array), ``gather`` rebuilds the whole tensor from every rank's
    block (collective over the axes the spec names)."""
    mesh: object
    spec: P

    @property
    def axes(self) -> tuple:
        """Every mesh axis the spec splits a dimension over."""
        return tuple(n for e in self.spec for n in _names(e))

    def local_shape(self, shape) -> tuple:
        sizes = dict(zip(self.mesh.axis_names, self.mesh.shape))
        return tuple(d // math.prod(sizes[n] for n in _names(e))
                     for d, e in zip(shape, tuple(self.spec)
                                     + (None,) * (len(shape)
                                                  - len(self.spec))))

    def index(self, shape) -> tuple:
        """The slices of this process's block of a tensor of ``shape``."""
        coords = self.mesh.coords
        sizes = dict(zip(self.mesh.axis_names, self.mesh.shape))
        out = []
        for d, n, e in zip(shape, self.local_shape(shape),
                           tuple(self.spec) + (None,) * len(shape)):
            block = 0
            for name in _names(e):
                block = block * sizes[name] + coords[name]
            out.append(slice(block * n, (block + 1) * n))
        return tuple(out)

    def local(self, t):
        """This process's block of the whole ``t`` (a view)."""
        return t[self.index(t.shape)] if len(t.shape) else t

    def gather(self, t_local: torch.Tensor) -> torch.Tensor:
        """The whole tensor, on every rank, from each rank's block."""
        out = t_local
        for dim, entry in enumerate(self.spec):
            for name in reversed(_names(entry)):
                g = self.mesh.group(name)
                out = g.all_gather(out.movedim(dim, 0)).movedim(0, dim)
        return out


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of specs (a :class:`P` or
    ``None`` is a leaf) and trees of the same structure."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list) or (isinstance(specs, tuple)
                                   and not isinstance(specs, P)):
        out = [map_specs(fn, *xs) for xs in zip(specs, *trees)]
        return type(specs)(*out) if hasattr(specs, "_fields") else \
            type(specs)(out)
    return fn(specs, *trees)


def sanitize_shardings(specs, shapes, mesh):
    """Tree of desired :class:`P` -> tree of :class:`Sharding`, validated
    against ``mesh``.  ``shapes`` is a matching tree of tensors (``meta``
    ones will do) or shape tuples."""
    def one(spec, like):
        if like is None:            # an absent subtree (a cache's tail)
            return None
        shape = tuple(getattr(like, "shape", like if isinstance(
            like, tuple) else ()))  # an int (a cache's fill index): ()
        return Sharding(mesh, sanitize_spec(spec or P(), shape, mesh))
    return map_specs(one, specs, shapes)


def batch_shardings(batch_shapes: dict, mesh, full_batch: bool = False):
    """Input batches: leading dim over the DP axes; training shards the
    batch over EVERY axis (order data, model, pod -- drop-from-end keeps
    (data, model) when the pod axis doesn't divide).  M-RoPE positions
    carry a leading section axis, so the batch dim is axis 1 there."""
    if full_batch:
        dp = tuple(a for a in ("data", "model", "pod")
                   if a in mesh.axis_names)
    else:
        dp = dp_axes(mesh)
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        if k == "positions":
            spec = P(None, dp)
        elif len(shape) >= 1:
            spec = P(dp)
        else:
            spec = P()
        out[k] = Sharding(mesh, sanitize_spec(spec, shape, mesh))
    return out
