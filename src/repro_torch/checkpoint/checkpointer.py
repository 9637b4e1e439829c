"""Versioned checkpoint store with snapshot validation (port of
``repro.checkpoint.checkpointer``).

  * every save commits a new **version** and writes the manifest LAST,
    atomically (tmp + rename): leaves written before the rename are
    invisible, like nodes linked but not yet reachable;
  * a restore performs the paper's **double collect**: read manifest ->
    load leaves -> re-read manifest; if the version moved, a concurrent
    writer raced the read and the restore retries;
  * optional per-leaf sha1 checksums play the role of ``ecnt``: a leaf
    rewritten in place between the two manifest reads is detected.

The on-disk format is the reference's: one ``.npy`` file per leaf, named by
the leaf's path in the tree (a ``NamedTuple`` field name, a dict key or a
sequence index, joined with ``/``), ``manifest.json`` per step and
``index.json`` per store.  A ``GraphState`` names its leaves by its six
field names in both packages, so either package restores a snapshot the
other wrote.

Leaves are tensors (or numpy arrays); a restore builds tensors on the
device the caller names, ``"cuda"`` by default, and reads only the leaves
the caller's tree names.  bfloat16 and float8_e5m2 leaves, which numpy has
no type for, are written as the reference writes them (its ``ml_dtypes``
arrays): the raw bits under the ``.npy`` descr ``'<V2'`` / ``'<f1'``, and
``"bfloat16"`` / ``"float8_e5m2"`` as the manifest's dtype; they are read
back as raw bits and viewed as the torch dtype.

A restore also reads the layout the reference's trainer writes, where
each per-layer leaf is one stacked file (``params/layers/attn/wq`` of
shape ``[L, ...]``, ``opt/m/blocks/...`` of ``[S, K, ...]``): a leaf of
the port's per-layer layout that the manifest lacks is copied out of
its stacked file, memory-mapped, one slice (``models.convert
.reference_name``); with ``verify=`` the checksum covers the whole
stacked file, as the reference wrote it.  Saves keep the port's layout.

On a mesh of processes (``launch.mesh``) a restore with ``mesh=`` /
``specs=`` reads each leaf memory-mapped and keeps only this rank's block
(elastic: the files do not record the mesh that wrote them, so a state
saved by one process restores onto a mesh and back), and a
:class:`Checkpointer` save from a mesh gathers each leaf whole; rank 0
alone writes, the files byte-equal to a one-process save of the same
state, and the others wait at a barrier where the writes must be done.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, path=()):
    """``(path, leaf)`` pairs in the reference's flattening order."""
    if _is_namedtuple(tree):
        for name, child in zip(tree._fields, tree):
            yield from _leaves(child, path + (name,))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    elif isinstance(tree, (tuple, list)):
        for i, child in enumerate(tree):
            yield from _leaves(child, path + (str(i),))
    else:
        yield path, tree


def _path_str(path) -> str:
    return "/".join(path) or "_root"


def _rebuild(tree_like, leaf_fn, path=()):
    """``tree_like``'s structure with each leaf replaced by
    ``leaf_fn(path string, like leaf)``."""
    if _is_namedtuple(tree_like):
        return type(tree_like)(*(
            _rebuild(c, leaf_fn, path + (n,))
            for n, c in zip(tree_like._fields, tree_like)))
    if isinstance(tree_like, dict):
        return {k: _rebuild(v, leaf_fn, path + (str(k),))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (tuple, list)):
        return type(tree_like)(_rebuild(c, leaf_fn, path + (str(i),))
                               for i, c in enumerate(tree_like))
    return leaf_fn(_path_str(path), tree_like)


# torch dtype: (manifest dtype, .npy descr, numpy type of the raw bits, torch
# integer type of the same width) for the leaf dtypes numpy cannot hold.
RAW_DTYPES = {
    torch.bfloat16: ("bfloat16", "<V2", np.uint16, torch.int16),
    torch.float8_e5m2: ("float8_e5m2", "<f1", np.uint8, torch.int8),
}
_RAW_BY_NAME = {v[0]: k for k, v in RAW_DTYPES.items()}


class RawLeaf:
    """The host copy of a bfloat16 / float8 leaf: its raw bits and the
    torch dtype they encode."""
    __slots__ = ("bits", "dtype")

    def __init__(self, bits: np.ndarray, dtype: torch.dtype):
        self.bits, self.dtype = bits, dtype

    @property
    def shape(self):
        return self.bits.shape

    def tensor(self) -> torch.Tensor:
        """The leaf as a CPU tensor of its dtype (no copy)."""
        itype = RAW_DTYPES[self.dtype][3]
        return torch.from_numpy(self.bits.view(
            torch.empty(0, dtype=itype).numpy().dtype)).view(self.dtype)


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in RAW_DTYPES:
            _, _, bits, itype = RAW_DTYPES[t.dtype]
            return RawLeaf(t.contiguous().view(itype).numpy().view(bits),
                           t.dtype)
        return t.numpy()
    if isinstance(leaf, RawLeaf):
        return leaf
    return np.asarray(leaf)


def _numpy_dtype(like) -> np.dtype:
    if isinstance(like, torch.Tensor):
        return torch.empty(0, dtype=like.dtype).numpy().dtype
    return np.dtype(like.dtype)


def _save_leaf(path: str, arr) -> str:
    """Write one leaf as ``.npy``; returns the manifest's dtype name."""
    if not isinstance(arr, RawLeaf):
        np.save(path, arr)
        return str(arr.dtype)
    name, descr, _, _ = RAW_DTYPES[arr.dtype]
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr.bits).tobytes())
    return name


def _load_leaf(path: str, entry: dict, mmap: bool = False):
    """A leaf as ``_save_leaf`` (or the reference) wrote it: a numpy array,
    or a ``RawLeaf`` for a dtype numpy cannot hold; ``mmap``: mapped, not
    read."""
    dtype = _RAW_BY_NAME.get(entry["dtype"])
    if dtype is None:
        return np.load(path, mmap_mode="r" if mmap else None)
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        size = int.from_bytes(f.read(2 if version == (1, 0) else 4), "little")
        header = ast.literal_eval(f.read(size).decode("latin1"))
        if mmap:
            bits = np.memmap(f, dtype=RAW_DTYPES[dtype][2], mode="r",
                             offset=f.tell(), shape=tuple(header["shape"]))
        else:
            bits = np.fromfile(f, dtype=RAW_DTYPES[dtype][2])
    return RawLeaf(bits.reshape(header["shape"]), dtype)


def _bits(arr) -> np.ndarray:
    return arr.bits if isinstance(arr, RawLeaf) else arr


def _tensor(arr, like, dev, block=None) -> torch.Tensor:
    """A loaded leaf (or its ``block``, a tuple of slices) as a tensor of
    ``like``'s dtype on ``dev``."""
    if block is not None:   # copied out of the mapped file
        arr = (RawLeaf(np.array(arr.bits[block]), arr.dtype)
               if isinstance(arr, RawLeaf) else np.array(arr[block]))
    if isinstance(arr, RawLeaf):
        return arr.tensor().to(device=dev, dtype=like.dtype)
    if isinstance(like, torch.Tensor) and like.dtype in RAW_DTYPES:
        return torch.from_numpy(arr).to(device=dev, dtype=like.dtype)
    return torch.from_numpy(arr.astype(_numpy_dtype(like),
                                       copy=False)).to(dev)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def like_from_manifest(cls, manifest: dict):
    """A ``NamedTuple`` ``cls`` of shape/dtype-only (``meta``) tensors read
    from a manifest's leaves: the skeleton :func:`restore_checkpoint`
    needs when only the snapshot knows the capacities."""
    def like(name):
        entry = manifest["leaves"][name]
        dtype = _RAW_BY_NAME.get(entry["dtype"]) or torch.from_numpy(
            np.empty(0, entry["dtype"])).dtype
        return torch.empty(tuple(entry["shape"]), dtype=dtype, device="meta")
    return cls(*(like(name) for name in cls._fields))


def save_checkpoint(ckpt_dir: str, step: int, tree, *, version: int,
                    verify: bool = False, extra: Optional[dict] = None) -> dict:
    """Write one checkpoint; returns the manifest.

    ``extra`` is an optional JSON-serializable dict stored verbatim in the
    manifest (and thus committed atomically with it) -- side-car state
    that must travel with the snapshot, e.g. learned serving thresholds.
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    manifest = {"step": step, "version": version, "leaves": {},
                "time": time.time()}
    if extra:
        manifest["extra"] = extra
    for path, leaf in _leaves(tree):
        name = _path_str(path)
        arr = _host(leaf)
        fn = name.replace("/", ".") + ".npy"
        dtype = _save_leaf(os.path.join(d, fn), arr)
        entry = {"file": fn, "shape": list(arr.shape), "dtype": dtype}
        if verify:
            entry["sha1"] = _checksum(_bits(arr))
        manifest["leaves"][name] = entry
    # manifest last + atomic rename = the commit point (linearization point)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(d, "manifest.json"))
    _update_index(ckpt_dir, step, version)
    return manifest


def _update_index(ckpt_dir: str, step: int, version: int) -> None:
    idx_path = os.path.join(ckpt_dir, "index.json")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump({"latest_step": step, "version": version}, f)
    os.replace(tmp, idx_path)


def latest_step(ckpt_dir: str) -> Optional[int]:
    idx_path = os.path.join(ckpt_dir, "index.json")
    if not os.path.exists(idx_path):
        return None
    with open(idx_path) as f:
        return json.load(f)["latest_step"]


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """The committed manifest of one step (the atomically-renamed file)."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def restore_checkpoint(ckpt_dir: str, step: int, tree_like, *,
                       device="cuda", mesh=None, specs=None,
                       verify: bool = False, max_retries: int = 8):
    """Double-collect validated restore onto ``device``.

    ``tree_like`` supplies the structure and the dtypes (tensors, ``meta``
    tensors as :func:`like_from_manifest` builds, or numpy arrays); every
    leaf comes back as a tensor on ``device`` (default ``"cuda"``, which
    raises without CUDA).  Only the leaves ``tree_like`` names are read;
    one that the manifest lacks is read from the reference's stacked leaf
    (module docstring), and one under neither name raises ``KeyError``.
    With ``mesh`` (a mesh of processes) and ``specs`` (a tree of
    ``launch.mesh.P`` like ``tree_like``; ``None`` leaves replicate), each
    leaf is mapped, not read, and only this rank's block is copied out.
    """
    from repro_torch.core.graph_state import resolve_device

    if (mesh is None) != (specs is None):
        raise ValueError("restore_checkpoint: mesh= and specs= go together")
    dev = resolve_device(device)
    blocks = {}
    if mesh is not None:
        from repro_torch.launch.mesh import Sharding, sanitize_spec

        for path, like in _leaves(tree_like):
            spec = specs
            for key in path:
                spec = getattr(spec, key) if hasattr(spec, "_fields") else \
                    spec[int(key) if isinstance(spec, (list, tuple))
                         else key]
            shape = tuple(like.shape)
            blocks[_path_str(path)] = Sharding(
                mesh, sanitize_spec(spec, shape, mesh)).index(shape)
    names = [_path_str(path) for path, _ in _leaves(tree_like)]
    for _ in range(max_retries):
        m1 = read_manifest(ckpt_dir, step)
        sources = _sources(m1["leaves"], names, step)
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        loaded = {}
        ok = True
        for name, idx in dict(sources.values()).items():
            entry = m1["leaves"][name]
            # A stacked leaf is mapped, and only the slices named copied out.
            arr = _load_leaf(os.path.join(d, entry["file"]), entry,
                             mmap=bool(idx) or (mesh is not None
                                                and not verify))
            if verify and "sha1" in entry and (_checksum(_bits(arr))
                                               != entry["sha1"]):
                ok = False          # leaf changed under us (ecnt mismatch)
                break
            loaded[name] = arr
        m2 = read_manifest(ckpt_dir, step)
        if ok and m2["version"] == m1["version"]:
            break                    # CMPTREE matched: consistent snapshot
    else:
        raise RuntimeError("checkpoint kept changing during restore")

    def leaf(name, like):
        src, idx = sources[name]
        block = blocks.get(name)
        if idx:
            have = tuple(loaded[src].shape)
            if (any(i >= n for i, n in zip(idx, have))
                    or have[len(idx):] != tuple(like.shape)):
                raise ValueError(
                    f"checkpoint step {step}: {name!r} is slice {idx} of the "
                    f"stacked {src!r} {list(have)}, which does not hold a "
                    f"{list(like.shape)} leaf there")
            block = idx + (block or ())
        return _tensor(loaded[src], like, dev, block)

    return _rebuild(tree_like, leaf)


def _sources(manifest_leaves: dict, names, step: int) -> dict:
    """Where each leaf ``names`` lists is stored: ``name -> (manifest name,
    leading indices)``.  A leaf of the port's layout (``params/layers/3/
    ...``) that the manifest lacks is read from the reference's stacked
    leaf (``params/layers/...``, slice 3), as ``repro.launch.train``
    writes its state; a leaf under neither name raises ``KeyError``."""
    from repro_torch.models.convert import reference_name

    out = {}
    for name in names:
        if name in manifest_leaves:
            out[name] = (name, ())
            continue
        ref = reference_name(name)
        if ref is None or ref[0] not in manifest_leaves:
            raise KeyError(
                f"checkpoint step {step} has no leaf {name!r}"
                + (f" nor the reference's stacked {ref[0]!r}" if ref else ""))
        out[name] = ref
    return out


class Checkpointer:
    """Async checkpointer: saves on a background thread so the caller
    never blocks on disk, with version counters shared with the
    restore-side validation."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.version = 0
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step: int, tree, blocking: bool = False, *, mesh=None,
             shardings=None):
        """Save ``tree`` (on a background thread unless ``blocking``).
        With ``mesh`` the leaves are this rank's blocks of the tree whose
        :class:`~repro_torch.launch.mesh.Sharding` tree is ``shardings``:
        every rank gathers each leaf whole (collective), rank 0 alone
        writes, and a blocking save ends at a barrier."""
        self.version += 1
        version = self.version
        if mesh is None:
            host_tree = _rebuild(tree, lambda _name, leaf: _host(leaf))
        else:   # one leaf whole at a time, kept on rank 0's host
            from repro_torch.optim.tree import tree_map
            def whole(t, sh):
                t = sh.gather(t)    # collective: every rank
                return _host(t) if mesh.rank == 0 else None
            host_tree = tree_map(whole, tree, shardings)
            if mesh.rank != 0:
                if blocking:
                    mesh.barrier()
                return
        self.wait()

        def work():
            save_checkpoint(self.ckpt_dir, step, host_tree, version=version)
            self._gc()

        if blocking:
            work()
            if mesh is not None:
                mesh.barrier()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self, mesh=None):
        """The pending save is written (with ``mesh``: on every rank, by
        rank 0, a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if mesh is not None:
            mesh.barrier()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_"))
        for s in steps[:-self.keep]:
            d = os.path.join(self.ckpt_dir, f"step_{s:08d}")
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            os.rmdir(d)

    def restore_latest(self, tree_like, mesh=None, specs=None, *,
                       device="cuda"):
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None, None
        tree = restore_checkpoint(self.ckpt_dir, step, tree_like,
                                  device=device, mesh=mesh, specs=specs)
        return step, tree
