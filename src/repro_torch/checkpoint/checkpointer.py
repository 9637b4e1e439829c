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
device the caller names, ``"cuda"`` by default.  The reference's
``mesh=``/``specs=`` resharding onto a graph mesh is not ported yet
(ROADMAP.md, queue 1, item 2).
"""
from __future__ import annotations

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


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _numpy_dtype(like) -> np.dtype:
    if isinstance(like, torch.Tensor):
        return torch.empty(0, dtype=like.dtype).numpy().dtype
    return np.dtype(like.dtype)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def like_from_manifest(cls, manifest: dict):
    """A ``NamedTuple`` ``cls`` of shape/dtype-only (``meta``) tensors read
    from a manifest's leaves: the skeleton :func:`restore_checkpoint`
    needs when only the snapshot knows the capacities."""
    def like(name):
        entry = manifest["leaves"][name]
        dtype = torch.from_numpy(np.empty(0, entry["dtype"])).dtype
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
        np.save(os.path.join(d, fn), arr)
        entry = {"file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        if verify:
            entry["sha1"] = _checksum(arr)
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
    raises without CUDA).  ``mesh``/``specs`` are not ported yet.
    """
    from repro_torch.core.graph_state import resolve_device

    if mesh is not None or specs is not None:
        raise NotImplementedError(
            "restore_checkpoint(mesh=, specs=) is not ported yet "
            "(ROADMAP.md, queue 1, item 2)")
    dev = resolve_device(device)
    for _ in range(max_retries):
        m1 = read_manifest(ckpt_dir, step)
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        loaded = {}
        ok = True
        for name, entry in m1["leaves"].items():
            arr = np.load(os.path.join(d, entry["file"]))
            if verify and "sha1" in entry and _checksum(arr) != entry["sha1"]:
                ok = False          # leaf changed under us (ecnt mismatch)
                break
            loaded[name] = arr
        m2 = read_manifest(ckpt_dir, step)
        if ok and m2["version"] == m1["version"]:
            break                    # CMPTREE matched: consistent snapshot
    else:
        raise RuntimeError("checkpoint kept changing during restore")

    return _rebuild(tree_like, lambda name, like: torch.tensor(
        loaded[name].astype(_numpy_dtype(like)), device=dev))


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

    def save(self, step: int, tree, blocking: bool = False):
        self.version += 1
        version = self.version
        host_tree = _rebuild(tree, lambda _name, leaf: _host(leaf))
        self.wait()

        def work():
            save_checkpoint(self.ckpt_dir, step, host_tree, version=version)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
