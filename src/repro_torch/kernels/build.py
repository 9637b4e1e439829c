"""Build the CUDA sources under ``kernels/csrc`` into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone with
``nvcc`` for ``sm_90a`` into ``kernels/_build/<name>-<hash>.so`` (the
directory is git-ignored), keyed by a hash of the source, the headers and
the flags, so an edited source or header rebuilds and an unchanged one
loads the cached library.  The tensor-core sources share
``csrc/hopper.cuh`` and find ``cuTensorMapEncodeTiled`` in
``libcuda.so.1`` with ``dlopen`` (hence ``-ldl``).  Builds happen at
first use, inside the call that launches a kernel, never at import;
``load_all`` starts one ``nvcc`` per source at once.

Every source exports ``<name>_block_shape(int*)``, which ``bind`` checks
against the wrapper's tiling, and its entry points, which ``bind`` types
from the argument types each wrapper passes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-ldl")

_loaded: dict = {}
_bound: dict = {}
#: One build or bind at a time: the sharded engine's rank threads may all
#: reach a kernel's first launch at once.
_LOCK = threading.RLock()
build_logs: dict = {}  # {name: nvcc output} for the sources built here

_I = ctypes.c_int


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """The cached library's path, keyed by the source, every header under
    ``csrc`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    digest = hashlib.sha256(h.digest() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start compiling ``csrc/<name>.cu`` unless its library is cached:
    ``None``, or ``(process, temporary path)``."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{text}")
    os.replace(tmp, library_path(name))  # atomic: all or nothing
    build_logs[name] = text


def load_all(names) -> None:
    """Build every named source that is not cached, all ``nvcc``s at once."""
    with _LOCK:
        jobs = {name: _start(name) for name in names if name not in _loaded}
        try:
            for name, job in jobs.items():
                _finish(name, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _loaded.get(name)
        if lib is None:
            load_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def bind(name: str, blocks, argtypes) -> ctypes.CDLL:
    """``load(name)`` with its entry points typed, after checking that the
    library's block shape is the wrapper's ``blocks`` (three ints, for the
    semiring products (BM, BN, BK)).  ``argtypes`` maps each entry point
    to its argument types.  Every entry point returns a ``cudaError_t``."""
    lib = _bound.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _bound.get(name)
        if lib is not None:
            return lib
        lib = load(name)
        shape_fn = getattr(lib, f"{name}_block_shape")
        shape_fn.argtypes = [ctypes.POINTER(_I)]
        shape_fn.restype = None
        shape = (_I * 3)()
        shape_fn(shape)
        if tuple(shape) != tuple(blocks):
            raise RuntimeError(f"csrc/{name}.cu blocks {tuple(shape)} != "
                               f"the wrapper's {tuple(blocks)}")
        for entry, types in argtypes.items():
            fn = getattr(lib, entry)
            fn.argtypes = types
            fn.restype = _I
        _bound[name] = lib
        return lib
