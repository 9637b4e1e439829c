"""Isolation guards for the port: it imports neither JAX nor the reference
package nor anything under ``benchmarks/``, and without CUDA it refuses to build state anywhere but where the
caller asked."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_IMPORT_ALL = r"""
import importlib, os, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bench = os.sep + "benchmarks" + os.sep
bad = sorted(m for m, mod in sys.modules.items()
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro.")
             or bench in (getattr(mod, "__file__", None) or ""))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    count, bad = r.stdout.strip().split(" ", 1)
    assert int(count) >= 60, r.stdout  # every module of the package
    assert bad == "[]", r.stdout


@pytest.mark.parametrize("ctor", ["make_graph", "from_edge_list",
                                  "load_rmat_graph"])
def test_constructors_default_to_cuda_and_refuse_without_it(ctor):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device works")
    from repro_torch.core import from_edge_list, make_graph
    from repro_torch.data import load_rmat_graph
    call = {
        "make_graph": lambda **kw: make_graph(8, 16, **kw),
        "from_edge_list": lambda **kw: from_edge_list(
            8, 16, np.array([0, 1]), np.array([1, 2]), **kw),
        "load_rmat_graph": lambda **kw: load_rmat_graph(16, 40, **kw),
    }[ctor]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(device="cuda")
    state = call(device="cpu")
    assert state.alive.device.type == "cpu"
