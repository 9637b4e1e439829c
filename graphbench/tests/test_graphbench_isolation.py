"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""
import ast
import os

import gb_tiny

BENCH = os.path.join(gb_tiny.ROOT, "graphbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE_MAY = {"numpy", "torch", "math", "__future__"}


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imports(path):
    """(top-level name, relative level) of every import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_walks_every_module():
    assert len(list(_modules())) >= 20


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(path, name) for path in _modules()
           for name, level in _imports(path)
           if level == 0 and name in FORBIDDEN]
    assert bad == []


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        for top, level in _imports(os.path.join(ref, name)):
            # only numpy, torch and its own package, never the harness
            # (which reaches the program) nor the program itself
            assert level <= 1, (name, top)
            if level == 0:
                assert top in REFERENCE_MAY, (name, top)


def test_guard_compares_whole_names():
    from graphbench import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax", "flax.linen",
                                      "jaxlib"]) == ["flax.linen", "jax",
                                                     "jaxlib", "repro.core"]
