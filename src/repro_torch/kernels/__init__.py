"""Hand-written Hopper kernels for the port's hot path.

  * ``count_mm`` / ``count_mm_masked`` -- counting-semiring product
    (batched Brandes sigma and dependency flow), CUDA C++ in
    ``csrc/count_mm.cu``; ``count_mm.py`` holds the ctypes wrapper, the
    launch counters and the plain PyTorch version side by side.

``ops.py`` holds the padding wrappers, ``ref.py`` the plain oracles,
``backend.py`` the device dispatch and shape guards, ``build.py`` the nvcc
build.  The reference's other Pallas kernels (``bool_mm``, ``minplus_mm``,
``flash_attention``) are not ported yet (ROADMAP.md, queue 2).
"""
from . import ops, ref  # noqa: F401
