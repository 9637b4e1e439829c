"""Hand-written Hopper kernels for the port's hot path.

  * ``bool_mm`` / ``bool_mm_masked`` -- boolean-semiring product (BFS
    frontier expansion, ``bfs_batched_dense``), an int8 tensor-core
    product on operands packed to one byte per entry, CUDA C++ in
    ``csrc/bool_mm.cu``;
  * ``minplus_mm`` / ``minplus_mm_masked`` -- tropical product (SSSP
    relaxation, ``sssp_batched_dense``), CUDA C++ in ``csrc/minplus_mm.cu``;
  * ``count_mm`` / ``count_mm_masked`` -- counting-semiring product
    (batched Brandes sigma and dependency flow), CUDA C++ in
    ``csrc/count_mm.cu``;
  * ``flash_attention`` -- causal GQA attention with an online softmax
    (the LM's prefill, ``repro_torch.models.layers.attention``), CUDA C++
    in ``csrc/flash_attention.cu``.

Each ``<name>.py`` holds the ctypes wrapper, the launch counters and the
plain PyTorch version side by side.  ``ops.py`` holds the padding
wrappers, ``ref.py`` the plain oracles, ``backend.py`` the device dispatch,
shape guards and shared helpers, ``build.py`` the nvcc build.  Every
Pallas kernel of the reference has its Hopper kernel here.
"""
from . import ops, ref  # noqa: F401
