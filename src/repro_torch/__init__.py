"""PyTorch/CUDA port of the PANIGRAHAM graph engine (``repro``).

The package mirrors ``repro``'s layout so each module has an obvious
counterpart:

  * :mod:`repro_torch.core` -- the versioned graph state, batched updates,
    the COO and batched-dense queries, the tile view and the semiring layer;
  * :mod:`repro_torch.kernels` -- the hand-written Hopper kernels (CUDA C++
    under ``kernels/csrc``), their padded wrappers and plain versions;
  * :mod:`repro_torch.engine` -- the version ring, the update scheduler,
    the unchanged -> delta -> full query ladder and ``GraphService``;
  * :mod:`repro_torch.data` -- the R-MAT generator.

Every constructor takes ``device=`` and defaults to ``"cuda"``; on a
machine without CUDA a call that does not ask for the CPU raises.  The
package imports torch, numpy and the standard library only.
"""
