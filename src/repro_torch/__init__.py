"""PyTorch/CUDA port of the PANIGRAHAM graph engine (``repro``).

The package mirrors ``repro``'s layout so each module has an obvious
counterpart:

  * :mod:`repro_torch.core` -- the versioned graph state, batched updates,
    the COO and batched-dense queries, the tile view, the semiring layer
    and the snapshot protocol (PG-Cn / PG-Icn collects);
  * :mod:`repro_torch.kernels` -- the hand-written Hopper kernels (CUDA C++
    under ``kernels/csrc``), their padded wrappers and plain versions;
  * :mod:`repro_torch.engine` -- the version ring, the update scheduler,
    the unchanged -> delta -> full query ladder and ``GraphService``;
  * :mod:`repro_torch.obs`, :mod:`repro_torch.resil`,
    :mod:`repro_torch.checkpoint`, :mod:`repro_torch.runtime` -- the
    service's options: telemetry and adaptive thresholds, fault injection,
    the degrade ladder and circuit breaker, the op journal with snapshot
    compaction and recovery, the heartbeat monitor;
  * :mod:`repro_torch.data` -- the R-MAT generator;
  * :mod:`repro_torch.bench` -- the paper's Section 5 workload runner.

Every constructor takes ``device=`` and defaults to ``"cuda"``; on a
machine without CUDA a call that does not ask for the CPU raises.  The
package imports torch, numpy and the standard library only.
"""
