"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Batches are a pure function of (seed, step), so a restarted trainer resumes
on exactly the data it would have seen: checkpoint and restart never
replay or skip tokens.  ``SyntheticTokens`` is the reference's numpy code,
copied, so both packages draw the same tokens; ``shard_batch`` puts a batch
on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.graph_state import resolve_device


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Zipfian token distribution: more realistic logit/loss dynamics than
    # uniform (and exercises the chunked-xent gather path unevenly).
    zipf_a: float = 1.3

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        z = rng.zipf(self.zipf_a, size=(self.global_batch, self.seq_len + 1))
        tokens = (z % (self.vocab_size - 1)).astype(np.int32) + 1
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def shard_batch(batch: dict, mesh=None, device="cuda") -> dict:
    """A host batch as tensors on ``device`` (default ``"cuda"``, which
    raises without CUDA).  Placing it on a mesh waits for LM sharding."""
    if mesh is not None:
        raise NotImplementedError(
            "shard_batch(mesh=...): placing a batch on a mesh waits for LM "
            "sharding (ROADMAP.md, queue 1, slice 4)")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}
