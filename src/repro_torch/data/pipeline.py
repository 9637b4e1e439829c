"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Batches are a pure function of (seed, step), so a restarted trainer resumes
on exactly the data it would have seen: checkpoint and restart never
replay or skip tokens.  ``SyntheticTokens`` is the reference's numpy code,
copied, so both packages draw the same tokens; ``shard_batch`` puts a batch
on one device, or this process's rows of it on a mesh (training's or
serving's layout).
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


class LocalBatch(dict):
    """This process's rows of a batch on a mesh; ``shardings`` holds each
    entry's :class:`~repro_torch.launch.mesh.Sharding` (which rows)."""

    def __init__(self, tensors: dict, shardings: dict):
        super().__init__(tensors)
        self.shardings = shardings


def shard_batch(batch: dict, mesh=None, device="cuda", full_batch=True):
    """A host batch as tensors on ``device`` (default ``"cuda"``, which
    raises without CUDA).  With ``mesh`` (a mesh of processes), this
    process's rows only, in a :class:`LocalBatch` on the mesh's device:
    as training lays the batch out (``full_batch=True``,
    ``batch_shardings(full_batch=True)``: over every axis that divides it)
    or, with ``full_batch=False``, as serving does (over the data axes
    only: the ``model`` ranks of a data row hold the same rows).  M-RoPE
    ``positions`` keep their batch on axis 1."""
    if mesh is None:
        dev = resolve_device(device)
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in batch.items()}
    from repro_torch.launch.mesh import batch_shardings

    arrays = {k: np.asarray(v) for k, v in batch.items()}
    sh = batch_shardings(arrays, mesh, full_batch=full_batch)
    return LocalBatch({k: torch.from_numpy(np.ascontiguousarray(
        sh[k].local(v))).to(mesh.device) for k, v in arrays.items()}, sh)
