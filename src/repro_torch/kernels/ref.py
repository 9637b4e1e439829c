"""Plain PyTorch oracles for the kernels (the correctness ground truth;
port of ``repro.kernels.ref``).  Float32 products here run in full
float32: the callers that compare against them turn TF32 off."""
from __future__ import annotations

import math

import torch

# The reference kernel's default kv block (repro.kernels.ops.flash_attention
# bk=128): its non-causal offset is the kv length padded to that block.
FLASH_REF_BK = 128


def bool_mm_ref(f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Boolean-semiring matmul on {0,1} f32 masks: out = (f @ a) > 0."""
    return (f.float() @ a.float() > 0).float()


def minplus_mm_ref(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Tropical matmul: out[s, j] = min_k d[s, k] + w[k, j].

    Broadcasts the whole ``S x K x N`` sum: small shapes only (the kernel
    module's ``minplus_mm_plain`` works k-step by k-step)."""
    return torch.amin(d[:, :, None] + w[None, :, :], dim=1)


def count_mm_ref(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Counting matmul (Brandes sigma): plain f32 product of path counts."""
    return s.float() @ a.float()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_offset(sq: int, skv: int, causal: bool) -> int:
    """The causal offset of the flash kernel: query i sees key j iff
    ``j <= i + offs``.  Causal: ``skv - sq`` (the ends aligned).  Not
    causal: the kv length padded as the reference pads it
    (``repro/kernels/flash_attention.py:105-117``), which only a window
    can tell from "every key"."""
    if causal:
        return skv - sq
    return _round_up(skv, min(FLASH_REF_BK, _round_up(skv, 8)))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, sm_scale: float | None = None,
                        window: int | None = None,
                        chunk: int = 512) -> torch.Tensor:
    """The flash kernel's function in plain PyTorch.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] with Hq % Hkv == 0 -> [B, Hq,
    Sq, D] in q's dtype.  Query i sees key j iff ``j <= i + offs`` (see
    ``flash_offset``) and, with a window, ``j > i + offs - window``.  Computes
    in float32; a row that sees no key is 0, as the kernel's guards make it
    (the reference's oracle, which has no guard, gives NaN there).  GQA by
    broadcasting each kv head over its group of query heads, and chunked
    over the queries, ``chunk`` rows at a time, so the [chunk, Skv] scores
    of every head fit at a model's prefill shape.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else float(d) ** -0.5
    offs = flash_offset(sq, skv, causal)
    kt = k.float().transpose(-1, -2)[:, :, None]      # [B, Hkv, 1, D, Skv]
    vf = v.float()[:, :, None]                        # [B, Hkv, 1, Skv, D]
    kpos = torch.arange(skv, device=q.device)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    for s0 in range(0, sq, chunk):
        n = min(chunk, sq - s0)
        qc = q[:, :, s0:s0 + n].float().reshape(b, hkv, group, n, d)
        s = (qc @ kt) * scale                         # [B, Hkv, G, n, Skv]
        qpos = torch.arange(s0, s0 + n, device=q.device)[:, None]
        vis = kpos[None, :] <= qpos + offs
        if window is not None:
            vis &= kpos[None, :] > qpos + offs - window
        s = s.masked_fill(~vis, -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(m == -math.inf, 0.0, torch.exp(s - m))
        l = p.sum(dim=-1, keepdim=True)
        o = (p @ vf) / torch.where(l == 0.0, 1.0, l)
        out[:, :, s0:s0 + n] = o.reshape(b, hq, n, d).to(q.dtype)
    return out
