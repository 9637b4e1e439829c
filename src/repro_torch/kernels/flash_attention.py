"""Causal GQA flash attention: Hopper kernel + plain version.

Port of ``repro.kernels.flash_attention``.  ``flash_attention`` takes q
[B, Hq, Sq, D] and k, v [B, Hkv, Skv, D] (Hq a multiple of Hkv, D one of
``HEAD_DIMS``, all float32 or all bfloat16) and returns [B, Hq, Sq, D] in
q's dtype.  A CUDA tensor launches the hand-written kernel in
``csrc/flash_attention.cu`` (built with nvcc at first use, bound with
ctypes): bf16 its wgmma body, f32 its SIMT body.  It reads q, k and v
through their batch, head and row strides, so a slice of a KV cache is read
in place, and it masks the ragged edges itself.  The bf16 body loads by
TMA, which takes a base address and strides that are multiples of 16
bytes; ``tma_strides`` refuses the rest.  A CPU tensor runs the plain
version, ``ref.flash_attention_ref``.
There is no fallback from one to the other.  The kernel has no backward:
on CUDA, a call that autograd would have to differentiate (grad mode on
and q, k or v requiring grad) raises instead of returning a result cut off
from the graph; training runs the chunked attention (``attn_impl="xla"``).

``LAUNCHES`` counts kernel launches; only a launch adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .backend import count_launch, launch, on_cuda
from .ref import flash_attention_ref, flash_offset

# The f32 body's tiling (csrc/flash_attention.cu; checked against the
# library's own flash_attention_block_shape when it loads).
BQ, BK, THREADS = 64, 64, 256
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention": 0}

# flash_attention(q, k, v, out, dtype, b, hq, hkv, sq, skv, d, nine strides,
# offs, window, scale, stream): pointers and the stream as void*, so ctypes
# passes them whole rather than cut to 32-bit ints.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = {"flash_attention": [_P, _P, _P, _P, *[_I] * 7, *[_L] * 9, _I,
                                _I, ctypes.c_float, _P]}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _lib():
    return build.bind("flash_attention", (BQ, BK, THREADS), ARGTYPES)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window) -> None:
    """Refuse what the kernel does not take, on either device."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D]"
                         f", got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)} (batch, head_dim, or Hq not "
                         f"a multiple of Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError("flash_attention: empty query or key sequence")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")


def split_p(p: torch.Tensor):
    """The bf16 body's two-term split of the probabilities (f32): ``p_hi``
    = p truncated to bf16, ``p_lo`` = bf16(p - p_hi), so that ``p_hi +
    p_lo`` is within 2^-15 of p relative (one bf16 rounding: 2^-9).  Both
    go through the P V product; the plain twin of the kernel's split."""
    p = p.float()
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    return hi.bfloat16(), (p - hi).bfloat16()


def tma_strides(x: torch.Tensor) -> tuple:
    """The batch, head and row strides (elements) of a bf16 operand as the
    kernel's TMA maps take them.  Raises unless the base address and every
    stride of a dimension longer than 1 are multiples of 16 bytes; a
    dimension of length 1 is never stepped, so its stride is replaced by one
    that is (the span of the whole tensor)."""
    size = x.element_size()
    span = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    span = -(-span * size // 16) * 16 // size
    strides = tuple(st if n > 1 else span
                    for n, st in zip(x.shape[:3], x.stride()[:3]))
    if x.data_ptr() % 16 or any(st * size % 16 for st in strides):
        raise ValueError(
            f"flash_attention: the bf16 kernel loads by TMA, which needs a "
            f"16-byte aligned base and strides; got base {x.data_ptr() % 16} "
            f"bytes off, strides {tuple(x.stride())} ({size}-byte elements)")
    return strides


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a contiguous last dimension (the kernel's one layout
    demand); any batch, head and row strides are fine."""
    return x if x.stride(-1) == 1 else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    Query i sees key j iff ``j <= i + (Skv - Sq)`` (the ends aligned) and,
    with ``window``, ``j > i + (Skv - Sq) - window``; ``causal=False`` lifts
    the first condition (see ``ref.flash_offset``).  The softmax scale is
    ``D ** -0.5`` unless ``sm_scale`` is given."""
    check_inputs(q, k, v, window)
    if not on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                   window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward, and q, k or v "
            "requires grad; training runs attn_impl=\"xla\" (the chunked "
            "attention), or call the kernel under torch.no_grad()")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else float(d) ** -0.5
    q, k, v = _rows(q), _rows(k), _rows(v)
    strides = (tma_strides if q.dtype == torch.bfloat16
               else lambda x: x.stride()[:3])
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    launch("flash_attention", _lib().flash_attention, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b, hq,
           hkv, sq, skv, d, *strides(q), *strides(k), *strides(v),
           flash_offset(sq, skv, causal), window or 0, scale)
    count_launch(LAUNCHES, "flash_attention")
    return out
