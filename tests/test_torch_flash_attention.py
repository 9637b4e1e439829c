"""The port's flash attention against the reference's Pallas kernel.

On the CPU ``repro_torch.kernels.ops.flash_attention`` runs its kernel's
plain version; the reference's kernel runs in interpret mode.  The sweeps of
``tests/test_kernels.py`` (causal MHA/GQA/MQA, ragged lengths, one-query
decode, non-causal, a window, bf16) plus head_dim 64 and 128 and the
ragged, windowed, non-causal corners the port's kernel masks itself.
Tolerances: 3e-5 for f32 (summation order), 3e-2 for bf16 (outputs
rounded to bf16 on both sides from slightly different f32 values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import flash_attention_ref, flash_offset

SWEEP = [
    (1, 4, 4, 32, 32, 16),     # MHA square
    (2, 4, 2, 37, 53, 16),     # GQA ragged
    (1, 8, 1, 16, 64, 32),     # MQA decode-ish (ends aligned)
    (2, 2, 2, 1, 40, 16),      # single-query decode
    (1, 4, 2, 70, 130, 64),    # head_dim 64 (granite), past one 64-row tile
    (1, 4, 1, 65, 65, 128),    # head_dim 128 (mistral), one ragged row
    (1, 2, 2, 40, 16, 32),     # more queries than keys: rows that see none
]


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _both(q, k, v, **kw):
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    exp = jops.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    return got.numpy(), np.asarray(exp)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", SWEEP)
def test_causal_matches_pallas(b, hq, hkv, sq, skv, d):
    got, exp = _both(*_qkv(sq * skv + d, b, hq, hkv, sq, skv, d))
    assert got.shape == (b, hq, sq, d)
    assert np.max(np.abs(got - exp)) < 3e-5


@pytest.mark.parametrize("sq,skv,window", [(24, 40, None), (100, 100, 20),
                                           (30, 200, 50)])
def test_noncausal_matches_pallas(sq, skv, window):
    got, exp = _both(*_qkv(sq + skv, 1, 2, 2, sq, skv, 16), causal=False,
                     window=window)
    assert np.max(np.abs(got - exp)) < 3e-5


@pytest.mark.parametrize("sq,skv,window,d", [(48, 48, 8, 16),
                                             (90, 150, 33, 64),
                                             (1, 70, 16, 32)])
def test_window_matches_pallas(sq, skv, window, d):
    got, exp = _both(*_qkv(window, 1, 4, 2, sq, skv, d), window=window)
    assert np.max(np.abs(got - exp)) < 3e-5


def test_window_matches_numpy_oracle():
    q, k, v = _qkv(1, 1, 2, 2, 48, 48, 16)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), window=8)
    lg = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(16)
    i, j = np.arange(48)[:, None], np.arange(48)[None, :]
    lg = np.where(((j <= i) & (j > i - 8))[None, None], lg, -np.inf)
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    exp = np.einsum("bhqk,bhkd->bhqd", p, v)
    assert np.max(np.abs(got.numpy() - exp)) < 3e-5


@pytest.mark.parametrize("d", [16, 64])
def test_bf16_matches_pallas(d):
    q, k, v = _qkv(d, 1, 2, 2, 32, 32, d)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    got = tops.flash_attention(*tb)
    exp = jops.flash_attention(*jb)
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(got.float().numpy()
                         - np.asarray(exp, np.float32))) < 3e-2


def test_strided_cache_prefix_and_query_view():
    """The wrapper takes a slice of a cache and a transposed query as they
    are (the kernel reads them through their strides)."""
    rng = np.random.default_rng(4)
    cache = torch.from_numpy(rng.standard_normal((2, 2, 50, 32))
                             .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 20, 4, 32))
                         .astype(np.float32)).transpose(1, 2)
    k = cache[:, :, :28]
    got = tops.flash_attention(q, k, k)
    exp = jops.flash_attention(*(jnp.asarray(x.contiguous().numpy())
                                 for x in (q, k, k)))
    assert np.max(np.abs(got.numpy() - np.asarray(exp))) < 3e-5


def test_plain_version_chunks_agree():
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 4, 2, 70, 90, 32))
    whole = flash_attention_ref(q, k, v, window=30, chunk=512)
    chunked = flash_attention_ref(q, k, v, window=30, chunk=16)
    assert torch.equal(whole, chunked)


def test_offsets():
    assert flash_offset(20, 28, True) == 8
    assert flash_offset(24, 40, False) == 40      # padded to 40 (bk 40)
    assert flash_offset(100, 100, False) == 104   # padded to a multiple of 8
    assert flash_offset(30, 200, False) == 256    # padded to bk 128


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "gqa", "window",
                                 "device"])
def test_wrapper_refuses(bad):
    q = torch.zeros((1, 4, 8, 32))
    k = torch.zeros((1, 2, 8, 32))
    kw = {}
    if bad == "head_dim":
        q, k = torch.zeros((1, 4, 8, 48)), torch.zeros((1, 2, 8, 48))
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "gqa":
        k = torch.zeros((1, 3, 8, 32))
    elif bad == "window":
        kw = {"window": 0}
    elif bad == "device":
        k = k.to("meta")
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, k, **kw)
    assert tflash.LAUNCHES["flash_attention"] == 0  # the CPU never launches
