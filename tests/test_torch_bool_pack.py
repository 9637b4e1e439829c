"""The boolean product's int8 formulation, on the CPU.

On the card ``bool_mm`` packs both operands to int8 (``x != 0``; the right
operand transposed to ``[N, K]``, since 8-bit ``wgmma`` reads both operands
K-major) and sums the products exactly in s32 before the ``> 0``
threshold.  Here the packs' plain versions are held to their definition,
and the integer formulation on the packed operands
(``bool_mm_packed_plain``) to ``bool_mm_ref``, to the port's ``ops`` and to
the reference's Pallas kernel in interpret mode, over the sweeps of
``tests/test_torch_bool_minplus.py``.  The CUDA packs and kernel are held
to these plain versions by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.kernels.ops as jops
import repro_torch.kernels.bool_mm as tbool
import repro_torch.kernels.ops as tops

from test_kernels import _sparse_tiled, _tile_occ
from test_torch_bool_minplus import BOOL_SHAPES, MASKED


def _j(fn, *xs, **kw):
    return np.asarray(fn(*(jnp.asarray(x) for x in xs), **kw))


def _packed_product(f: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Pad as ``ops`` does, pack both operands, multiply in int32,
    threshold, and slice the padding back off."""
    fp, (m, _) = tops._pad2(torch.tensor(f), tbool.BM, tbool.BK)
    ap, (_, n) = tops._pad2(torch.tensor(a), tbool.BK, tbool.BN)
    out = tbool.bool_mm_packed_plain(tbool.pack_left(fp), tbool.pack_right(ap))
    return out[:m, :n].numpy()


def test_pack_plain_versions_are_exact():
    """``pack_left`` is ``x != 0`` as int8 in place; ``pack_right`` is
    ``(a != 0).T`` as int8, contiguous ``[N, K]``; values other than 0 and
    1 pack as nonzero, -0.0 as zero."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 90)).astype(np.float32)
    x[np.abs(x) < 0.7] = 0.0
    x[0, :5] = -0.0
    xt = torch.tensor(x)
    left, right = tbool.pack_left(xt), tbool.pack_right(xt)
    assert left.dtype == right.dtype == torch.int8
    assert left.shape == (37, 90) and left.is_contiguous()
    assert right.shape == (90, 37) and right.is_contiguous()
    assert np.array_equal(left.numpy(), (x != 0).astype(np.int8))
    assert np.array_equal(right.numpy(), (x != 0).T.astype(np.int8))
    assert not left[0, :5].any()
    assert torch.equal(left, tbool.pack_left_plain(xt))
    assert torch.equal(right, tbool.pack_right_plain(xt))


@pytest.mark.parametrize("k,n", [(200, 130), (128, 128), (1, 64),
                                 (300, 257)])
def test_pack_right_after_ops_padding(k, n):
    """K and N off the block shape, padded with zeros as ``ops`` does:
    the pack is ``[Np, Kp]``, contiguous, its real part ``(a != 0).T`` and
    its padding zero."""
    rng = np.random.default_rng(k + n)
    a = (rng.random((k, n)) < 0.2).astype(np.float32)
    ap, _ = tops._pad2(torch.tensor(a), tbool.BK, tbool.BN)
    kp, np_ = ap.shape
    assert kp % tbool.BK == 0 and np_ % tbool.BN == 0
    packed = tbool.pack_right(ap)
    assert packed.shape == (np_, kp) and packed.is_contiguous()
    assert np.array_equal(packed[:n, :k].numpy(), a.T.astype(np.int8))
    assert not packed[n:].any() and not packed[:, k:].any()
    prepared = tops._bool_packed(ap)
    assert prepared == {}  # a CPU operand takes the plain path: no pack


@pytest.mark.parametrize("s,k,n", BOOL_SHAPES)
def test_int8_formulation_equals_reference(s, k, n):
    rng = np.random.default_rng(s * 5 + n)
    f = (rng.random((s, k)) < 0.15).astype(np.float32)
    a = (rng.random((k, n)) < 0.08).astype(np.float32)
    got = _packed_product(f, a)
    assert got.shape == (s, n) and got.dtype == np.float32
    assert np.array_equal(got, tbool.bool_mm_ref(torch.tensor(f),
                                                 torch.tensor(a)).numpy())
    assert np.array_equal(got, _j(jops.bool_mm, f, a))
    assert np.array_equal(got, tops.bool_mm(torch.tensor(f),
                                            torch.tensor(a)).numpy())


@pytest.mark.parametrize("s,k,n,tile,density", MASKED)
def test_int8_formulation_equals_reference_on_tiled_operands(s, k, n, tile,
                                                              density):
    """The masked sweeps' operands (tiles of edges, empty and full
    occupancies): the dense integer formulation equals the reference's
    masked Pallas kernel."""
    rng = np.random.default_rng(hash((s, k, n, tile)) % 2**32)
    a = _sparse_tiled(k, n, tile, density, identity_inf=False, rng=rng)
    f = (rng.random((s, k)) < 0.15).astype(np.float32)
    amask = _tile_occ(a, tile, identity_inf=False)
    got = _packed_product(f, a)
    assert np.array_equal(got, _j(jops.bool_mm, f, a, amask=amask,
                                  tile=tile))
    assert np.array_equal(got, ((f @ a) > 0).astype(np.float32))


def test_int8_formulation_counts_past_int8():
    """A row of all ones across K = 16384 against a column of all ones
    counts 16384: int8 sums wrap it to 0 (16384 = 64 x 256), int32 sums
    keep it.  The formulation equals the reference's kernel there."""
    k, n = 16384, 128
    f = np.zeros((3, k), np.float32)
    f[0] = 1.0
    f[1, 77] = 1.0
    a = np.zeros((k, n), np.float32)
    a[:, 0] = 1.0
    a[77, 5] = 1.0
    fp, ap = tbool.pack_left(torch.tensor(f)), tbool.pack_right(
        torch.tensor(a))
    counts = fp.to(torch.int32) @ ap.to(torch.int32).t()
    assert int(counts[0, 0]) == k
    wrapped = (fp.to(torch.int64) @ ap.to(torch.int64).t()).to(torch.int8)
    assert int(wrapped[0, 0]) == 0  # what an int8 accumulator would hold
    got = tbool.bool_mm_packed_plain(fp, ap).numpy()
    exp = ((f @ a) > 0).astype(np.float32)
    assert got[0, 0] == 1.0 and got[1, 0] == 1.0 and got[1, 5] == 1.0
    assert np.array_equal(got, exp)
    assert np.array_equal(got, _j(jops.bool_mm, f, a))


def test_mask_coarsening_is_a_copy_at_the_kernel_blocks():
    """With BK = BN = 128 the kernel's k-blocks and column blocks are the
    tile view's 128-tiles: coarsening the occupancy is an exact copy."""
    assert tbool.BK == tbool.BN == 128
    rng = np.random.default_rng(9)
    occ = torch.tensor((rng.random((6, 4)) < 0.4).astype(np.int32))
    got = tops._coarsen_mask(occ, 128, tbool.BK, 6, tbool.BN, 4)
    assert torch.equal(got, occ)
