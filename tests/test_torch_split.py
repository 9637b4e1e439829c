"""The arithmetic the tensor-core kernels mirror, on the CPU.

``count_mm``'s kernel computes an f32 product exactly on bf16 tensor cores
by the truncation split x = hi + mid + lo (``count_mm.split3``, the plain
twin of the kernel's left-operand split) of the left operand and of the
right one (``count_mm.right_planes``: one plane when it is exact in bf16),
summing the products of the terms i + j <= 2 in f32
(``split_product`` below).  ``flash_attention``'s bf16 body splits
the probabilities into two bf16 terms (``flash_attention.split_p``).  These
tests hold those helpers to the contracts the kernels rest on: pieces exact
in bf16 with the sign of x, sums exact, counts bit-exact up to 2^24 - 1,
floats within the count product's tolerance, P within 2^-15.  The reference
(``repro.kernels.ops.count_mm``, the Pallas kernel in interpret mode) gives
the same products on the same numpy inputs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.kernels.ops as jops
import repro_torch.kernels.count_mm as tcount
import repro_torch.kernels.flash_attention as tflash
import repro_torch.kernels.ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _values(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "normals":
        x = rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
        return x.astype(np.float32)
    if kind == "integers":
        return np.concatenate([np.arange(4096), rng.integers(0, 2**24, 4096),
                               [2**24 - 1, 2**24 - 2, 2**23 + 1]]
                              ).astype(np.float32)
    if kind == "zeros":
        return np.array([0.0, -0.0], np.float32)
    if kind == "tiny normals":  # down to 2^-110, where lo is still exact
        return (rng.random(2048) + 1).astype(np.float32) * np.float32(
            2.0) ** rng.integers(-110, -100, 2048).astype(np.float32)
    if kind == "negatives":
        return -_values("normals")
    raise ValueError(kind)


def split_product(s, planes, acc=torch.float32):
    """The count kernel's arithmetic in plain PyTorch: the sum over the
    terms i + j <= 2 of ``split3(s)[i] @ planes[j].T``, each term a product
    of bf16 values summed in ``acc`` (f32, the kernel's accumulator; f64
    gives the exact value of the kept terms), returned as f32."""
    out = torch.zeros((s.shape[0], planes.shape[1]), dtype=acc)
    for i, x in enumerate(tcount.split3(s)):
        for j in range(planes.shape[0]):
            if i + j <= 2:
                out += x.to(acc) @ planes[j].to(acc).t()
    return out.float()


def _pieces(x):
    return [p.float().numpy() for p in tcount.split3(torch.tensor(x))]


@pytest.mark.parametrize("kind", ["normals", "integers", "zeros",
                                  "tiny normals", "negatives"])
def test_split3_pieces_are_exact_bf16_and_sum_to_x(kind):
    x = _values(kind)
    hi, mid, lo = _pieces(x)
    for piece in (hi, mid, lo):
        # a bf16 value: the low 16 bits of its f32 pattern are zero
        assert not (piece.view(np.uint32) & 0xFFFF).any()
        # the sign of x, or zero
        assert ((piece == 0) | (np.sign(piece) == np.sign(x))).all()
    assert np.array_equal((hi + mid) + lo, x)
    # hi is the truncation of x, mid of the remainder
    assert np.array_equal(hi, _f32(x.view(np.uint32) & 0xFFFF0000))
    assert (np.abs(mid) <= np.abs(x - hi)).all()


def test_split3_of_integers_is_nonnegative_integers():
    x = _values("integers")
    for piece in _pieces(x):
        assert (piece >= 0).all() and (piece == np.floor(piece)).all()
    hi, mid, lo = _pieces(np.array([2**24 - 1], np.float32))
    assert (hi[0], mid[0], lo[0]) == (16711680.0, 65280.0, 255.0)


def test_split3_of_subnormals():
    """f32 subnormals on bf16's grid (multiples of 2^-133) split exactly;
    the others keep every bit down to 2^-133, the least bf16 subnormal."""
    on_grid = _f32(np.arange(1, 128, dtype=np.uint32) << 16)
    hi, mid, lo = _pieces(on_grid)
    assert np.array_equal(hi, on_grid) and not mid.any() and not lo.any()
    off_grid = _f32(np.arange(1, 2**23, 4099, dtype=np.uint32))
    hi, mid, lo = _pieces(off_grid)
    err = np.abs((hi.astype(np.float64) + mid + lo) - off_grid)
    assert (err <= 2.0 ** -134).all()
    assert ((hi + mid + lo) * np.sign(off_grid) >= 0).all()


def _slab_any(x):
    """int32 [m / 128, k / 64]: 1 where the (128 x 64) slab of ``x`` has a
    nonzero entry (the kernel's slab grid)."""
    return tops._slab_mask(x, tcount.BM, tcount.BK, lambda t: t != 0)


def _operand(kind):
    """A [256, 320] operand (2 x 5 slabs) of ``kind``'s values, scattered
    with zeros, with one slab of +0 and one of -0 alone."""
    rng = np.random.default_rng(len(kind) + 1)
    if kind == "subnormals":   # on bf16's grid and off it, both signs
        vals = _f32(rng.integers(1, 2**23, 4096, dtype=np.uint32))
        vals[::3] = _f32(rng.integers(1, 128, 1366, dtype=np.uint32) << 16)
        vals[1::2] *= -1
    elif kind == "floats":
        vals = np.concatenate([_values("normals"), _values("negatives"),
                               _values("tiny normals")])
    else:
        vals = _values(kind)
    x = rng.choice(vals, (256, 320)).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0.0
    x[:128, 64:128] = 0.0
    x[128:, 192:256] = -0.0
    x[:128, 256:] = 0.0
    x[5, 300] = vals[vals != 0][0] if vals.any() else 0.0  # a lone entry
    return torch.tensor(x)


@pytest.mark.parametrize("kind", ["integers", "floats", "zeros",
                                  "subnormals"])
def test_split_flags_are_the_slab_mask_and_the_pieces(kind):
    """``split_flags``, the plain twin of the split kernel's per-slab
    flags: the third is ``ops._slab_mask(x, 128, 64, _nonzero)`` (-0 is no
    entry), the first and second say which slabs have a nonzero mid and
    lo piece.  The kernel reads them off the f32 remainders, so below
    bf16's least subnormal they may also be set for a piece that is zero
    (a mid of -0, a lo that rounds to zero): never clear where a piece is
    not."""
    x = _operand(kind)
    flags = tcount.split_flags(x)
    assert flags.dtype == torch.int32 and tuple(flags.shape) == (3, 2, 5)
    any_ = tops._slab_mask(x, tcount.BM, tcount.BK, tops._nonzero)
    assert torch.equal(flags[2], any_)
    if kind != "zeros":
        assert flags[2, 0, 1] == 0 and flags[2, 1, 3] == 0
        assert flags[2, 0, 4] == 1
    for flag, piece in zip(flags[:2], tcount.split3(x)[1:]):
        held = _slab_any(piece.float())
        assert ((flag - held) >= 0).all()
        if kind != "subnormals":
            assert torch.equal(flag, held)
    if kind == "integers":    # counts below 2^24: mid only above 255
        assert torch.equal(flags[0], _slab_any(x * (x > 255)))
    # where no piece but hi is set, the slab still holds its entries
    assert ((flags[2] - flags[0]) >= 0).all() and (
        (flags[2] - flags[1]) >= 0).all()


@pytest.mark.parametrize("kind,planes", [("adjacency", 1), ("integers", 3),
                                         ("floats", 3), ("halves", 1)])
def test_right_planes_choose_one_or_three(kind, planes):
    rng = np.random.default_rng(planes)
    a = {"adjacency": (rng.random((192, 80)) < 0.1),
         "integers": rng.integers(0, 5000, (192, 80)),
         "floats": rng.standard_normal((192, 80)),
         "halves": rng.integers(-8, 8, (192, 80)) / 2.0}[kind]
    a = a.astype(np.float32)
    got = tcount.right_planes(torch.tensor(a))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (planes, 80,
                                                                192)
    assert got.is_contiguous()
    total = got.float().sum(dim=0).t().numpy()
    assert np.array_equal(total, a)


def test_three_term_counts_are_exact_at_the_2_24_boundary():
    """Integer rows against a {0,1} adjacency at K = 16384 whose true sums
    reach 2^24 - 1: the three f32-summed products equal the f64 product
    bit for bit, and the reference's product."""
    rng = np.random.default_rng(24)
    k, n = 16384, 8
    s = np.zeros((4, k), np.float64)
    s[0, 7] = 2**24 - 1                       # one count, three pieces
    s[1] = rng.integers(0, 2048, k)
    s[1, -1] = 0.0
    s[1, -1] = 2**24 - 1 - s[1].sum()         # many counts, the same sum
    s[2] = rng.integers(0, 1024, k)
    s[3, ::3] = 2**24 // (k // 3 + 1)
    a = (rng.random((k, n)) < 0.5).astype(np.float32)
    a[:, 0] = 1.0
    s = s.astype(np.float32)
    exp = s.astype(np.float64) @ a.astype(np.float64)
    assert exp.max() == 2**24 - 1 and exp.max() < 2**24
    planes = tcount.right_planes(torch.tensor(a))
    assert planes.shape[0] == 1
    got = split_product(torch.tensor(s), planes).numpy()
    assert np.array_equal(got, exp.astype(np.float32))
    ref = np.asarray(jops.count_mm(jnp.asarray(s[:, :2048]),
                                   jnp.asarray(a[:2048])))
    got_ref = split_product(
        torch.tensor(s[:, :2048]),
        tcount.right_planes(torch.tensor(a[:2048]))).numpy()
    assert np.array_equal(got_ref, ref)


# tests/test_kernels.py's shape sweep (S, K, N)
SHAPES = [(128, 128, 128), (70, 200, 130), (1, 512, 64), (256, 64, 256)]


@pytest.mark.parametrize("s_,k,n", SHAPES)
def test_six_term_float_product_within_tol(s_, k, n):
    """General f32 on both sides: the six terms i + j <= 2, summed exactly,
    within rtol = atol = 1e-5 (the count product's float tolerance) of the
    exact product.  (Two f32 summation orders of these sums already differ
    by up to 2e-5 at K = 512, so the split is held to the exact value; the
    test below holds it to the f32 product's own error.)"""
    rng = np.random.default_rng(k + n)
    s = rng.standard_normal((s_, k)).astype(np.float32)
    a = rng.standard_normal((k, n)).astype(np.float32)
    planes = tcount.right_planes(torch.tensor(a))
    assert planes.shape[0] == 3
    got = split_product(torch.tensor(s), planes,
                                     acc=torch.float64).numpy()
    exact = s.astype(np.float64) @ a.astype(np.float64)
    np.testing.assert_allclose(got, exact, **TOL)
    assert np.abs(got - exact).max() <= np.abs((s @ a) - exact).max()


@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_six_term_error_is_the_f32_products_own(acc):
    """At K = 4096 the dropped terms (i + j >= 3, below 2^-24 |s||a| each)
    leave the split no further from the exact product than the f32 product
    itself, whether its terms are summed in f32 or exactly."""
    rng = np.random.default_rng(4096)
    s = rng.standard_normal((16, 4096)).astype(np.float32)
    a = rng.standard_normal((4096, 24)).astype(np.float32)
    exact = s.astype(np.float64) @ a.astype(np.float64)
    got = split_product(torch.tensor(s),
                                     tcount.right_planes(torch.tensor(a)),
                                     acc=acc).numpy()
    f32_err = np.abs((s @ a) - exact).max()
    assert np.abs(got - exact).max() <= 2 * f32_err


def test_six_term_product_of_backward_flows():
    """The backward sweep's left operand (1 + delta) / sigma against the
    {0,1} adjacency (one plane, three terms) within 1e-5."""
    rng = np.random.default_rng(5)
    sigma = rng.integers(1, 10**6, (32, 1024)).astype(np.float32)
    f = ((1 + rng.random((32, 1024)) * 100) / sigma).astype(np.float32)
    a = (rng.random((1024, 40)) < 0.2).astype(np.float32)
    got = split_product(torch.tensor(f),
                                     tcount.right_planes(torch.tensor(a)))
    np.testing.assert_allclose(got.numpy(), f @ a, **TOL)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-20])
def test_two_term_p_within_2_pow_minus_15(scale):
    rng = np.random.default_rng(int(-np.log10(scale)))
    p = (np.exp(-rng.random(8192) * 30) * scale).astype(np.float32)
    p[:3] = [0.0, 1.0, scale]
    hi, lo = tflash.split_p(torch.tensor(p))
    assert hi.dtype == lo.dtype == torch.bfloat16
    hi = hi.float().numpy()
    assert np.array_equal(hi, _f32(p.view(np.uint32) & 0xFFFF0000))
    two = hi.astype(np.float64) + lo.float().numpy()
    assert (np.abs(two - p) <= 2.0 ** -15 * p).all()
    # one bf16 rounding is about 2^-9: the second term is what buys 2^-15
    one = torch.tensor(p).bfloat16().float().numpy().astype(np.float64)
    assert (np.abs(one - p) / np.where(p > 0, p, 1)).max() > 2.0 ** -12
