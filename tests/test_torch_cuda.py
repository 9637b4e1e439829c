"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit: a CUDA kernel has no
CPU mode, so they skip elsewhere.  The file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core.semiring as tsem
import repro_torch.kernels.bool_mm as tbool
import repro_torch.kernels.count_mm as tcount
import repro_torch.kernels.flash_attention as tflash
import repro_torch.kernels.minplus_mm as tmin
import repro_torch.kernels.ops as tops
from repro_torch.kernels.ref import flash_attention_ref

SHAPES = [(128, 128, 128), (70, 200, 130), (1, 512, 64), (256, 64, 256)]


def _tile_occ(a, tile, identity=0.0):
    k, n = a.shape
    nt_r, nt_c = -(-k // tile), -(-n // tile)
    pad = np.full((nt_r * tile, nt_c * tile), identity, np.float32)
    pad[:k, :n] = a
    blocks = pad.reshape(nt_r, tile, nt_c, tile)
    live = np.isfinite(blocks) if np.isinf(identity) else blocks != 0
    return live.any(axis=(1, 3)).astype(np.int32)


def _minplus_np(d, w, chunk=256):
    out = np.full((d.shape[0], w.shape[1]), np.inf, np.float32)
    for k0 in range(0, d.shape[1], chunk):
        out = np.minimum(out, np.min(d[:, k0:k0 + chunk, None]
                                     + w[None, k0:k0 + chunk, :], axis=1))
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,k,n", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, s, k, n):
    rng = np.random.default_rng(s + k + n)
    f = (rng.random((s, k)) * 4).astype(np.int32).astype(np.float32)
    a = (rng.random((k, n)) < 0.1).astype(np.float32)
    fc = torch.tensor(f, device=cuda_device)
    ac = torch.tensor(a, device=cuda_device)
    before = dict(tcount.LAUNCHES)
    got = tops.count_mm(fc, ac)
    amask = torch.tensor(_tile_occ(a, 64), device=cuda_device)
    got_m = tops.count_mm(fc, ac, amask=amask, tile=64)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy(), f @ a)
    assert np.array_equal(got_m.cpu().numpy(), f @ a)
    assert tcount.LAUNCHES["count_mm"] == before["count_mm"] + 1
    assert tcount.LAUNCHES["count_mm_masked"] == before["count_mm_masked"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s,k,n", SHAPES)
def test_cuda_bool_mm_matches_plain(cuda_device, s, k, n):
    rng = np.random.default_rng(3 * s + k + n)
    f = (rng.random((s, k)) < 0.1).astype(np.float32)
    a = (rng.random((k, n)) < 0.1).astype(np.float32)
    a[:, : n // 3] = 0.0  # a band of empty tiles to skip
    fc = torch.tensor(f, device=cuda_device)
    ac = torch.tensor(a, device=cuda_device)
    amask = torch.tensor(_tile_occ(a, 32), device=cuda_device)
    before = dict(tbool.LAUNCHES)
    got = tops.bool_mm(fc, ac)
    got_m = tops.bool_mm(fc, ac, amask=amask, tile=32)
    torch.cuda.synchronize()
    assert tbool.LAUNCHES["bool_mm"] == before["bool_mm"] + 1
    assert tbool.LAUNCHES["bool_mm_masked"] == before["bool_mm_masked"] + 1
    exp = ((f @ a) > 0).astype(np.float32)
    assert np.array_equal(got.cpu().numpy(), exp)
    assert np.array_equal(got_m.cpu().numpy(), exp)
    plain = tsem.bool_mm(fc, ac, use_kernel=False, amask=amask, tile=32)
    assert torch.equal(got_m, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 384])
def test_cuda_bool_mm_row_blocks_ragged_k(cuda_device, m):
    """One row block (the static mode's M = 128) and three, with K and N
    ragged (padded by ``ops``) and a band of empty tiles: dense and masked
    bit-exact, one launch each."""
    rng = np.random.default_rng(m)
    k, n = 1000, 300
    f = (rng.random((m, k)) < 0.05).astype(np.float32)
    f[m // 2:, :] = 0.0
    a = (rng.random((k, n)) < 0.05).astype(np.float32)
    a[:, 100:260] = 0.0
    fc = torch.tensor(f, device=cuda_device)
    ac = torch.tensor(a, device=cuda_device)
    amask = torch.tensor(_tile_occ(a, 128), device=cuda_device)
    before = dict(tbool.LAUNCHES)
    got = tops.bool_mm(fc, ac)
    got_m = tops.bool_mm(fc, ac, amask=amask, tile=128)
    torch.cuda.synchronize()
    assert tbool.LAUNCHES["bool_mm"] == before["bool_mm"] + 1
    assert tbool.LAUNCHES["bool_mm_masked"] == before["bool_mm_masked"] + 1
    exp = ((f @ a) > 0).astype(np.float32)
    assert np.array_equal(got.cpu().numpy(), exp)
    assert np.array_equal(got_m.cpu().numpy(), exp)
    assert torch.equal(got, tsem.bool_mm(fc, ac, use_kernel=False))


@pytest.mark.cuda
def test_cuda_bool_mm_counts_past_int8(cuda_device):
    """A row of all ones across K = 16384 against a column of all ones:
    a count of 16384, which wraps to 0 in int8 but not in the s32
    accumulators."""
    k, n = 16384, 256
    f = torch.zeros((128, k), device=cuda_device)
    f[0] = 1.0
    f[1, 5] = 1.0
    a = torch.zeros((k, n), device=cuda_device)
    a[:, 0] = 1.0
    a[7, 3] = 1.0
    got = tbool.bool_mm(f, a)
    torch.cuda.synchronize()
    assert torch.equal(got, tbool.bool_mm_ref(f, a))
    assert got[0, 0] == 1.0 and got[0, 3] == 1.0 and got[1, 0] == 1.0
    assert float(got.sum()) == 3.0


@pytest.mark.cuda
def test_cuda_bool_packs_match_plain(cuda_device):
    """The two pack kernels equal their plain versions, on values other
    than 0 and 1 (negative, -0.0, fractions) too."""
    g = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn((192, 320), generator=g)
    x[x.abs() < 0.8] = 0.0
    x[0, :8] = -0.0
    xc = x.to(cuda_device)
    left = tbool.pack_left(xc)
    right = tbool.pack_right(xc)
    torch.cuda.synchronize()
    assert left.dtype == right.dtype == torch.int8
    assert torch.equal(left.cpu(), tbool.pack_left_plain(x))
    assert torch.equal(right.cpu(), tbool.pack_right_plain(x))
    assert right.shape == (320, 192) and right.is_contiguous()


@pytest.mark.cuda
def test_cuda_bool_mm_refuses_bad_packed(cuda_device):
    """A packed right operand that TMA cannot read (a base off 16 bytes,
    not contiguous, the wrong type or shape) raises, launching nothing."""
    bm, bn, bk = tbool.BM, tbool.BN, tbool.BK
    f = torch.zeros((bm, bk), device=cuda_device)
    a = torch.zeros((bk, bn), device=cuda_device)
    buf = torch.zeros(bn * bk + 16, dtype=torch.int8, device=cuda_device)
    bad = [buf[1:1 + bn * bk].view(bn, bk),
           torch.zeros((bk, bn), dtype=torch.int8, device=cuda_device).t(),
           torch.zeros((bn, bk), dtype=torch.uint8, device=cuda_device),
           torch.zeros((bn, 2 * bk), dtype=torch.int8, device=cuda_device)]
    before = dict(tbool.LAUNCHES)
    for packed in bad:
        with pytest.raises(ValueError, match="16-byte"):
            tbool.bool_mm(f, a, packed=packed)
    with pytest.raises(ValueError, match="16-byte"):
        tbool.bool_mm_masked(f, a, torch.ones((1, 1), dtype=torch.int32,
                                              device=cuda_device),
                             torch.ones((1, 1), dtype=torch.int32,
                                        device=cuda_device), packed=bad[0])
    assert tbool.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("s,k,n", SHAPES)
def test_cuda_minplus_mm_matches_plain(cuda_device, s, k, n):
    rng = np.random.default_rng(5 * s + k + n)
    d = rng.random((s, k)).astype(np.float32) * 8 - 1
    d[rng.random((s, k)) < 0.4] = np.inf
    w = rng.random((k, n)).astype(np.float32) * 5 - 1
    w[rng.random((k, n)) < 0.7] = np.inf
    w[:, : n // 3] = np.inf  # a band of empty tiles to skip
    dc = torch.tensor(d, device=cuda_device)
    wc = torch.tensor(w, device=cuda_device)
    amask = torch.tensor(_tile_occ(w, 32, np.inf), device=cuda_device)
    before = dict(tmin.LAUNCHES)
    got = tops.minplus_mm(dc, wc)
    got_m = tops.minplus_mm(dc, wc, amask=amask, tile=32)
    torch.cuda.synchronize()
    assert tmin.LAUNCHES["minplus_mm"] == before["minplus_mm"] + 1
    assert (tmin.LAUNCHES["minplus_mm_masked"]
            == before["minplus_mm_masked"] + 1)
    exp = _minplus_np(d, w)
    assert np.array_equal(got.cpu().numpy(), exp)
    assert np.array_equal(got_m.cpu().numpy(), exp)
    assert np.isposinf(got_m.cpu().numpy()[:, : n // 3]).all()
    plain = tsem.minplus_mm(dc, wc, use_kernel=False, amask=amask, tile=32)
    assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("mod,name,identity", [
    (tbool, "bool_mm", 0.0), (tmin, "minplus_mm", float("inf")),
    (tcount, "count_mm", 0.0)])
def test_cuda_masked_kernels_skip_block_for_block(cuda_device, mod, name,
                                                  identity):
    """Raw masked entry points with a deliberately wrong mask equal the
    masked plain version, which skips exactly the same blocks."""
    bm, bn, bk = mod.BM, mod.BN, mod.BK
    g = torch.Generator(device="cpu").manual_seed(7)
    x = (torch.rand((2 * bm, 3 * bk), generator=g) < 0.3).float()
    a = (torch.rand((3 * bk, 2 * bn), generator=g) < 0.3).float()
    if name == "minplus_mm":
        x = torch.where(x > 0, torch.rand(x.shape, generator=g), identity)
        a = torch.where(a > 0, torch.rand(a.shape, generator=g), identity)
    xm = torch.ones((2, 3), dtype=torch.int32)
    am = torch.ones((3, 2), dtype=torch.int32)
    xm[1, 2] = 0
    am[:, 1] = 0  # output column block 1 skipped entirely
    args = [t.to(cuda_device) for t in (x, a, xm, am)]
    got = getattr(mod, f"{name}_masked")(*args)
    exp = getattr(mod, f"{name}_masked_plain")(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)
    assert bool((got[:, bn:] == identity).all())


# Row counts of the min-plus kernel's two forms: skinny below 88 rows (one
# 8-row granule per CTA) and wide from 88 (128-row tiles, ragged at 88,
# 120, 136 and 264).  K = 4096 is 256 k-steps: both forms split K there,
# since the grid alone is a few CTAs.
MINPLUS_ROWS = [8, 16, 80, 88, 120, 128, 136, 264]


@pytest.mark.cuda
@pytest.mark.parametrize("m", MINPLUS_ROWS)
def test_cuda_minplus_mm_skinny_and_wide(cuda_device, m):
    """Both forms, dense and masked, with split K, against numpy: negative
    weights, rows and columns of +inf, one launch per call."""
    k, n, tile = 4096, 256, 128
    rng = np.random.default_rng(m)
    d = rng.random((m, k)).astype(np.float32) * 8 - 1
    d[rng.random((m, k)) < 0.5] = np.inf
    d[m // 2] = np.inf                       # a source that reaches nothing
    w = (rng.integers(-2, 7, (k, n))).astype(np.float32)
    w[rng.random((k, n)) < 0.99] = np.inf
    w[:, 3] = np.inf                         # a vertex with no in-edges
    w[:, 200:] = np.inf                      # a column tile of no edges
    w[2048:2304] = np.inf                    # 16 k-steps of no edges
    dc = torch.tensor(d, device=cuda_device)
    wc = torch.tensor(w, device=cuda_device)
    amask = torch.tensor(_tile_occ(w, tile, np.inf), device=cuda_device)
    before = dict(tmin.LAUNCHES)
    got = tops.minplus_mm(dc, wc)
    got_m = tops.minplus_mm(dc, wc, amask=amask, tile=tile)
    torch.cuda.synchronize()
    assert tmin.LAUNCHES["minplus_mm"] == before["minplus_mm"] + 1
    assert (tmin.LAUNCHES["minplus_mm_masked"]
            == before["minplus_mm_masked"] + 1)
    exp = _minplus_np(d, w)
    assert np.isfinite(exp).any() and np.isposinf(exp[m // 2]).all()
    assert np.array_equal(got.cpu().numpy(), exp)
    assert np.array_equal(got_m.cpu().numpy(), exp)


@pytest.mark.cuda
@pytest.mark.parametrize("granules", [2, 17, 33])
def test_cuda_minplus_masked_skips_per_row_granule(cuda_device, granules):
    """A deliberately wrong dmask at the 8-row granule: skinny (2 granules)
    and wide (17 and 33: ragged 128-row tiles whose granules have mixed
    bits) skip exactly the plain version's blocks."""
    bm, bn, bk = tmin.BM, tmin.BN, tmin.BK
    m, nbk, nbn = granules * bm, 24, 2
    g = torch.Generator(device="cpu").manual_seed(granules)
    x = torch.rand((m, nbk * bk), generator=g) * 4 - 1
    x[torch.rand(x.shape, generator=g) < 0.2] = float("inf")
    a = torch.rand((nbk * bk, nbn * bn), generator=g)
    a[torch.rand(a.shape, generator=g) < 0.5] = float("inf")
    xm = (torch.rand((granules, nbk), generator=g) < 0.6).to(torch.int32)
    am = (torch.rand((nbk, nbn), generator=g) < 0.8).to(torch.int32)
    args = [t.to(cuda_device) for t in (x, a, xm, am)]
    before = tmin.LAUNCHES["minplus_mm_masked"]
    got = tmin.minplus_mm_masked(*args)
    exp = tmin.minplus_mm_masked_plain(*args)
    torch.cuda.synchronize()
    assert tmin.LAUNCHES["minplus_mm_masked"] == before + 1
    assert torch.equal(got, exp)
    assert not torch.equal(got, tmin.minplus_mm_plain(*args[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 128])
def test_cuda_minplus_mm_zero_ties(cuda_device, m):
    """Outputs whose least candidates are +0 (1 + -1, -0 + +0) and -0
    (-0 + -0), the -0 first in column 0 and last in column 1, in K splits
    far apart: every form writes -0 (fminf takes -0 as the smaller), so the
    zero's sign does not depend on the order of the candidates."""
    k, n = 4096, 128
    inf = float("inf")
    d = torch.full((m, k), inf)
    d[:, 0] = -0.0
    d[:, 4000] = 1.0
    d[:, 4001] = -0.0
    w = torch.full((k, n), inf)
    w[0, 0], w[4000, 0] = -0.0, -1.0   # column 0: -0 at k 0, +0 at k 4000
    w[0, 1], w[4001, 1] = 0.0, -0.0    # column 1: +0 at k 0, -0 at k 4001
    dc, wc = d.to(cuda_device), w.to(cuda_device)
    ones = torch.ones((m // tmin.BM, k // tmin.BK), dtype=torch.int32,
                      device=cuda_device)
    wones = torch.ones((k // tmin.BK, n // tmin.BN), dtype=torch.int32,
                       device=cuda_device)
    neg_zero = torch.tensor(-0.0).view(torch.int32).item()
    for got in (tmin.minplus_mm(dc, wc),
                tmin.minplus_mm_masked(dc, wc, ones, wones)):
        bits = got.cpu().view(torch.int32)
        assert (bits[:, :2] == neg_zero).all(), bits[:2, :2]
        assert torch.isinf(got[:, 2:]).all()


def _boundary_counts(rng, s, k):
    """Integer rows whose products with an all-ones column reach 2^24 - 1:
    row 0 one entry of 2^24 - 1 (all three bf16 pieces nonzero), row 1
    entries below 2^14 summing to 2^24 - 1, the rest small counts."""
    x = rng.integers(0, 40, (s, k)).astype(np.float64)
    x[0] = 0.0
    x[0, 3] = 2**24 - 1
    x[1] = rng.integers(0, 2**14, k)
    x[1, -1] = 0.0
    x[1, -1] = 2**24 - 1 - x[1].sum()
    assert 0 <= x[1, -1] < 2**24
    return x.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_count_mm_exact_at_the_2_24_boundary(cuda_device, masked):
    """Integer counts whose sums reach 2^24 - 1 against a {0,1} adjacency
    (one bf16 plane): bit-exact against the f64 product and the plain
    version, dense and masked."""
    rng = np.random.default_rng(24)
    s, k, n = 256, 1024, 256
    f = _boundary_counts(rng, s, k)
    a = (rng.random((k, n)) < 0.05).astype(np.float32)
    a[:, 0] = 1.0
    a[:, n // 2:] = 0.0  # a band of empty tiles to skip
    exp = (f.astype(np.float64) @ a.astype(np.float64))
    assert exp.max() == 2**24 - 1
    fc = torch.tensor(f, device=cuda_device)
    ac = torch.tensor(a, device=cuda_device)
    assert tcount.right_planes(ac).shape[0] == 1
    name = "count_mm_masked" if masked else "count_mm"
    before = tcount.LAUNCHES[name]
    kw = dict(amask=torch.tensor(_tile_occ(a, 64), device=cuda_device),
              tile=64) if masked else {}
    got = tops.count_mm(fc, ac, **kw)
    plain = tsem.count_mm(fc, ac, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert tcount.LAUNCHES[name] == before + 1
    assert np.array_equal(got.cpu().numpy(), exp.astype(np.float32))
    assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_count_mm_float_operands_three_planes(cuda_device, masked):
    """General floats on both sides (three planes of a, six products)
    within rtol = atol = 1e-5 of the exact product, and no further from it
    than twice the plain f32 product is.  (At K = 512 two f32 summation
    orders already differ by more than 1e-5 in places, so the plain
    product is no fixed point to hold the kernel to at 1e-5.)"""
    rng = np.random.default_rng(6)
    s, k, n = 200, 512, 300
    f = rng.standard_normal((s, k)).astype(np.float32)
    a = rng.standard_normal((k, n)).astype(np.float32)
    a[:128, :128] = 0.0
    fc = torch.tensor(f, device=cuda_device)
    ac = torch.tensor(a, device=cuda_device)
    assert tcount.right_planes(ac).shape[0] == 3
    kw = dict(amask=torch.tensor(_tile_occ(a, 64), device=cuda_device),
              tile=64) if masked else {}
    got = tops.count_mm(fc, ac, **kw)
    plain = tsem.count_mm(fc, ac, use_kernel=False, **kw)
    torch.cuda.synchronize()
    exact = f.astype(np.float64) @ a.astype(np.float64)
    err = np.abs(got.cpu().numpy() - exact)
    assert np.allclose(got.cpu().numpy(), exact, rtol=1e-5, atol=1e-5)
    assert err.max() <= 2 * np.abs(plain.cpu().numpy() - exact).max()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_count_mm_three_planes_match_plain(cuda_device, masked):
    """The three-plane path held to the plain version at rtol = atol = 1e-5
    on floats where every f32 summation order gives the same answer:
    multiples of 2^-9 in [-1, 1] (ten significant bits, so a is not exact
    in bf16) whose products and partial sums stay exact in f32."""
    rng = np.random.default_rng(7)
    s, k, n = 200, 512, 300
    f = (rng.integers(-512, 513, (s, k)) / 512).astype(np.float32)
    a = (rng.integers(-512, 513, (k, n)) / 512).astype(np.float32)
    a[:128, :128] = 0.0
    exact = f.astype(np.float64) @ a.astype(np.float64)
    assert np.array_equal((f @ a).astype(np.float64), exact)
    fc = torch.tensor(f, device=cuda_device)
    ac = torch.tensor(a, device=cuda_device)
    assert tcount.right_planes(ac).shape[0] == 3
    name = "count_mm_masked" if masked else "count_mm"
    before = tcount.LAUNCHES[name]
    kw = dict(amask=torch.tensor(_tile_occ(a, 64), device=cuda_device),
              tile=64) if masked else {}
    got = tops.count_mm(fc, ac, **kw)
    plain = tsem.count_mm(fc, ac, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert tcount.LAUNCHES[name] == before + 1
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_count_mm_masked_rows_are_independent(cuda_device):
    """A row of the masked product is bit-identical whether the other rows
    of its slab are zero (its dead k-steps skipped) or not (computed), on
    backward-style flows (1 + delta) / sigma: what lets a delta bc_scores
    reproduce a cold one."""
    rng = np.random.default_rng(11)
    s, k, n = 256, 1024, 256
    sigma = rng.integers(1, 5000, (s, k)).astype(np.float32)
    delta = rng.random((s, k)).astype(np.float32) * 30
    f = ((1 + delta) / sigma).astype(np.float32)
    f[rng.random((s, k)) < 0.5] = 0.0
    f[5, 64:640] = 0.0  # k-steps where row 5 alone is dead
    a = (rng.random((k, n)) < 0.1).astype(np.float32)
    ac = torch.tensor(a, device=cuda_device)
    amask = torch.tensor(_tile_occ(a, 64), device=cuda_device)
    product = tops.count_mm_against(ac, amask=amask, tile=64)
    full = product(torch.tensor(f, device=cuda_device))
    alone = np.zeros_like(f)
    alone[5] = f[5]
    single = product(torch.tensor(alone, device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(full[5], single[5])
    torch.testing.assert_close(full, torch.tensor(f @ a, device=cuda_device),
                               rtol=1e-5, atol=1e-5)


# (case, k): what the masked count kernel's bitmap of live k-steps holds
BITMAP = [("all dead", 1024), ("first and last", 1024),
          ("partial word", 40 * 64), ("stricter smask", 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,k", BITMAP)
def test_cuda_count_mm_masked_bitmap_cases(cuda_device, case, k):
    """The masked kernel reads its masks once per CTA into a bitmap of
    live k-steps (its left mask the split's own flag, ANDed with a given
    ``smask``): bit-identical to the masked plain version on integer
    counts (mid pieces included) with every pair dead, with live k-steps
    only at the first and the last, with 40 k-steps (a partial bitmap
    word), and under an ``smask`` stricter than the slabs' own.  The
    kernel's tally counts the live pairs and the tiles with none."""
    rng = np.random.default_rng(k + len(case))
    m, n = 256, 384
    nbm, nbk, nbn = m // 128, k // 64, n // 128
    f = rng.integers(0, 600, (m, k)).astype(np.float32)
    f[rng.random((m, k)) < 0.7] = 0.0
    f[:128, 128:320] = 0.0                   # dead slabs in row block 0
    a = (rng.random((k, n)) < 0.1).astype(np.float32)
    am = (rng.random((nbk, nbn)) < 0.6).astype(np.int32)
    sm = None
    if case == "all dead":
        f[:128] = 0.0
        am[:] = 0
    elif case == "first and last":
        am[:] = 0
        am[0] = am[-1] = 1
    elif case == "stricter smask":
        sm = (rng.random((nbm, nbk)) < 0.5).astype(np.int32)
    fc, ac = (torch.tensor(t, device=cuda_device) for t in (f, a))
    amc = torch.tensor(am, device=cuda_device)
    smc = None if sm is None else torch.tensor(sm, device=cuda_device)
    own = tcount.split_flags(fc)[2]
    assert torch.equal(own, tops._slab_mask(fc, 128, 64, tops._nonzero))
    live = own.cpu().numpy() if sm is None else own.cpu().numpy() & sm
    pairs = live[:, :, None].astype(bool) & am[None].astype(bool)
    tcount.reset_pairs()
    got = tcount.count_mm_masked(fc, ac, smc, amc)
    tally = tcount.read_pairs()
    exp = tcount.count_mm_masked_plain(
        fc, ac, own if smc is None else smc, amc)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)
    if case == "all dead":
        assert not got.any()
    elif case == "partial word":
        assert np.array_equal(got.cpu().numpy(), (f @ (
            a * np.repeat(np.repeat(am, 64, 0), 128, 1))).astype(np.float32))
    assert tally == {"launches": 1, "pairs": nbm * nbk * nbn,
                     "live_pairs": int(pairs.sum()),
                     "zero_tiles": int((~pairs.any(axis=1)).sum())}


# (b, hq, hkv, sq, skv, d, causal, window)
FLASH = [
    (1, 4, 4, 32, 32, 16, True, None),      # MHA square
    (2, 4, 2, 37, 53, 16, True, None),      # GQA, ragged sq / skv
    (1, 8, 1, 16, 64, 32, True, None),      # MQA
    (2, 2, 2, 1, 40, 16, True, None),       # one query (decode shape)
    (1, 2, 2, 24, 40, 16, False, None),     # non-causal
    (1, 4, 2, 48, 48, 64, True, 8),         # window
    (1, 4, 2, 100, 100, 32, False, 20),     # non-causal with a window
    (1, 4, 1, 200, 330, 128, True, None),   # several tiles each way
    (2, 8, 2, 130, 70, 64, True, 40),       # more queries than keys
    (1, 4, 2, 300, 300, 128, False, None),  # non-causal, head dim 128
    (2, 4, 1, 257, 257, 128, True, 100),    # window, ragged, head dim 128
    (1, 8, 2, 70, 200, 128, True, None),    # a long prefix, head dim 128
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FLASH)
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, b, hq, hkv,
                                            sq, skv, d, causal, window):
    """f32 within 3e-5 (summation order); bf16 within one bf16 rounding
    step (rtol 2^-7): both compute in f32 and round the output."""
    g = torch.Generator(device="cpu").manual_seed(sq * skv + d)
    q, k, v = (torch.randn(shape, generator=g).to(cuda_device, dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
    before = tflash.LAUNCHES["flash_attention"]
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    exp = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (b, hq, sq, d)
    if dtype == torch.float32:
        assert float((got - exp).abs().max()) < 3e-5
    else:
        torch.testing.assert_close(got.float(), exp.float(), rtol=2**-7,
                                   atol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_cache_prefix_in_place(cuda_device):
    """A prefix of a longer cache and a transposed query go to the kernel
    through their strides, with no copy, and give the contiguous answer."""
    g = torch.Generator(device="cpu").manual_seed(3)
    cache_k = torch.randn((2, 2, 96, 64), generator=g).to(cuda_device)
    cache_v = torch.randn((2, 2, 96, 64), generator=g).to(cuda_device)
    q = torch.randn((2, 40, 8, 64), generator=g).to(cuda_device)
    q = q.transpose(1, 2)                       # [B, H, S, D], strided
    k, v = cache_k[:, :, :70], cache_v[:, :, :70]
    assert not k.is_contiguous() and not q.is_contiguous()
    got = tops.flash_attention(q, k, v)
    exp = tops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, exp)
    assert float((got - flash_attention_ref(q, k, v)).abs().max()) < 3e-5


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_mixed_devices(cuda_device):
    q = torch.zeros((1, 2, 8, 16), device=cuda_device)
    with pytest.raises(ValueError):
        tops.flash_attention(q, q.cpu(), q.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_refuses_autograd(cuda_device, dtype):
    """The kernel has no backward: under grad mode with an input that
    requires grad it raises (and launches nothing) instead of returning a
    result cut off from the graph; under no_grad, or when nothing requires
    grad, it launches as always."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 4, 64, 64), generator=g,
                           device=cuda_device).to(dtype) for _ in range(3))
    before = tflash.LAUNCHES["flash_attention"]
    for leaf in (q, k, v):
        leaf.requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            tops.flash_attention(q, k, v)
        leaf.requires_grad_(False)
    assert tflash.LAUNCHES["flash_attention"] == before
    q.requires_grad_()
    with torch.no_grad():
        got = tops.flash_attention(q, k, v)
    plain = tops.flash_attention(q.detach(), k, v)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 2
    assert not got.requires_grad and torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_attention_bf16_cache_prefix(cuda_device, d):
    """bf16 through the TMA maps over a cache prefix and a transposed
    query: the plain version's answer to one bf16 rounding step."""
    g = torch.Generator(device="cpu").manual_seed(d)
    cache = torch.randn((2, 4, 300, d), generator=g).to(cuda_device,
                                                         torch.bfloat16)
    q = torch.randn((2, 150, 8, d), generator=g).to(cuda_device,
                                                    torch.bfloat16)
    q = q.transpose(1, 2)
    k, v = cache[:, :, :210], cache.flip(2)[:, :, :210]
    before = tflash.LAUNCHES["flash_attention"]
    got = tops.flash_attention(q, k, v)
    exp = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), exp.float(), rtol=2**-7,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,causal", [(300, 1500, False),
                                           (1500, 1500, False),
                                           (224, 224, True)])
def test_cuda_flash_attention_encdec_shapes(cuda_device, sq, skv, causal):
    """Whisper's shapes: 20 heads, 1500 keys (23 full 64-key tiles and 28
    ragged rows) not causal, a transposed query against a cross cache laid
    out [B, KV, Se, D], and a causal prefix of a longer self cache; bf16
    to one rounding step."""
    g = torch.Generator(device="cpu").manual_seed(sq + skv)
    q = torch.randn((1, sq, 20, 64), generator=g).to(
        cuda_device, torch.bfloat16).transpose(1, 2)
    cache = torch.randn((2, 1, 20, skv + 32, 64), generator=g).to(
        cuda_device, torch.bfloat16)
    k, v = cache[0, :, :, :skv], cache[1, :, :, :skv]
    before = tflash.LAUNCHES["flash_attention"]
    got = tops.flash_attention(q, k, v, causal=causal)
    exp = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), exp.float(), rtol=2**-7,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_12b",
                                  "whisper_large_v3"])
def test_cuda_lm_families_match_cpu(cuda_device, arch):
    """A reduced SSM / hybrid / encoder-decoder model (f32) served on the
    card equals the same weights on the CPU: prefill logits (flash kernel
    on the card, its plain version on the CPU) and three decode steps."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    cfg = reduced(get_config(arch))
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                         generator=torch.Generator().manual_seed(2))
    toks = torch.randint(1, cfg.vocab_size, (2, 37),
                         generator=torch.Generator().manual_seed(1))

    def move(tree, dev):
        if isinstance(tree, dict):
            return {k: move(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [move(v, dev) for v in tree]
        return tree.to(dev)

    out = {}
    for dev in ("cpu", cuda_device):
        extra = {"frames": frames.to(dev)} if cfg.family == "audio" else {}
        p = move(params, dev)
        cache = m.init_cache(2, 41, dtype=torch.float32, device=dev)
        logits, cache = m.prefill(p, toks.to(dev), cache, **extra)
        steps = [logits.cpu()]
        for i in range(3):
            logits, cache = m.decode_step(p, toks[:, i:i + 1].to(dev), cache)
            steps.append(logits.cpu())
        out[str(dev)] = steps
    assert cfg.attn_impl == "flash"
    for got, exp in zip(out[str(cuda_device)], out["cpu"]):
        torch.testing.assert_close(got, exp, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_moe_1b", "mamba2_780m",
                                  "llama4_maverick_400b"])
def test_cuda_training_matches_cpu(cuda_device, arch):
    """The trainer's reduced config (f32, remat, attention through
    sdpa_chunked) on the card against the same weights and batch on the
    CPU: the loss and every gradient leaf of ``value_and_grad(loss_fn)`` to
    rtol = atol = 1e-4, the tolerance of the CPU tests against the
    reference.  A capacity factor of 0.5 makes the MoE drop pairs, so the
    dispatch/combine scatters' spill rows and the embedding's sorted
    segment-sum gradient run their CUDA forms.  Then two
    ``build_train_step`` steps with float32 moments: losses to rtol 1e-4,
    first moments to rtol 1e-4 and an atol of 1e-4 of each leaf's
    largest."""
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.launch import steps, train
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.tree import tree_leaves, tree_map

    cfg = train.train_config(arch, reduced=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    ds = SyntheticTokens(cfg.vocab_size, 64, 4, seed=3)
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), params)
        loss, grads = steps.value_and_grad(
            model.loss_fn, p, shard_batch(ds.batch_at(0), device=dev))
        step_fn = steps.build_train_step(model, peak_lr=1e-3,
                                         warmup_steps=0, total_steps=10)
        opt, losses = adamw_init(p, torch.float32), []
        for step in range(2):
            p, opt, met = step_fn(p, opt, shard_batch(ds.batch_at(step),
                                                      device=dev))
            losses.append(float(met["loss"]))
        out[str(dev)] = (float(loss), [g.cpu() for g in tree_leaves(grads)],
                         losses, [m.cpu() for m in tree_leaves(opt.m)])
    loss, grads, losses, ms = out[str(cuda_device)]
    eloss, egrads, elosses, ems = out["cpu"]
    np.testing.assert_allclose(loss, eloss, rtol=1e-4)
    assert len(grads) == len(egrads)
    for g, e in zip(grads, egrads):
        assert g.shape == e.shape and g.dtype == e.dtype
        torch.testing.assert_close(g, e, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(losses, elosses, rtol=1e-4)
    for m, e in zip(ms, ems):
        torch.testing.assert_close(m, e, rtol=1e-4,
                                   atol=1e-4 * float(e.abs().max()))


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_unaligned_stride(cuda_device):
    """A bf16 row stride TMA cannot take (136 bytes) raises, launching
    nothing."""
    base = torch.zeros((1, 2, 40, 68), dtype=torch.bfloat16,
                       device=cuda_device)
    k = base[..., :64]
    q = torch.zeros((1, 2, 40, 64), dtype=torch.bfloat16, device=cuda_device)
    before = tflash.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        tops.flash_attention(q, k, k)
    assert tflash.LAUNCHES["flash_attention"] == before


# ------------------------- telemetry and checkpoints -------------------------

@pytest.mark.cuda
def test_cuda_device_timer_reads_events(cuda_device):
    """On a CUDA device the region is timed by CUDA events: a few
    thousand-wide products read no more than the host's wall around the
    same region, and no less than the device time ``torch.profiler``
    gives the kernels launched inside the span around it (2% + 2 us for
    the two clocks)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import DeviceTimer, Tracer

    x = torch.randn((2048, 2048), device=cuda_device)
    timer = DeviceTimer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with Tracer().span("work"), \
                timer.region("work", cuda_device) as reg:
            for _ in range(8):
                x = (x @ x).tanh()
        wall_us = (time.perf_counter() - t0) * 1e6
        assert reg.cuda and 0 < reg.us
        torch.cuda.synchronize()
        assert reg.us <= (time.perf_counter() - t0) * 1e6
    assert wall_us > 0 and timer.total_us == reg.us
    work = [e for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name == "work"]
    assert len(work) == 1
    kern = float(work[0].device_time_total
                 if hasattr(work[0], "device_time_total")
                 else work[0].cuda_time_total)
    assert 0 < kern <= reg.us * 1.02 + 2.0


@pytest.mark.cuda
def test_cuda_query_cost_has_integer_peak_bytes(cuda_device):
    """A traced query on the card: its cost dict carries integer
    peak/temp bytes from the allocator and the query span device time
    from events."""
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.obs import CostAccountant, Telemetry

    tel = Telemetry(accountant=CostAccountant(shared=False))
    svc = GraphService(load_rmat_graph(512, 4096, seed=1, device="cuda"),
                       telemetry=tel)
    for kind in ("bfs", "sssp", "bc"):
        svc.query(kind, 0)
        cost = tel.accountant.last
        assert isinstance(cost["peak_bytes"], int) and cost["peak_bytes"] > 0
        assert isinstance(cost["temp_bytes"], int)
        assert cost["collective_bytes"] == 0
    spans = [r for r in tel.tracer.records if r["span"] == "query"]
    assert len(spans) == 3 and all(r["device_us"] > 0 for r in spans)


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrips_graph_state(cuda_device, tmp_path):
    """save_checkpoint / restore_checkpoint of a CUDA GraphState, and a
    journal recovered onto the card from its snapshot: bit for bit."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import PUTE, state_to_numpy
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.resil import OpJournal, journal_meta, recover

    g = load_rmat_graph(1024, 8192, seed=2, device="cuda")
    save_checkpoint(str(tmp_path / "c"), 1, g, version=1, verify=True)
    back = restore_checkpoint(str(tmp_path / "c"), 1, g, verify=True)
    assert back.alive.is_cuda
    for a, b in zip(state_to_numpy(g), state_to_numpy(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    wal = str(tmp_path / "wal.jsonl")
    svc = GraphService(g, batch_size=8, compact_every=2,
                       journal=OpJournal(wal, meta=journal_meta(
                           g, {"batch_size": 8})))
    svc.submit_many([(PUTE, i, (7 * i) % 1024, 2.0) for i in range(60)])
    rec = recover(wal, batch_size=8)
    assert rec.version == svc.version and rec.scheduler.pending() == 4
    for a, b in zip(state_to_numpy(svc.ring.latest.state),
                    state_to_numpy(rec.ring.latest.state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_edges", [31, 32, 33, 1000, 4099])
def test_cuda_lane_segment_sum_matches_single_source(cuda_device, n_edges):
    """The card's segmented sum picks its load path from each segment's
    address alignment: the lane sum (rows padded to 32 edges) must equal
    the single-source sum bit for bit, hub segments longer than a tile
    included."""
    from repro_torch.core import queries as tq

    rng = np.random.default_rng(n_edges)
    idx = np.where(rng.random(n_edges) < 0.6, 0,
                   rng.integers(0, 40, n_edges))  # vertex 0 a hub
    idx = torch.tensor(idx, device=cuda_device)
    seg = tq._segments(idx, 40, grouped=False)
    vals = torch.tensor(rng.standard_normal((7, n_edges)),
                        dtype=torch.float32, device=cuda_device)
    got = tq._lane_segments(seg, 7, n_edges).sum(vals)
    for i in range(7):
        assert torch.equal(got[i], seg.sum(vals[i])), i


@pytest.mark.cuda
def test_cuda_bc_refresh_under_the_vertex_order_matches_cpu(cuda_device):
    """``GraphService.bc_scores`` on the card, its sweeps in the hub-first
    vertex order against a grid of the reordered adjacency, cold and then
    delta after a commit: levels, sigma and ``ok`` bit-equal to the plain
    CPU ``bc_batched_dense`` in vertex order, scores within 1e-5."""
    from repro_torch.core import PUTE, queries as tq
    from repro_torch.core.graph_state import GraphState
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.kernels import count_mm as tcm

    svc = GraphService(load_rmat_graph(1024, 8192, seed=5, weighted=False,
                                       device="cuda"), batch_size=16)
    for step in range(2):
        if step:
            svc.submit_many([(PUTE, 40 + i, (37 * i) % 1024, 1.0)
                             for i in range(16)])
            svc.flush()
        tcm.reset_launches()
        scores, _ = svc.bc_scores()
        assert tcm.LAUNCHES["count_mm_masked"] > 0
        state = GraphState(*(t.cpu() for t in svc.ring.latest.state))
        am, _, alive = tq.dense_views(state)
        if not step:
            deg = (am & alive).sum(dim=1)
            assert ((deg == 0) & alive).any() and (~alive).any()
        delta, sigma, level, ok = tq.bc_batched_dense(
            am, torch.arange(1024, dtype=torch.int32), alive,
            use_kernel=False)
        slot = svc._bc_scores
        assert torch.equal(slot["level"].cpu(), level)
        assert torch.equal(slot["sigma"].cpu(), sigma)
        assert torch.equal(slot["ok"].cpu(), ok)
        want = torch.where(ok[:, None], delta, 0.0).sum(dim=0)
        want = torch.where(alive, want, float("nan"))
        np.testing.assert_allclose(scores.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, equal_nan=True)
    assert svc.bc_scores_stats["full"] == 1
    assert svc.bc_scores_stats["delta"] == 1


@pytest.mark.cuda
def test_cuda_async_front_end_bit_identical(cuda_device):
    """The front end on the card: the dispatcher's own stream, replies
    equal to sequential queries on both rungs, no pin left."""
    from repro_torch.core import PUTE
    from repro_torch.core.queries import bc_dependencies, bfs, sssp
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.serve import AsyncGraphService

    fresh = {"bfs": bfs, "sssp": sssp, "bc": bc_dependencies}
    svc = GraphService(load_rmat_graph(1024, 8192, seed=4, device="cuda"),
                       batch_size=8)
    srv = AsyncGraphService(svc, max_batch=16).start()
    try:
        assert srv._stream is not None
        for step in range(3):
            futs = [(k, s, srv.query_async(k, s)) for k in fresh
                    for s in range(0, 96, 8)]
            for k, s, f in futs:
                reply = f.result(timeout=300)
                exp = fresh[k](svc.ring.get(reply.version), s)
                assert all(torch.equal(a, b)
                           for a, b in zip(reply.result, exp)), (k, s, step)
            svc.submit_many([(PUTE, 8 * step + i, 3 * i, 1.0)
                             for i in range(8)])
    finally:
        srv.stop(timeout=300)
    assert srv.stats.batched_dispatches > 0
    assert svc.stats.delta > 0
    assert svc.ring.pinned_versions() == []


@pytest.mark.cuda
def test_cuda_direct_queries_race_the_front_end(cuda_device):
    """A client thread calls ``service.query`` on the default stream on
    the same keys the front end serves on its own stream, while commits
    land: the dispatcher reads a prior the client just stored only after
    that slot's event, so every reply of either path equals a fresh query
    at the version it names."""
    import threading

    from repro_torch.core import PUTE
    from repro_torch.core.queries import bc_dependencies, bfs, sssp
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.serve import AsyncGraphService

    fresh = {"bfs": bfs, "sssp": sssp, "bc": bc_dependencies}
    svc = GraphService(load_rmat_graph(1024, 8192, seed=5, device="cuda"),
                       ring_depth=8, batch_size=8)
    states = {0: svc.ring.latest.state}
    keys = [(k, s) for k in fresh for s in range(0, 64, 8)]
    replies, errs = [], []

    def direct():
        try:
            for k, s in keys:
                replies.append((k, s, svc.query(k, s)))
        except Exception as e:  # pragma: no cover - harness guard
            errs.append(e)

    srv = AsyncGraphService(svc, max_batch=16).start()
    try:
        futs = []
        for step in range(4):
            t = threading.Thread(target=direct)
            t.start()
            futs += [(k, s, srv.query_async(k, s)) for k, s in keys]
            svc.submit_many([(PUTE, 8 * step + i, 5 * i + 1, 1.0)
                             for i in range(8)])
            states[svc.version] = svc.ring.latest.state
            t.join(timeout=300)
            assert not t.is_alive(), "direct client hung"
        replies += [(k, s, f.result(timeout=300)) for k, s, f in futs]
    finally:
        srv.stop(timeout=300)
    assert not errs, errs
    for k, s, reply in replies:
        exp = fresh[k](states[reply.version], s)
        assert all(torch.equal(a, b) for a, b in zip(reply.result, exp)), \
            (k, s, reply.version, reply.mode)
    assert srv.stats.fallbacks == 0 and svc.stats.errors == 0
    assert svc.ring.pinned_versions() == []


@pytest.mark.cuda
@pytest.mark.parametrize("arch,batch", [("granite_moe_1b", 4),
                                        ("granite_moe_1b", 2),
                                        ("qwen3_32b", 4)])
def test_cuda_sharded_train_step_matches_one_process(cuda_device, arch,
                                                     batch):
    """Four processes on the card over gloo, a (2, 2) (data, model) mesh,
    three sharded steps of the reduced config (capacity 8: nothing drops)
    against one process's ``build_train_step`` on the card whose loss is
    the mean over the two data rows (the mesh's load-balance loss is a
    mean over rows): losses to rtol 1e-5, first moments to rtol 1e-4 and
    an atol of 1e-4 of each leaf's largest."""
    import lm_dist_ranks as lr
    import repro_torch.shard as ts
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.tree import tree_leaves, tree_map

    outs = ts.spawn(lr.port_train_case, 4, device="cuda:0", transport="gloo",
                    timeout=120, join_timeout=600, args=(arch, batch))
    cfg = lr.config(arch, 8.0 if "granite" in arch else None)
    model = lr.rows_mean_model(get_model(cfg), 2)
    p = tree_map(lambda t: t.to(cuda_device),
                 model.init(torch.Generator().manual_seed(0)))
    opt = adamw_init(p, cfg.moment_dtype)
    step = steps.build_train_step(model, **lr.TRAIN_KW)
    ds = SyntheticTokens(cfg.vocab_size, lr.SEQ, batch, seed=1)
    losses = []
    for i in range(3):
        p, opt, met = step(p, opt, shard_batch(ds.batch_at(i),
                                               device=cuda_device))
        losses.append(float(met["loss"]))
    for o in outs:
        assert o["losses"] == outs[0]["losses"]
        np.testing.assert_allclose(o["losses"], losses, rtol=1e-5)
        for g, e in zip(tree_leaves(o["m"]), tree_leaves(opt.m)):
            e = e.float().cpu().numpy()
            np.testing.assert_allclose(g.numpy(), e, rtol=1e-4,
                                       atol=1e-4 * np.abs(e).max())


@pytest.mark.cuda
def test_cuda_sharded_families_serving_matches_one_process(cuda_device):
    """Four processes on the card over gloo, a (2, 2) (data, model) mesh,
    serving reduced mamba2_780m and whisper_large_v3 (float32, flash
    path; the SSM state split over ``model``, Whisper's self and cross
    K/V split over the sequence): a prompt (Whisper's with frames), a
    continuation and four decode steps against one process's
    ``build_prefill_step`` / ``build_decode_step`` on the card on the same
    seed-0 parameters, logits and each process's cache block to rtol =
    atol = 1e-4; the model ranks of a data row bit-equal."""
    import lm_serve_ranks as sr
    import repro_torch.shard as ts

    cases = [dict(arch=a, impl="flash", batch=4, max_len=32, ref=a)
             for a in ("mamba2_780m", "whisper_large_v3")]
    feeds = [sr.family_feed(c["arch"], 4, 12, 8,
                            np.random.default_rng(3).integers(
                                1, 200, (4, 4)).astype(np.int32))
             for c in cases]
    outs = ts.spawn(sr.family_cases, 4, device="cuda:0", transport="gloo",
                    timeout=120, join_timeout=600, args=(cases, feeds))
    for i, (case, feed) in enumerate(zip(cases, feeds)):
        logits, cache = sr.family_one_process(case, None, feed,
                                              device=cuda_device)
        for o in outs:
            got = o[i]
            d = got["coords"]["data"]
            twin = next(p[i] for p in outs if p[i]["coords"]["data"] == d
                        and p[i] is not got)
            for g, t, w in zip(got["logits"], twin["logits"], logits):
                np.testing.assert_array_equal(g, t)
                np.testing.assert_allclose(g, w[2 * d:2 * d + 2],
                                           rtol=1e-4, atol=1e-4)
            for path, spec in got["specs"].items():
                if not path.endswith("/idx"):
                    np.testing.assert_allclose(
                        got["cache"][path],
                        sr.spec_block(cache[path], got["coords"], spec),
                        rtol=1e-4, atol=1e-4, err_msg=path)
