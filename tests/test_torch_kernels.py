"""Port parity: the counting-semiring product and its wrappers.

On the CPU the port's ``ops.count_mm`` runs the kernel's plain version; the
reference's ``repro.kernels.ops.count_mm`` runs the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` does.  Integer-valued inputs
must give equal results; float inputs agree to ``rtol = atol = 1e-5``
(float32 reassociation).  The CUDA kernel itself is compared with its
plain version on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.semiring as jsem
import repro.kernels.backend as jbackend
import repro.kernels.ops as jops
import repro_torch.core.semiring as tsem
import repro_torch.kernels.backend as tbackend
import repro_torch.kernels.count_mm as tcount
import repro_torch.kernels.ops as tops

from test_kernels import _sparse_tiled, _tile_occ

SHAPES = [(128, 128, 128), (70, 200, 130), (1, 512, 64), (256, 64, 256)]
MASKED = [
    (64, 256, 192, 64, 0.3),    # block-multiple shapes
    (70, 200, 130, 64, 0.25),   # non-128-multiple everything
    (33, 513, 129, 128, 0.2),   # off-by-one shapes, coarse tiles
    (16, 96, 96, 16, 0.0),      # fully empty adjacency
    (16, 96, 96, 16, 1.0),      # fully dense occupancy (no skipping wins)
]


def _t(x):
    return torch.tensor(np.asarray(x))


def _j_count(s, a, **kw):
    return np.asarray(jops.count_mm(jnp.asarray(s), jnp.asarray(a), **kw))


@pytest.mark.parametrize("s,k,n", SHAPES)
def test_count_mm_integer_equal(s, k, n):
    rng = np.random.default_rng(s * 7 + k)
    f = (rng.random((s, k)) * 4).astype(np.int32).astype(np.float32)
    a = (rng.random((k, n)) < 0.1).astype(np.float32)
    got = tops.count_mm(_t(f), _t(a)).numpy()
    assert got.shape == (s, n)
    assert np.array_equal(got, _j_count(f, a))  # integer counts: exact


@pytest.mark.parametrize("s,k,n", SHAPES)
def test_count_mm_float_close(s, k, n):
    rng = np.random.default_rng(s + 3 * n)
    f = rng.standard_normal((s, k)).astype(np.float32)
    a = rng.standard_normal((k, n)).astype(np.float32)
    np.testing.assert_allclose(tops.count_mm(_t(f), _t(a)).numpy(),
                               _j_count(f, a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,k,n,tile,density", MASKED)
def test_count_mm_masked_matches_reference(s, k, n, tile, density):
    rng = np.random.default_rng(hash((s, k, n, tile)) % 2**32)
    a = _sparse_tiled(k, n, tile, density, identity_inf=False, rng=rng)
    f = (rng.random((s, k)) < 0.15).astype(np.float32)
    amask = _tile_occ(a, tile, identity_inf=False)
    exp = _j_count(f, a, amask=amask, tile=tile)
    got = tops.count_mm(_t(f), _t(a), amask=_t(amask), tile=tile).numpy()
    assert np.array_equal(got, exp)
    assert np.array_equal(got, f @ a)  # {0,1} operands: exact in f32
    # and through the semiring layer, kernel route and plain route alike
    for uk in (None, True, False):
        got_s = tsem.count_mm(_t(f), _t(a), use_kernel=uk, amask=_t(amask),
                              tile=tile).numpy()
        assert np.array_equal(got_s, exp), uk


def test_count_mm_adversarial_single_tile():
    """One live tile in a far corner: every other (slab, tile) pair is
    skipped, yet the corner's contribution survives."""
    tile, k, n, s = 32, 160, 160, 48
    a = np.zeros((k, n), np.float32)
    a[128:160, 128:160] = 1.0
    f = np.zeros((s, k), np.float32)
    f[:, 130] = 2.0
    amask = _tile_occ(a, tile, identity_inf=False)
    assert int(np.asarray(amask).sum()) == 1
    got = tops.count_mm(_t(f), _t(a), amask=_t(amask), tile=tile).numpy()
    assert np.array_equal(got, _j_count(f, a, amask=amask, tile=tile))
    assert (got[:, 128:160] == 2.0).all() and (got[:, :128] == 0).all()


def test_masked_plain_skips_exactly_the_masked_blocks():
    """The plain version is the kernel's function block for block: a
    (deliberately wrong) zero mask drops exactly those blocks."""
    bm, bn, bk = tcount.BM, tcount.BN, tcount.BK
    rng = np.random.default_rng(2)
    s = rng.integers(0, 3, (2 * bm, 3 * bk)).astype(np.float32)
    a = rng.integers(0, 2, (3 * bk, 2 * bn)).astype(np.float32)
    smask = np.ones((2, 3), np.int32)
    amask = np.ones((3, 2), np.int32)
    smask[1, 2] = 0
    amask[0, 1] = 0
    exp = np.zeros((2 * bm, 2 * bn), np.float32)
    for i in range(2):
        for j in range(2):
            for kb in range(3):
                if smask[i, kb] and amask[kb, j]:
                    rows = slice(i * bm, (i + 1) * bm)
                    cols = slice(j * bn, (j + 1) * bn)
                    ks = slice(kb * bk, (kb + 1) * bk)
                    exp[rows, cols] += s[rows, ks] @ a[ks, cols]
    got = tcount.count_mm_masked(_t(s), _t(a), _t(smask), _t(amask))
    assert np.array_equal(got.numpy(), exp)
    assert tcount.LAUNCHES == {"count_mm": 0, "count_mm_masked": 0}


@pytest.mark.parametrize("blocks", [(32, 64), (64, 32), (128, 128), (96, 48)])
def test_coarsen_and_slab_masks_match_reference(blocks):
    blk_r, blk_c = blocks
    rng = np.random.default_rng(blk_r + blk_c)
    tile = 64
    occ = (rng.random((5, 4)) < 0.4).astype(np.int32) * rng.integers(1, 9)
    nbr, nbc = -(-5 * tile // blk_r), -(-4 * tile // blk_c)
    exp = np.asarray(jops._coarsen_mask(jnp.asarray(occ), tile, blk_r, nbr,
                                        blk_c, nbc))
    got = tops._coarsen_mask(_t(occ), tile, blk_r, nbr, blk_c, nbc).numpy()
    assert np.array_equal(got, exp)
    x = (rng.random((4 * blk_r, 3 * blk_c)) < 0.05).astype(np.float32)
    exp_s = np.asarray(jops._slab_mask(jnp.asarray(x), blk_r, blk_c,
                                       lambda v: v != 0))
    assert np.array_equal(tops._slab_mask(_t(x), blk_r, blk_c,
                                          lambda v: v != 0).numpy(),
                          exp_s)


def test_guards_raise_the_reference_errors():
    def msg(fn, *args):
        with pytest.raises(ValueError) as e:
            fn(*args)
        return str(e.value).replace("repro_torch.", "repro.")

    args = ("count_mm", 130, 64, 64, 128, 64, 64)
    assert msg(tbackend.check_blocks, *args) == msg(jbackend.check_blocks,
                                                    *args)
    args = ("count_mm", (3, 2), 200, 130, 64)
    assert msg(tbackend.check_amask, *args) == msg(jbackend.check_amask,
                                                   *args)
    x = torch.ones((130, 64))
    y = torch.ones((64, 128))  # one block of the kernel (128 x 128 x 64)
    with pytest.raises(ValueError, match="truncation"):
        tcount.count_mm(x, y)
    assert tcount.count_mm(x[:128], y).shape == (128, 128)
    with pytest.raises(ValueError, match="block grid"):
        tcount.count_mm_masked(x[:128], y, torch.ones((1, 1), dtype=torch.int32),
                               torch.ones((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="does not tile"):
        tops.count_mm(x, y, amask=torch.ones((3, 3)), tile=64)


def test_semiring_plain_products_match_reference():
    """The plain bool/min-plus/count products (masked and dense), which the
    port keeps for tests and comparisons, equal the reference's."""
    rng = np.random.default_rng(9)
    tile, k, n, s = 16, 96, 80, 24
    w = _sparse_tiled(k, n, tile, 0.3, identity_inf=True, rng=rng)
    d = rng.random((s, k)).astype(np.float32)
    d[rng.random((s, k)) < 0.3] = np.inf
    wmask = _tile_occ(w, tile, identity_inf=True)
    for am in (None, wmask):
        kw = {} if am is None else {"amask": am, "tile": tile}
        exp = np.asarray(jsem.minplus_mm(jnp.asarray(d), jnp.asarray(w), **kw))
        tkw = {} if am is None else {"amask": _t(am), "tile": tile}
        got = tsem.minplus_mm(_t(d), _t(w), use_kernel=False, **tkw).numpy()
        assert np.array_equal(got, exp)
    a = _sparse_tiled(k, n, tile, 0.3, identity_inf=False, rng=rng)
    f = (rng.random((s, k)) < 0.2).astype(np.float32)
    amask = _tile_occ(a, tile, identity_inf=False)
    for am in (None, amask):
        kw = {} if am is None else {"amask": am, "tile": tile}
        tkw = {} if am is None else {"amask": _t(am), "tile": tile}
        for jf, tf in ((jsem.bool_mm, tsem.bool_mm),
                       (jsem.count_mm, tsem.count_mm)):
            exp = np.asarray(jf(jnp.asarray(f), jnp.asarray(a), **kw))
            got = tf(_t(f), _t(a), use_kernel=False, **tkw).numpy()
            assert np.array_equal(got, exp), jf.__name__


def test_plain_oracles_match_reference():
    import repro.kernels.ref as jref
    import repro_torch.kernels.ref as tref

    rng = np.random.default_rng(4)
    f = (rng.random((24, 40)) < 0.2).astype(np.float32)
    a = (rng.random((40, 32)) < 0.2).astype(np.float32)
    d = rng.random((24, 40)).astype(np.float32)
    d[rng.random((24, 40)) < 0.3] = np.inf
    for jf, tf, x in ((jref.bool_mm_ref, tref.bool_mm_ref, f),
                      (jref.count_mm_ref, tref.count_mm_ref, f),
                      (jref.minplus_mm_ref, tref.minplus_mm_ref, d)):
        exp = np.asarray(jf(jnp.asarray(x), jnp.asarray(a)))
        assert np.array_equal(tf(_t(x), _t(a)).numpy(), exp), jf.__name__


# (s, k, n, mask): ragged shapes on both sides of the kernel's blocks, the
# occupancy grid all set, all clear, or the adjacency's own
AGAINST = [(70, 200, 130, "all live"), (70, 200, 130, "all dead"),
           (129, 65, 257, "occupancy"), (1, 513, 64, "all live"),
           (200, 64, 1, "occupancy"), (33, 300, 129, "all dead")]


@pytest.mark.parametrize("s,k,n,mask", AGAINST)
def test_count_mm_against_masked_equals_the_product(s, k, n, mask):
    """``ops.count_mm_against(a, amask=...)`` hands the masked entry point
    no left mask (the kernel's split finds it): on the CPU the product
    still equals ``x @ a`` on integers, with whole row and column blocks
    of zeros in ``x``, and is zeros where the mask is all dead."""
    rng = np.random.default_rng(s * k + n)
    x = rng.integers(0, 4, (s, k)).astype(np.float32)
    x[:, k // 3: 2 * k // 3] = 0.0
    x[s // 2:] *= -1.0                       # some -0 entries
    a = (rng.random((k, n)) < 0.2).astype(np.float32)
    tile = 64
    occ = _tile_occ(a, tile, False)
    amask = {"all live": np.ones_like(occ), "all dead": np.zeros_like(occ),
             "occupancy": occ}[mask]
    before = dict(tcount.LAUNCHES)
    got = tops.count_mm_against(_t(a), amask=_t(amask), tile=tile)(_t(x))
    exp = np.zeros((s, n), np.float32) if mask == "all dead" else x @ a
    assert got.shape == (s, n)
    assert np.array_equal(got.numpy(), exp)
    assert tcount.LAUNCHES == before          # the plain version: no launch


def test_count_mm_masked_without_a_left_mask_takes_the_slabs_own():
    """``count_mm_masked(s, a, None, amask)`` equals the masked plain
    version under ``split_flags(s)[2]``, which is ``ops._slab_mask``."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, 3, (256, 192)).astype(np.float32)
    s[:128, 64:128] = 0.0
    s[128:, :64] = -0.0
    a = (rng.random((192, 128)) < 0.3).astype(np.float32)
    am = torch.ones((3, 1), dtype=torch.int32)
    own = tcount.split_flags(_t(s))[2]
    assert torch.equal(own, tops._slab_mask(_t(s), 128, 64, tops._nonzero))
    assert own[0, 1] == 0 and own[1, 0] == 0
    got = tcount.count_mm_masked(_t(s), _t(a), None, am)
    assert torch.equal(got, tcount.count_mm_masked_plain(_t(s), _t(a), own,
                                                         am))
    assert np.array_equal(got.numpy(), s @ a)
