"""Port parity: the boolean and min-plus products and their wrappers.

On the CPU the port's ``ops.bool_mm`` / ``ops.minplus_mm`` run the kernels'
plain versions (block for block, with the kernels' own skip); the
reference's ``repro.kernels.ops`` runs the Pallas kernels in interpret
mode, as ``tests/test_kernels.py`` does.  Both products are exact -- a
thresholded sum of {0,1} terms, and a min over single rounded adds -- so
every comparison here is bit for bit.  The CUDA kernels are compared with
these plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.semiring as jsem
import repro.kernels.ops as jops
import repro.kernels.ref as jref
import repro_torch.core.semiring as tsem
import repro_torch.kernels.bool_mm as tbool
import repro_torch.kernels.minplus_mm as tmin
import repro_torch.kernels.ops as tops

from test_kernels import _sparse_tiled, _tile_occ

BOOL_SHAPES = [(128, 128, 128), (70, 200, 130), (1, 512, 64), (256, 64, 256)]
MINPLUS_SHAPES = [(64, 64, 64), (50, 90, 70), (1, 128, 30), (130, 40, 260)]
MASKED = [
    (64, 256, 192, 64, 0.3),    # block-multiple shapes
    (70, 200, 130, 64, 0.25),   # non-128-multiple everything
    (33, 513, 129, 128, 0.2),   # off-by-one shapes, coarse tiles
    (16, 96, 96, 16, 0.0),      # fully empty right operand
    (16, 96, 96, 16, 1.0),      # fully dense occupancy (no skipping wins)
]


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(fn, *xs, **kw):
    return np.asarray(fn(*(jnp.asarray(x) for x in xs), **kw))


def _dist(rng, s, k, inf_frac):
    d = rng.random((s, k)).astype(np.float32)
    d[rng.random((s, k)) < inf_frac] = np.inf
    return d


@pytest.mark.parametrize("s,k,n", BOOL_SHAPES)
def test_bool_mm_equals_reference(s, k, n):
    rng = np.random.default_rng(s * 5 + n)
    f = (rng.random((s, k)) < 0.15).astype(np.float32)
    a = (rng.random((k, n)) < 0.08).astype(np.float32)
    got = tops.bool_mm(_t(f), _t(a)).numpy()
    assert got.shape == (s, n)
    assert np.array_equal(got, _j(jops.bool_mm, f, a))
    assert np.array_equal(got, ((f @ a) > 0).astype(np.float32))


@pytest.mark.parametrize("bm,bn,bk", [(32, 32, 32), (96, 96, 160),
                                      (64, 32, 80)])
def test_bool_mm_equals_reference_at_its_block_sweep(bm, bn, bk):
    rng = np.random.default_rng(bm + bn + bk)
    f = (rng.random((96, 160)) < 0.2).astype(np.float32)
    a = (rng.random((160, 96)) < 0.2).astype(np.float32)
    exp = _j(jops.bool_mm, f, a, bm=bm, bn=bn, bk=bk)
    assert np.array_equal(tops.bool_mm(_t(f), _t(a)).numpy(), exp)


@pytest.mark.parametrize("s,k,n", MINPLUS_SHAPES)
def test_minplus_mm_equals_reference(s, k, n):
    rng = np.random.default_rng(s + 7 * k)
    d = _dist(rng, s, k, 0.3)
    w = _dist(rng, k, n, 0.5)
    got = tops.minplus_mm(_t(d), _t(w)).numpy()
    assert got.shape == (s, n)
    assert np.array_equal(got, _j(jops.minplus_mm, d, w))
    assert np.array_equal(got, _j(jref.minplus_mm_ref, d, w))


def test_minplus_mm_negative_weights_and_all_inf():
    rng = np.random.default_rng(3)
    d = _dist(rng, 20, 48, 0.4) * 7 - 2
    w = (_dist(rng, 48, 33, 0.6) * 9 - 4).astype(np.float32)
    assert np.array_equal(tops.minplus_mm(_t(d), _t(w)).numpy(),
                          _j(jops.minplus_mm, d, w))
    dead = np.full((16, 32), np.inf, np.float32)
    out = tops.minplus_mm(_t(dead), _t(rng.random((32, 16)).astype(
        np.float32))).numpy()
    assert np.isposinf(out).all()


@pytest.mark.parametrize("s,k,n,tile,density", MASKED)
def test_masked_products_equal_reference(s, k, n, tile, density):
    rng = np.random.default_rng(hash((s, k, n, tile)) % 2**32)
    w = _sparse_tiled(k, n, tile, density, identity_inf=True, rng=rng)
    d = _dist(rng, s, k, 0.5)
    wmask = _tile_occ(w, tile, identity_inf=True)
    exp = _j(jops.minplus_mm, d, w, amask=wmask, tile=tile)
    got = tops.minplus_mm(_t(d), _t(w), amask=_t(wmask), tile=tile).numpy()
    assert np.array_equal(got, exp)
    assert np.array_equal(got, _j(jref.minplus_mm_ref, d, w))
    a = _sparse_tiled(k, n, tile, density, identity_inf=False, rng=rng)
    f = (rng.random((s, k)) < 0.15).astype(np.float32)
    amask = _tile_occ(a, tile, identity_inf=False)
    exp_b = _j(jops.bool_mm, f, a, amask=amask, tile=tile)
    got_b = tops.bool_mm(_t(f), _t(a), amask=_t(amask), tile=tile).numpy()
    assert np.array_equal(got_b, exp_b)
    assert np.array_equal(got_b, ((f @ a) > 0).astype(np.float32))
    # through the semiring layer: kernel route and plain route alike
    for uk in (None, True, False):
        assert np.array_equal(tsem.minplus_mm(
            _t(d), _t(w), use_kernel=uk, amask=_t(wmask), tile=tile).numpy(),
            exp), uk
        assert np.array_equal(tsem.bool_mm(
            _t(f), _t(a), use_kernel=uk, amask=_t(amask), tile=tile).numpy(),
            exp_b), uk


def test_masked_products_single_live_tile():
    """One live tile in a far corner: every other (slab, tile) pair is
    skipped, yet the corner's contribution survives."""
    tile, k, n, s = 32, 160, 160, 48
    w = np.full((k, n), np.inf, np.float32)
    w[128:160, 128:160] = 1.0
    d = np.full((s, k), np.inf, np.float32)
    d[:, 130] = 2.0
    wmask = _tile_occ(w, tile, identity_inf=True)
    assert int(np.asarray(wmask).sum()) == 1
    got = tops.minplus_mm(_t(d), _t(w), amask=_t(wmask), tile=tile).numpy()
    assert np.array_equal(got, _j(jops.minplus_mm, d, w, amask=wmask,
                                  tile=tile))
    assert (got[:, 128:160] == 3.0).all() and np.isposinf(got[:, :128]).all()
    a = np.isfinite(w).astype(np.float32)
    f = np.isfinite(d).astype(np.float32)
    amask = _tile_occ(a, tile, identity_inf=False)
    got_b = tops.bool_mm(_t(f), _t(a), amask=_t(amask), tile=tile).numpy()
    assert np.array_equal(got_b, _j(jops.bool_mm, f, a, amask=amask,
                                    tile=tile))
    assert (got_b[:, 128:160] == 1.0).all() and (got_b[:, :128] == 0).all()


def test_minplus_slab_of_zero_distances_is_not_skipped():
    """The min-plus slab mask tests ``isfinite``, not ``!= 0``: a slab that
    holds nothing but 0.0 distances (the value of an SSSP source) is live.
    Under ``!= 0`` it would be skipped and its contributions lost."""
    bm, bk = tmin.BM, tmin.BK
    tile, k, n, s = 16, 64, 64, bm
    rng = np.random.default_rng(0)
    w = _sparse_tiled(k, n, tile, 1.0, identity_inf=True, rng=rng)
    d = np.full((s, k), np.inf, np.float32)
    d[:, :bk] = 0.0  # the first (BM x BK) slab is all zeros
    wmask = _tile_occ(w, tile, identity_inf=True)
    got = tops.minplus_mm(_t(d), _t(w), amask=_t(wmask), tile=tile).numpy()
    assert np.array_equal(got, _j(jops.minplus_mm, d, w, amask=wmask,
                                  tile=tile))
    assert np.array_equal(got, _j(jref.minplus_mm_ref, d, w))
    assert np.isfinite(got).any()
    dp, _ = tops._pad2(_t(d), bm, bk, np.inf)
    assert tops._slab_mask(dp, bm, bk, torch.isfinite)[0, 0] == 1
    assert tops._slab_mask(dp, bm, bk, lambda v: v != 0)[0, 0] == 0


@pytest.mark.parametrize("mod,name,init", [(tbool, "bool_mm", 0.0),
                                           (tmin, "minplus_mm", np.inf)])
def test_masked_plain_skips_exactly_the_masked_blocks(mod, name, init):
    """The masked plain version is the kernel's function block for block:
    a (deliberately wrong) zero mask drops exactly those blocks, and a
    fully skipped output tile keeps the identity."""
    bm, bn, bk = mod.BM, mod.BN, mod.BK
    rng = np.random.default_rng(5)
    if name == "bool_mm":
        x = (rng.random((2 * bm, 3 * bk)) < 0.3).astype(np.float32)
        a = (rng.random((3 * bk, 2 * bn)) < 0.3).astype(np.float32)
    else:
        x = _dist(rng, 2 * bm, 3 * bk, 0.2)
        a = _dist(rng, 3 * bk, 2 * bn, 0.2)
    xmask = np.ones((2, 3), np.int32)
    amask = np.ones((3, 2), np.int32)
    xmask[1, 2] = 0
    amask[0, 1] = 0
    amask[1, 1] = amask[2, 1] = 0  # output column block 1 fully skipped
    exp = np.full((2 * bm, 2 * bn), init, np.float32)
    for i in range(2):
        for j in range(2):
            rows = slice(i * bm, (i + 1) * bm)
            cols = slice(j * bn, (j + 1) * bn)
            for kb in range(3):
                if xmask[i, kb] and amask[kb, j]:
                    ks = slice(kb * bk, (kb + 1) * bk)
                    if name == "bool_mm":
                        exp[rows, cols] += x[rows, ks] @ a[ks, cols]
                    else:
                        exp[rows, cols] = np.minimum(exp[rows, cols], np.min(
                            x[rows, ks, None] + a[None, ks, cols], axis=1))
    if name == "bool_mm":
        exp = (exp > 0).astype(np.float32)
    got = getattr(mod, f"{name}_masked")(_t(x), _t(a), _t(xmask), _t(amask))
    assert np.array_equal(got.numpy(), exp)
    assert (got[:, bn:] == init).all()
    assert mod.LAUNCHES == {name: 0, f"{name}_masked": 0}  # plain: no launch


@pytest.mark.parametrize("mod,name", [(tbool, "bool_mm"),
                                      (tmin, "minplus_mm")])
def test_raw_entry_points_guard_shapes(mod, name):
    bm, bn, bk = mod.BM, mod.BN, mod.BK
    x = torch.ones((bm + 2, bk))
    y = torch.ones((bk, bn))
    raw, raw_m = getattr(mod, name), getattr(mod, f"{name}_masked")
    with pytest.raises(ValueError, match="truncation"):
        raw(x, y)
    assert raw(x[:bm], y).shape == (bm, bn)
    with pytest.raises(ValueError, match="block grid"):
        raw_m(x[:bm], y, torch.ones((1, 1), dtype=torch.int32),
              torch.ones((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        raw(x[:bm].double(), y)
    with pytest.raises(ValueError, match="does not tile"):
        getattr(tops, name)(x, y, amask=torch.ones((3, 3)), tile=bk)


def test_semiring_dense_routes_agree_with_reference():
    """``semiring.bool_mm`` / ``minplus_mm`` without a mask, kernel route
    (the plain version on the CPU) and plain route, equal the reference's
    ``use_kernel=True`` Pallas path."""
    rng = np.random.default_rng(12)
    f = (rng.random((40, 100)) < 0.1).astype(np.float32)
    a = (rng.random((100, 70)) < 0.1).astype(np.float32)
    d = _dist(rng, 40, 100, 0.4)
    w = _dist(rng, 100, 70, 0.7)
    exp_b = _j(jsem.bool_mm, f, a, use_kernel=True)
    exp_m = _j(jsem.minplus_mm, d, w, use_kernel=True)
    for uk in (None, True, False):
        assert np.array_equal(tsem.bool_mm(_t(f), _t(a), use_kernel=uk)
                              .numpy(), exp_b), uk
        assert np.array_equal(tsem.minplus_mm(_t(d), _t(w), use_kernel=uk)
                              .numpy(), exp_m), uk
        prod = tsem.minplus_mm_against(_t(w), use_kernel=uk)
        assert np.array_equal(prod(_t(d)).numpy(), exp_m), uk


# Row counts across the min-plus row granule (BM = 8) and across the wide
# form's 128-row tile: one row (the static query), a granule and its
# neighbours, and the ragged row blocks on either side of 128.
GRANULE_ROWS = [1, 7, 8, 9, 127, 129, 136]


@pytest.mark.parametrize("m", GRANULE_ROWS)
def test_minplus_mm_row_counts_equal_reference(m):
    """``ops.minplus_mm`` dense and masked at row counts around the granule
    equal the Pallas kernels (interpret mode) bit for bit, negative weights
    included."""
    tile, k, n = 16, 80, 40
    rng = np.random.default_rng(100 + m)
    d = _dist(rng, m, k, 0.4) * 6 - 1
    w = _sparse_tiled(k, n, tile, 0.5, identity_inf=True, rng=rng)
    w = np.where(np.isfinite(w), w * 5 - 1, w).astype(np.float32)
    wmask = _tile_occ(w, tile, identity_inf=True)
    got = tops.minplus_mm(_t(d), _t(w)).numpy()
    assert got.shape == (m, n)
    assert np.array_equal(got, _j(jops.minplus_mm, d, w))
    got_m = tops.minplus_mm(_t(d), _t(w), amask=_t(wmask), tile=tile).numpy()
    assert np.array_equal(got_m, _j(jops.minplus_mm, d, w, amask=wmask,
                                    tile=tile))
    assert np.array_equal(got_m, got)


@pytest.mark.parametrize("granules", [2, 17])
def test_minplus_masked_plain_skips_per_row_granule(granules):
    """A (deliberately wrong) zero ``dmask`` entry drops exactly its own
    row granule's k-step, also where the granule shares a 128-row tile
    with live ones: the block grid is (BM = 8 rows, BK, BN)."""
    bm, bn, bk = tmin.BM, tmin.BN, tmin.BK
    m, kb_n, nb_n = granules * bm, 3, 2
    rng = np.random.default_rng(granules)
    x = _dist(rng, m, kb_n * bk, 0.2) * 4 - 1
    a = _dist(rng, kb_n * bk, nb_n * bn, 0.3)
    xmask = (rng.random((granules, kb_n)) < 0.6).astype(np.int32)
    amask = np.ones((kb_n, nb_n), np.int32)
    amask[2, 0] = 0
    exp = np.full((m, nb_n * bn), np.inf, np.float32)
    for g in range(granules):
        rows = slice(g * bm, (g + 1) * bm)
        for j in range(nb_n):
            cols = slice(j * bn, (j + 1) * bn)
            for kb in range(kb_n):
                if xmask[g, kb] and amask[kb, j]:
                    ks = slice(kb * bk, (kb + 1) * bk)
                    exp[rows, cols] = np.minimum(exp[rows, cols], np.min(
                        x[rows, ks, None] + a[None, ks, cols], axis=1))
    got = tmin.minplus_mm_masked(_t(x), _t(a), _t(xmask), _t(amask))
    assert np.array_equal(got.numpy(), exp)
    assert tmin.LAUNCHES == {"minplus_mm": 0, "minplus_mm_masked": 0}


@pytest.mark.parametrize("tile,density", [(32, 0.6), (128, 1.0), (16, 0.3)])
def test_minplus_live_blocks_keep_every_finite_weight(tile, density):
    """The mask that ``ops.minplus_mm_against`` narrows once per operand
    (coarsened tile occupancy AND the weights' own (BK, BN) blocks) never
    clears a block that holds a finite weight, clears the all-+inf blocks
    that the coarse occupancy keeps, and leaves the product the dense one."""
    bn, bk = tmin.BN, tmin.BK
    k, n = 160, 300
    rng = np.random.default_rng(tile)
    w = _sparse_tiled(k, n, tile, density, identity_inf=True, rng=rng)
    w[rng.random((k, n)) < 0.97] = np.inf  # sparse inside the live tiles
    w[bk:2 * bk] = np.inf  # a k-step of no edges inside live 32/128-tiles
    w[5, 7] = -3.0         # a lone negative weight
    wmask = _tile_occ(w, tile, identity_inf=True)
    wp, _ = tops._pad2(_t(w), bk, bn, np.inf)
    kp, np_ = wp.shape
    finite = np.isfinite(wp.numpy()).reshape(kp // bk, bk, np_ // bn, bn)
    has = finite.any(axis=(1, 3))
    live = tops.minplus_live_blocks(wp)
    assert live.dtype == torch.int32
    assert np.array_equal(live.numpy() != 0, has)
    coarse = tops._coarsen_mask(_t(wmask), tile, bk, kp // bk, bn, np_ // bn)
    narrowed = tops._minplus_exact(wp, coarse).numpy()
    assert (narrowed[has] != 0).all()
    assert (narrowed <= coarse.numpy()).all()
    if tile > bk:
        assert not narrowed[1].any() and coarse.numpy()[1].any()
    else:  # 16-tiles already give the k-steps exactly
        assert np.array_equal(narrowed, coarse.numpy())
    d = _dist(rng, 24, k, 0.3)
    prod = tops.minplus_mm_against(_t(w), amask=_t(wmask), tile=tile)
    assert np.array_equal(prod(_t(d)).numpy(), _j(jref.minplus_mm_ref, d, w))
