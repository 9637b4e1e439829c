"""The yardstick's arithmetic on synthetic inputs: the idle union and the
frozen work count of a counting product."""
import numpy as np
import pytest
import torch

import gb_tiny  # noqa: F401  (puts the repository on the path)
from graphbench import profiling, roofline, stats


def test_union_and_gaps():
    ivs = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.6), (4.0, 4.0)]
    assert stats.union_length(ivs) == pytest.approx(2.5)
    assert stats.gaps(ivs, 0.0, 5.0) == [(1.5, 2.0), (3.0, 5.0)]
    assert stats.union_length([]) == 0.0


def test_trace_busy_and_named_gaps():
    tr = profiling.Trace(2.0, [(0.0, 0.5, "k1"), (0.25, 0.75, "k2"),
                               (1.5, 2.5, "k3")],
                         [(0.8, 1.2, "commit")], untraced="idle")
    assert tr.busy_s == pytest.approx(1.25)      # clipped at the window
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(0.75)
    assert gaps[0][0] == "after k2; host: commit"
    assert tr.top_ops(2) == [["k3", 1.0], ["k1", 0.5]]


def _brute_pairs(x, a, bm, bn, bk):
    s_live = [[bool((x[i:i + bm, k:k + bk] != 0).any())
               for k in range(0, x.shape[1], bk)]
              for i in range(0, x.shape[0], bm)]
    a_live = [[bool((a[k:k + bk, j:j + bn] != 0).any())
               for j in range(0, a.shape[1], bn)]
              for k in range(0, a.shape[0], bk)]
    return sum(s_live[i][k] and a_live[k][j]
               for i in range(len(s_live)) for k in range(len(a_live))
               for j in range(len(a_live[0])))


@pytest.mark.parametrize("shape", [(128, 256, 192), (70, 100, 130)])
def test_product_work_counts_live_pairs_at_the_fixed_grain(shape):
    s, k, n = shape
    rng = np.random.default_rng(sum(shape))
    x = np.where(rng.random((s, k)) < 0.02, rng.integers(1, 5, (s, k)), 0)
    a = (rng.random((k, n)) < 0.01).astype(np.float32)
    xt = torch.tensor(x, dtype=torch.float32)
    at = torch.tensor(a)
    bm = min(roofline.WORK_BM, s)
    pairs = _brute_pairs(x, a, bm, roofline.WORK_BN, roofline.WORK_BK)
    ops, nbytes = roofline.pair_work(xt, at)
    assert ops == 2.0 * bm * roofline.WORK_BN * roofline.WORK_BK * pairs
    assert nbytes >= 4.0 * s * n
    # small integer counts: the split's hi piece alone is non-zero
    assert roofline.count_product_work(xt, at) == (ops, nbytes)


def test_product_work_does_not_follow_the_kernels_block_shape(monkeypatch):
    import repro_torch.kernels.count_mm as kc

    rng = np.random.default_rng(3)
    x = torch.tensor(np.where(rng.random((256, 256)) < 0.03, 1.0, 0.0),
                     dtype=torch.float32)
    a = torch.tensor((rng.random((256, 256)) < 0.02).astype(np.float32))
    before = roofline.count_product_work(x, a)
    for name in ("BM", "BN", "BK"):
        monkeypatch.setattr(kc, name, getattr(kc, name) * 2)
    assert roofline.count_product_work(x, a) == before


def test_truncation_split_is_exact_and_counts_each_live_piece():
    x = torch.tensor([[0.0, 1.0, 3.0, 2.0**24 - 1.0, 1.0 / 3.0]])
    hi, mid, lo = roofline.truncation_split(x)
    assert torch.equal(hi + mid + lo, x)
    a = torch.ones((5, 64))
    ops = roofline.count_product_work(x, a)[0]
    one = roofline.pair_work(x, a)[0]
    assert ops == 3 * one        # 2^24 - 1 needs all three pieces


def test_least_seconds_names_its_bound():
    t, by = roofline.least_seconds(989e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "ops")
    t, by = roofline.least_seconds(1.0, 3.35e12)
    assert (t, by) == (pytest.approx(1.0), "bytes")
