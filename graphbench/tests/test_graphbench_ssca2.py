"""The SSCA#2 deployment's draws (``ssca2_s14``): the R-MAT arcs of
``generators/rmat_ssca2.py`` each kept once in the direction drawn, under
one permutation of the labels; integer weights in [1, 2^14]; the loader
keeping one arc of each key; the ``paper_churn`` stream keeping its four
shares and refusing shares that do not sum to 1; and the cell's graph and
first 64 batches at its own scale pinned by digest."""
import hashlib
import json
import os

import numpy as np
import pytest

import gb_tiny
from graphbench import graphs, spec, traffic


def _config(scale=14):
    with open(os.path.join(gb_tiny.ROOT, "graphbench", "configs",
                           "ssca2_s14.json")) as f:
        cfg = json.load(f)
    cfg.update(scale=scale)
    return cfg


def _updates():
    with open(os.path.join(gb_tiny.ROOT, "graphbench", "traffic",
                           "paper_churn.json")) as f:
        return json.load(f)["updates"]


class _Recording:
    """A generator that keeps what its ``permutation`` drew."""

    def __init__(self, rng):
        self._rng = rng
        self.perms = []

    def permutation(self, n):
        self.perms.append(self._rng.permutation(n))
        return self.perms[-1]

    def __getattr__(self, name):
        return getattr(self._rng, name)


@pytest.mark.parametrize("seed", [1, gb_tiny.SEED])
def test_ssca2_s14_draws_are_pinned(seed):
    """The cell's graph and first 64 batches, at its own scale."""
    cfg = _config()
    rngs = traffic.streams(seed, cfg["data_seed"])
    n, src, dst, w = graphs.draw(cfg, rngs.graph)
    assert n == 16384 and len(src) == 125321
    assert (src.dtype, dst.dtype, w.dtype) == (np.int32, np.int32,
                                               np.float32)
    digest = hashlib.sha256()
    for a in (src, dst, w):
        digest.update(a.tobytes())
    assert digest.hexdigest() == (
        "e943567cdbef7816545c4474fa2810df7f16ab068a176d05f9cab3b62c0f8545")
    p = _updates()
    base = traffic.hot_base(rngs.hot, n, p)
    batches = traffic.update_batches(rngs.updates, n, 64, p,
                                     graphs.weight_draw(cfg), base)
    assert hashlib.sha256(json.dumps(batches).encode()).hexdigest() == (
        "6f8bc77bf767957d25c8c34b072307a5fab47b10ee487a7890957294bfa18422")


def test_rmat_ssca2_keeps_each_arc_once_under_permuted_labels():
    cfg = _config(scale=10)
    gen = spec.load_module(gb_tiny.ROOT, "generators", "rmat_ssca2")
    rng = _Recording(np.random.default_rng(3))
    n, i, j, w = gen.draw(cfg, rng, graphs.weight_draw(cfg))
    assert n == 1024 and len(i) == len(j) == len(w) == 8 * 1024
    # one permutation of the labels, not the identity
    (perm,) = rng.perms
    assert np.array_equal(np.sort(perm), np.arange(n))
    assert not np.array_equal(perm, np.arange(n))
    # under it, R-MAT's skew: quadrant a (0.55) makes label 0 the largest
    # out- and in-degree, and arcs lean towards low labels
    inv = np.argsort(perm)
    assert np.bincount(inv[i], minlength=n).argmax() == 0
    assert np.bincount(inv[j], minlength=n).argmax() == 0
    assert (inv[i] < n // 2).mean() == pytest.approx(0.65, abs=0.02)
    # graphs.draw: the arcs as drawn, in one direction, self-loops dropped
    n2, src, dst, w2 = graphs.draw(cfg, np.random.default_rng(3))
    keep = i != j
    assert n2 == n and np.array_equal(src, i[keep])
    assert np.array_equal(dst, j[keep]) and np.array_equal(w2, w[keep])
    # a self-loop stays on the diagonal at every level: (a + d)^scale
    assert (~keep).mean() == pytest.approx(0.8 ** 10, rel=0.1)
    arcs = set(zip(src.tolist(), dst.tolist()))
    assert sum((v, u) not in arcs for u, v in arcs) > len(arcs) // 2


def test_int_1_16384_weights_are_exact_integers_in_range():
    cfg = _config()
    w = graphs.weight_draw(cfg)(np.random.default_rng(5), 200000)
    assert w.dtype == np.float32
    assert np.array_equal(w, np.round(w))
    assert w.min() == 1 and w.max() == 16384
    assert abs(w.mean() - 8192.5) < 50


def test_loader_keeps_one_arc_of_each_key():
    """Multi-arcs collapse to one, in the program's loader and in the
    reference alike."""
    from graphbench.reference.graph import Graph
    from repro_torch.core import from_edge_list
    from repro_torch.core.queries import live_edges

    cfg = _config(scale=7)
    n, src, dst, w = graphs.draw(cfg, np.random.default_rng(11))
    keys = set(zip(src.tolist(), dst.tolist()))
    assert len(keys) < len(src)         # some arcs were drawn twice
    state = from_edge_list(n, 2 * len(src), src, dst, w, device="cpu")
    assert int(live_edges(state).src.numel()) == len(keys)
    assert len(Graph(n, src, dst, w).weight) == len(keys)


def test_paper_churn_keeps_its_shares():
    cfg = _config()
    p = _updates()
    rng = np.random.default_rng(8)
    n = 1000
    batches = traffic.update_batches(rng, n, 400, p,
                                     graphs.weight_draw(cfg))
    assert all(len(b) == p["ops_per_batch"] for b in batches)
    ops = [op for b in batches for op in b]
    for kind, key in [(traffic.PUTV, "putv_share"),
                      (traffic.REMV, "remv_share"),
                      (traffic.PUTE, "pute_share"),
                      (traffic.REME, "reme_share")]:
        share = sum(op[0] == kind for op in ops) / len(ops)
        # 9600 ops: one standard error is 0.0044 at a share of 0.25
        assert abs(share - p[key]) < 0.02, key
    assert all(len(op) == 2 for op in ops
               if op[0] in (traffic.PUTV, traffic.REMV))
    # endpoints uniform over every vertex
    us = np.array([op[1] for op in ops])
    vs = np.array([op[2] for op in ops if op[0] in (traffic.PUTE,
                                                    traffic.REME)])
    for x in (us, vs):
        assert x.min() >= 0 and x.max() < n
        assert abs(x.mean() - (n - 1) / 2) < 20
        assert len(np.unique(x)) > 0.9 * n
    # inserted arcs weigh as the deployment's arcs do
    ws = np.array([op[3] for op in ops if op[0] == traffic.PUTE])
    assert np.array_equal(ws, np.round(ws))
    assert ws.min() >= 1 and ws.max() <= 16384


@pytest.mark.parametrize("shares", [(0.25, 0.25, 0.25, 0.3),
                                    (0.5, 0.5, 0.0, 0.1)])
def test_paper_churn_refuses_shares_that_do_not_sum_to_one(shares):
    p = dict(_updates(), **dict(zip(
        ("putv_share", "remv_share", "pute_share", "reme_share"), shares)))
    with pytest.raises(ValueError, match="sum to 1"):
        traffic.update_batches(np.random.default_rng(0), 64, 1, p,
                               graphs.weight_draw(_config()))
