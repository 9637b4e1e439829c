"""Port parity: the paper's Section 5 workload runner.

``repro_torch.bench.workload`` against ``benchmarks/workload.py`` (imported
from its directory, as ``examples/dynamic_analytics.py`` does) on the same
R-MAT graph and the same op stream: every (query, mode) run gives the same
query, collect and interrupt counts and the same per-query collects."""
import os
import sys

import numpy as np
import pytest

import repro_torch.bench.workload as twl
from repro_torch.kernels import bool_mm as tbool
from repro_torch.kernels import minplus_mm as tmin

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
import workload as jwl  # noqa: E402

N = 128
MIX = (0.4, 0.1, 0.5)  # the 40/10/50 mix of examples/dynamic_analytics.py


def test_make_ops_and_graph_match_reference():
    ops_j = jwl.make_ops(np.random.default_rng(3), 45, N, MIX)
    ops_t = twl.make_ops(np.random.default_rng(3), 45, N, MIX)
    assert ops_j == ops_t
    gj, gt = jwl.load_graph(N), twl.load_graph(N, device="cpu")
    for a, b in zip(gj, gt):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("query", ["bfs", "sssp", "bc"])
@pytest.mark.parametrize("mode", ["pgcn", "pgicn", "static"])
def test_run_mix_matches_reference(query, mode):
    seed = {"bfs": 0, "sssp": 1, "bc": 2}[query]
    ops = jwl.make_ops(np.random.default_rng(seed), 45, N, MIX)
    exp = jwl.run_mix(jwl.load_graph(N), ops, query, mode)
    tbool.reset_launches()
    tmin.reset_launches()
    got = twl.run_mix(twl.load_graph(N, device="cpu"), ops, query, mode)
    assert (got.queries, got.collects, got.interrupts, got.retries_hist) == (
        exp.queries, exp.collects, exp.interrupts, exp.retries_hist)
    assert got.queries > 0 and got.seconds > 0
    assert got.unvalidated == 0
    if mode == "pgcn":  # updates commit between collects
        assert got.interrupts > 0 and max(got.retries_hist) > 2
    # on the CPU the kernel modules run their plain versions: no launch
    assert sum(tbool.LAUNCHES.values()) + sum(tmin.LAUNCHES.values()) == 0
