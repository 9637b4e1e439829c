"""Whole runs of ``ssca2_s14.paper_churn`` on the CPU at scale 7: a sound
run is correct and its control is not; and the timed path broken
underneath, in the paths only this deployment works, is not correct:

  * the backward sweep run against ``a`` and its grid ``amask`` instead of
    ``a^T`` and ``amask_t`` (an undirected graph cannot tell them apart);
  * a revived source left with its empty prior tree;
  * a dead vertex scored.

At scale 7 the 24 ops of a batch dirty more than the 5% of the 128
vertices under which a refresh takes the delta path, so the runs that
must reach it raise the service's threshold, as the 16384 vertices of
scale 14 do without it.  A fault may need some batches to show (a vertex
removed, then revived, then given arcs), so the faulted runs make a fixed
number of steps, whatever the load on the machine."""
import itertools
from types import SimpleNamespace

import pytest

import gb_tiny
from graphbench import check, harness, spec

CELL = "ssca2_s14.paper_churn"
SECONDS = 3.0
FAULT_STEPS = 24


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return gb_tiny.make_root(tmp_path_factory.mktemp("ssca2"))


@pytest.fixture
def delta_every_step(monkeypatch):
    from repro_torch.engine import service

    monkeypatch.setitem(service.DEFAULT_DIRTY_THRESHOLDS, "bc", 1.0)


@pytest.fixture
def fixed_steps(monkeypatch):
    """The refresh loop's clock advances ``SECONDS / FAULT_STEPS`` at each
    reading, so that the window closes after a fixed number of steps."""
    from graphbench import drivers

    ticks = itertools.count()
    monkeypatch.setattr(drivers, "time", SimpleNamespace(
        perf_counter=lambda: next(ticks) * SECONDS / FAULT_STEPS))


def _run(root, control=False):
    cell = spec.resolve(root, CELL)
    return cell, harness.run_cell(cell, gb_tiny.SEED, SECONDS, trace=False,
                                  device="cpu", control=control)


@pytest.mark.parametrize("threshold", ["configured", "delta_every_step"])
def test_sound_run_is_correct_and_the_control_is_not(root, threshold,
                                                     request):
    if threshold == "delta_every_step":
        request.getfixturevalue("delta_every_step")
    cell, out = _run(root, control=True)
    assert cell.config["directed"] is True
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "bc_refresh_ms"}
    assert out["attempted"] >= 2
    ok, _ = check.verdict(out["control"], cell.limits)
    assert not ok, out["control"]


def test_backward_sweep_against_a_instead_of_its_transpose(
        root, monkeypatch, delta_every_step, fixed_steps):
    import repro_torch.core.queries as q
    from repro_torch.core import semiring

    def untransposed(adj_mask, srcs, alive, use_kernel=None, amask=None,
                     tile=128, src_chunk=None, **warm):
        a = (adj_mask & alive[:, None] & alive[None, :]).float()
        mm = semiring.count_mm_against(a, use_kernel=use_kernel,
                                       amask=amask, tile=tile)
        return q.bc_batched_ops(mm, mm, srcs, alive, a.shape[0],
                                src_chunk=src_chunk, **warm)

    monkeypatch.setattr(q, "bc_batched_dense", untransposed)
    _, out = _run(root)
    assert out["attempted"] == FAULT_STEPS - 1
    assert not out["correct"]
    assert out["checks"]["bc_score_gap"]["value"] > 1e-3


def test_a_revived_source_left_with_its_empty_prior_tree(
        root, monkeypatch, delta_every_step, fixed_steps):
    """The sweep does not see that a source was revived: its empty prior
    row looks like a tree no dirty vertex touches, so the row stays empty
    for as long as the source lives, whatever arcs it gains."""
    import torch

    import repro_torch.core.queries as q

    orig = q.bc_sweep_ops

    def no_restart(fwd_mm, bwd_mm, srcs, alive, V, prior_level=None,
                   *args, **kw):
        if prior_level is not None:
            rows = torch.arange(srcs.shape[0], device=srcs.device)
            s = srcs.long()
            revived = alive[s] & (prior_level[rows, s] < 0)
            # the source at a level past every cut: not revived, not kept
            prior_level = prior_level.clone()
            prior_level[rows[revived], s[revived]] = V + 1
        return orig(fwd_mm, bwd_mm, srcs, alive, V, prior_level, *args,
                    **kw)

    monkeypatch.setattr(q, "bc_sweep_ops", no_restart)
    _, out = _run(root)
    assert out["attempted"] == FAULT_STEPS - 1
    assert not out["correct"]
    assert out["checks"]["bc_score_gap"]["value"] > 1e-3


def test_a_dead_vertex_scored(root, monkeypatch, delta_every_step,
                              fixed_steps):
    """The refresh takes every vertex for alive: dead ones are scored (and
    sourced) instead of answering NaN."""
    import torch

    from repro_torch.engine import service

    orig = service.dense_views_from_tiles

    def all_alive(state, view):
        adj_mask, w_dense, alive = orig(state, view)
        return adj_mask, w_dense, torch.ones_like(alive)

    monkeypatch.setattr(service, "dense_views_from_tiles", all_alive)
    _, out = _run(root)
    assert out["attempted"] == FAULT_STEPS - 1
    assert not out["correct"]
    assert out["checks"]["alive_mismatch"]["value"] > 0
