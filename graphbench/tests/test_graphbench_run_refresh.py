"""Whole runs of the refresh cell on the CPU at a tiny size: a sound run is
correct; the control, and the timed path broken underneath (a refresh that
returns its state unchanged, under the new version or under the old one it
is exact at, half of the sources left out and the rest counted double, one
score altered where it is produced), are not.  So is a sound run of a
directed deployment added as files (``gb_tiny.add_directed_cell``: a
directed R-MAT, integer weights, arc and vertex churn), and its control
is not."""
import pytest

import gb_tiny
from graphbench import check, harness, spec

SECONDS = 3.0      # two steps or more on a loaded CPU


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return gb_tiny.make_root(tmp_path_factory.mktemp("refresh"))


def _run(root, control=False):
    cell = spec.resolve(root, gb_tiny.cell_of_kind(root, "refresh_loop"))
    return cell, harness.run_cell(cell, gb_tiny.SEED, SECONDS, trace=False,
                                  device="cpu", control=control)


def test_sound_run_is_correct_and_the_control_is_not(root):
    cell, out = _run(root, control=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert out["attempted"] >= 2
    ok, _ = check.verdict(out["control"], cell.limits)
    assert not ok, out["control"]


def test_directed_cell_is_correct_and_its_control_is_not(tmp_path):
    root = gb_tiny.make_root(tmp_path)
    cell = spec.resolve(root, gb_tiny.add_directed_cell(root))
    out = harness.run_cell(cell, gb_tiny.SEED, SECONDS, trace=False,
                           device="cpu", control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2
    ok, _ = check.verdict(out["control"], cell.limits)
    assert not ok, out["control"]


def test_a_refresh_that_returns_its_state_unchanged(root, monkeypatch):
    from repro_torch.engine import GraphService

    orig = GraphService.bc_scores
    first = {}

    def stale(self, *a, **kw):
        scores, version = orig(self, *a, **kw)
        return first.setdefault(id(self), scores), version

    monkeypatch.setattr(GraphService, "bc_scores", stale)
    _, out = _run(root)
    assert not out["correct"]


def test_a_refresh_that_returns_the_previous_scores_and_version(root,
                                                               monkeypatch):
    from repro_torch.engine import GraphService

    orig = GraphService.bc_scores
    prev = {}

    def stale_pair(self, *a, **kw):
        fresh = orig(self, *a, **kw)
        out = prev.get(id(self), fresh)
        prev[id(self)] = fresh
        return out

    monkeypatch.setattr(GraphService, "bc_scores", stale_pair)
    _, out = _run(root)
    assert not out["correct"]
    assert out["checks"]["stale_refresh"]["value"] > 0
    # each step's scores are exact at the version they name
    assert out["checks"]["bc_score_gap"]["value"] <= 1e-3


def test_half_of_the_sources_left_out(root, monkeypatch):
    import repro_torch.core.queries as q

    orig = q.bc_batched_dense

    def halved(*a, **kw):
        delta, sigma, level, ok = orig(*a, **kw)
        delta = delta.clone()
        delta[1::2] = 0.0
        delta[0::2] *= 2.0
        return delta, sigma, level, ok

    monkeypatch.setattr(q, "bc_batched_dense", halved)
    _, out = _run(root)
    assert not out["correct"]


def test_a_score_altered_where_it_is_produced(root, monkeypatch):
    import torch
    from repro_torch.engine import GraphService

    orig = GraphService.bc_scores

    def altered(self, *a, **kw):
        scores, version = orig(self, *a, **kw)
        scores = scores.clone()
        top = int(torch.nan_to_num(scores, nan=-1.0).argmax())
        scores[top] *= 1.01
        return scores, version

    monkeypatch.setattr(GraphService, "bc_scores", altered)
    _, out = _run(root)
    assert not out["correct"]
