"""Post-fault service invariant checker (port of ``repro.resil.invariants``).

``verify_service`` inspects the port's graph service and
returns every violated invariant as a human-readable string — the empty
list is the pass.  The chaos harness runs it after every injected fault:
whatever an operation failure did, the *service* must still satisfy

  * **ring monotonicity** — the window holds consecutive versions, the
    latest is the newest, dirty masks are sized to their states;
  * **pin/parked consistency** — every parked entry is still pinned,
    never duplicated in the window, pin counts are positive;
  * **cache servability** — no result-cache slot claims a version newer
    than the ring latest (a slot *older* than the window is legal: it
    merely can't serve unchanged/delta/stale hits);
  * **stats conservation** — ``unchanged + delta + full == queries``
    (queries are counted only on collect success; degraded replies and
    errors tally separately) and the scheduler's
    ``ops_submitted == ops_committed + pending`` ledger;
  * **ring/scheduler agreement** — the ring version equals the number of
    batches the scheduler committed (commits are the only writers).

Checks are read-only and cheap (no device work), so tests can afford one
after every single injected fault.
"""
from __future__ import annotations

from typing import List

__all__ = ["assert_service_ok", "verify_service"]


def verify_service(svc) -> List[str]:
    """Every violated invariant of ``svc`` (see module docstring)."""
    problems: List[str] = []
    ring = svc.ring
    window = list(ring._window)

    # ----------------------------- ring ---------------------------------
    if not window:
        problems.append("ring window is empty")
        return problems
    for prev, cur in zip(window, window[1:]):
        if cur.version != prev.version + 1:
            problems.append(
                f"ring versions not consecutive: {prev.version} -> "
                f"{cur.version}")
    if ring.latest.version != window[-1].version:
        problems.append("ring.latest is not the newest window entry")
    if len(window) > ring.depth:
        problems.append(
            f"ring window {len(window)} exceeds depth {ring.depth}")
    for e in window:
        if e.dirty.shape[0] != e.state.vcap:
            problems.append(
                f"version {e.version}: dirty mask {e.dirty.shape[0]} != "
                f"vcap {e.state.vcap}")

    # ------------------------- pins / parked -----------------------------
    window_versions = {e.version for e in window}
    for v, count in ring._pins.items():
        if count < 1:
            problems.append(f"pin count {count} for version {v}")
    for v, entry in ring._parked.items():
        if v not in ring._pins:
            problems.append(f"parked version {v} has no pin")
        if v in window_versions:
            problems.append(f"parked version {v} also resident in window")
        if entry.version != v:
            problems.append(
                f"parked entry keyed {v} carries version {entry.version}")

    # ------------------------------ cache --------------------------------
    latest = ring.latest.version
    for key, slot in getattr(svc, "_cache", {}).items():
        if slot.version > latest:
            problems.append(
                f"cache slot {key} claims future version {slot.version} "
                f"(latest {latest})")
        if slot.version < 0:
            problems.append(f"cache slot {key} has version {slot.version}")
        if slot.result is None:
            problems.append(f"cache slot {key} holds no result")

    # ------------------------------ stats --------------------------------
    st = svc.stats
    if st.unchanged + st.delta + st.full != st.queries:
        problems.append(
            f"mode conservation broken: unchanged={st.unchanged} + "
            f"delta={st.delta} + full={st.full} != queries={st.queries}")
    if st.collects < st.queries:
        problems.append(
            f"collects {st.collects} < successful queries {st.queries}")
    for f in ("errors", "degraded", "retries"):
        v = getattr(st, f)
        if v < 0:
            problems.append(f"stats.{f} = {v} < 0")

    # ---------------------------- scheduler ------------------------------
    sched = svc.scheduler
    ss = sched.stats
    if ss.ops_submitted != ss.ops_committed + sched.pending():
        problems.append(
            f"op ledger broken: submitted={ss.ops_submitted} != "
            f"committed={ss.ops_committed} + pending={sched.pending()}")
    if ring.latest.version != ss.batches_committed:
        problems.append(
            f"ring version {ring.latest.version} != batches committed "
            f"{ss.batches_committed}")

    # ------------------------------ journal ------------------------------
    journal = getattr(sched, "journal", None)
    if journal is not None:
        if journal.depth != sched.pending():
            problems.append(
                f"journal depth {journal.depth} != scheduler pending "
                f"{sched.pending()} (write-ahead ledger out of step)")
        for f in ("rotations", "compactions", "segments_dropped"):
            v = getattr(journal, f, 0)
            if v < 0:
                problems.append(f"journal.{f} = {v} < 0")

    # ------------------------------ breaker ------------------------------
    breaker = getattr(svc, "breaker", None)
    if breaker is not None:
        snap = breaker.snapshot()
        valid = {breaker.CLOSED, breaker.OPEN, breaker.HALF_OPEN}
        for kind, state in snap["states"].items():
            if state not in valid:
                problems.append(
                    f"breaker[{kind}] in unknown state {state!r}")
        if snap["trips"] < 0 or snap["restores"] < 0:
            problems.append(
                f"breaker counters negative: trips={snap['trips']} "
                f"restores={snap['restores']}")
        if snap["restores"] > snap["trips"]:
            problems.append(
                f"breaker restored {snap['restores']} times but only "
                f"tripped {snap['trips']}")
        for kind, n in snap["consecutive_failures"].items():
            if not (0 <= n < breaker.fail_threshold):
                problems.append(
                    f"breaker[{kind}] consecutive failures {n} outside "
                    f"[0, {breaker.fail_threshold})")
    return problems


def assert_service_ok(svc) -> None:
    """Raise ``AssertionError`` listing every violated invariant."""
    problems = verify_service(svc)
    assert not problems, "; ".join(problems)
