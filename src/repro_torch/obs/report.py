"""Render a per-kind/per-mode summary table from JSONL trace file(s)
(port of ``repro.obs.report``, a near copy).

    PYTHONPATH=src python -m repro_torch.obs.report TRACE.jsonl [MORE.jsonl ...] \\
        [--check] [--require-modes unchanged,delta,full] [--format json]

Aggregates the ``span == "query"`` records a traced
``GraphService`` emitted: one row per
(service, kind, ladder mode) with query counts, wall-time quantiles,
device-time medians, validated counts, degraded counts, and mean
attributed collective bytes.  Multiple trace files (a rotated sink's
``trace.jsonl.N`` siblings, or per-process traces) are merged and sorted
by span id before aggregation.  ``--check`` turns the reader into a CI
gate: every completed query record must carry the full schema
(kind/version/mode/degraded/wall/device-time/collective-bytes/flops);
records that ended in an error (they carry an ``error`` field and no
version/mode to claim) are exempt from the field check but counted.
``--require-modes`` demands a non-empty row per named ladder mode;
``--require-degraded`` demands at least one degraded record (the
chaos-smoke job's proof the ladder actually exercised its bottom rung);
``--require-spans ladder_pinned`` demands each named span appear at
least once anywhere in the trace (the breaker-trip gate).
``--format json`` emits the summary rows as machine-readable JSON for
CI consumers (``--json`` is the legacy spelling).
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Sequence

from .metrics import quantile
from .trace import TRACE_SCHEMA

#: fields every completed query trace record must carry (the acceptance
#: schema); error-terminated records carry ``error`` instead.
QUERY_FIELDS = ("schema", "span", "wall_us", "kind", "version", "mode",
                "coll_bytes", "service", "degraded", "device_us", "flops")


def load(path: str) -> list:
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise SystemExit(f"{path}:{i + 1}: invalid JSON: {e}")
    return records


def load_many(paths: Sequence[str]) -> list:
    """Merge several trace files, sorted by span id (stable, so records
    from different tracers with colliding ids keep their file order)."""
    records = []
    for path in paths:
        records.extend(load(path))
    records.sort(key=lambda r: r.get("id", 0))
    return records


def query_records(records: list) -> list:
    return [r for r in records if r.get("span") == "query"]


def validate(records: list, require_modes=(),
             require_degraded: bool = False, require_spans=()) -> list:
    """Schema + coverage errors (empty list == valid)."""
    errors = []
    qrecs = query_records(records)
    if not qrecs:
        errors.append("no query records in trace")
    seen_spans = {r.get("span") for r in records}
    for span in require_spans:
        if span not in seen_spans:
            errors.append(f"required span {span!r} has no trace records "
                          f"(saw {sorted(s for s in seen_spans if s)})")
    for i, r in enumerate(qrecs):
        if "error" in r:
            # the query raised: no version/mode to claim, record is exempt
            continue
        missing = [f for f in QUERY_FIELDS if f not in r]
        if missing:
            errors.append(f"query record {i} missing fields: {missing}")
        elif r["schema"] != TRACE_SCHEMA:
            errors.append(f"query record {i}: schema {r['schema']} != "
                          f"{TRACE_SCHEMA}")
    seen_modes = {r.get("mode") for r in qrecs if "error" not in r}
    for mode in require_modes:
        if mode not in seen_modes:
            errors.append(f"required ladder mode {mode!r} has no query "
                          f"records (saw {sorted(m for m in seen_modes if m)})")
    if require_degraded and not any(r.get("degraded") for r in qrecs):
        errors.append("no degraded query records (ladder bottom rung "
                      "never exercised)")
    return errors


def summarize(records: list) -> list:
    """Rows of (service, kind, mode) aggregates over the query records."""
    groups = defaultdict(list)
    for r in query_records(records):
        groups[(r.get("service", "?"), r.get("kind", "?"),
                r.get("mode", "?"))].append(r)
    rows = []
    for (service, kind, mode), rs in sorted(groups.items()):
        walls = [r.get("wall_us", 0.0) for r in rs]
        devs = [r.get("device_us", 0.0) or 0.0 for r in rs]
        rows.append({
            "service": service, "kind": kind, "mode": mode,
            "queries": len(rs),
            "p50_us": round(quantile(walls, 0.50), 1),
            "p95_us": round(quantile(walls, 0.95), 1),
            "p99_us": round(quantile(walls, 0.99), 1),
            "device_p50_us": round(quantile(devs, 0.50), 1),
            "validated": sum(bool(r.get("validated")) for r in rs),
            "degraded": sum(bool(r.get("degraded")) for r in rs),
            "errors": sum("error" in r for r in rs),
            "coll_bytes_mean": round(
                sum(r.get("coll_bytes", 0) or 0 for r in rs) / len(rs)),
        })
    return rows


def render(rows: list) -> str:
    cols = ("service", "kind", "mode", "queries", "p50_us", "p95_us",
            "p99_us", "device_p50_us", "validated", "degraded", "errors",
            "coll_bytes_mean")
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) if rows
              else len(c) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols),
             "  ".join("-" * widths[c] for c in cols)]
    for r in rows:
        lines.append("  ".join(str(r[c]).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__.splitlines()[0])
    p.add_argument("traces", nargs="+",
                   help="JSONL trace file(s) (Tracer export); several are "
                        "merged and sorted by span id")
    p.add_argument("--check", action="store_true",
                   help="validate schema; non-zero exit on any error")
    p.add_argument("--require-modes", default="",
                   help="comma-separated ladder modes that must each have "
                        "at least one query record (implies --check)")
    p.add_argument("--require-degraded", action="store_true",
                   help="fail unless at least one query record is degraded "
                        "(implies --check)")
    p.add_argument("--require-spans", default="",
                   help="comma-separated span names that must each appear "
                        "at least once in the trace, e.g. ladder_pinned "
                        "(implies --check)")
    p.add_argument("--format", choices=("table", "json"), default="table",
                   help="summary output format (json = machine output "
                        "for CI)")
    p.add_argument("--json", action="store_true",
                   help="legacy alias for --format json")
    a = p.parse_args(argv)

    records = load_many(a.traces)
    rows = summarize(records)
    if a.json or a.format == "json":
        print(json.dumps(rows, indent=2))
    else:
        print(render(rows))

    require = tuple(m for m in a.require_modes.split(",") if m)
    require_spans = tuple(s for s in a.require_spans.split(",") if s)
    if a.check or require or a.require_degraded or require_spans:
        errors = validate(records, require_modes=require,
                          require_degraded=a.require_degraded,
                          require_spans=require_spans)
        if errors:
            for e in errors:
                print(f"CHECK FAIL: {e}", file=sys.stderr)
            return 1
        n = len(query_records(records))
        print(f"CHECK OK: {n} query records, {len(rows)} summary rows, "
              f"schema {TRACE_SCHEMA}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
