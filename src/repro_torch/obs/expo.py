"""OpenMetrics exposition of the telemetry registry (port of
``repro.obs.expo``, a near copy).

``MetricsRegistry.snapshot()`` is a JSON blob nobody scrapes; this module
renders the same instruments in the `OpenMetrics text format
<https://prometheus.io/docs/specs/om/open_metrics_spec/>`_ so a real
monitoring stack can watch a serving process:

  * counters become ``counter`` families (``<name>_total`` sample lines),
  * gauges become ``gauge`` families,
  * histograms become ``summary`` families (``{quantile="0.5|0.95|0.99"}``
    sample lines plus ``_count`` / ``_sum``) — the exact quantiles the
    registry's ``merged_quantiles`` gives, so a live scrape and an offline
    reading report the same numbers from the same surface;

plus the telemetry-internal tallies that live outside the registry (the
tracer's ``sink_errors`` / ``dropped`` / ``rotations``) and, when a
:class:`repro_torch.resil.OpJournal` is attached, the WAL depth (ops whose
commit barrier has not landed — the crash-loss exposure).

Serving: ``Telemetry.serve(port=...)`` (see ``obs/__init__``) runs
:class:`ExpoServer` — a stdlib ``http.server`` on a daemon thread that
renders a fresh exposition per ``GET /metrics``.  The services are
single-threaded and the render path only *reads* plain-python counters,
so a concurrent scrape can at worst see a torn-between-queries snapshot,
never corrupt one.

One-shot CLI (the offline twin of a live scrape)::

    PYTHONPATH=src python -m repro_torch.obs.expo TRACE.jsonl [...] \
        [--check] [--serve PORT]

rebuilds a registry from trace JSONL file(s) — ``query_wall_us`` /
``query_device_us`` histograms and the per-service query/degraded/error
counters — and prints (or serves) its exposition.

:func:`validate_openmetrics` is the line-format checker CI scrapes
through: TYPE/HELP present per family, counter samples suffixed
``_total``, label values correctly escaped, ``# EOF`` terminator.
"""
from __future__ import annotations

import argparse
import math
import re
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Tuple

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["CONTENT_TYPE", "ExpoServer", "render_openmetrics",
           "validate_openmetrics"]

#: the content type OpenMetrics scrapers negotiate for.
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

#: quantiles exposed per histogram — the same three the registry snapshot
#: reports its p50/p99 from.
QUANTILES = (0.5, 0.95, 0.99)

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

_HELP = {
    "service_queries": "Successful queries answered (one ladder rung each).",
    "service_unchanged": "Queries served by the unchanged shortcut.",
    "service_delta": "Queries served by the delta (poison+re-relax) path.",
    "service_full": "Queries served by a full recompute.",
    "service_errors": "Collect attempts that raised.",
    "service_degraded": "Stale-but-correct degraded replies served.",
    "service_retries": "Demoted re-collect attempts the resilience ladder ran.",
    "query_wall_us": "End-to-end query wall time in microseconds.",
    "query_device_us": "Per-query CUDA-event stream time in microseconds, "
                       "summed over collects; host gaps included.",
    "adaptive_dirty_threshold": "Current per-kind delta-vs-full crossover "
                                "threshold the ladder consults.",
    "adaptive_adjustments": "Threshold adjustments the controller applied.",
    "trace_sink_errors": "Trace records lost to a failing JSONL sink.",
    "trace_rotations": "Size-based rotations of the JSONL trace sink.",
    "trace_dropped": "In-memory trace records evicted by the bound.",
    "journal_depth": "Journaled ops not yet covered by a commit barrier.",
}


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _sanitize_name(name: str) -> str:
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _fmt_labels(labels: Iterable[Tuple[str, str]]) -> str:
    items = [f'{_sanitize_name(k)}="{_escape_label(v)}"' for k, v in labels]
    return "{" + ",".join(items) + "}" if items else ""


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


def render_openmetrics(registry: MetricsRegistry, *,
                       extra_counters: Optional[Dict[str, int]] = None,
                       extra_gauges: Optional[Dict[str, float]] = None) -> str:
    """The registry's instruments as one OpenMetrics exposition string.

    ``extra_counters`` / ``extra_gauges`` fold in label-less tallies that
    live outside the registry (tracer sink counters, journal depth) so
    the scrape is the *whole* telemetry surface, not just the registry.
    """
    families: Dict[str, List[object]] = {}
    kinds: Dict[str, str] = {}
    for inst in registry.instruments():
        name = _sanitize_name(inst.name)
        fam_kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "summary"}[type(inst)]
        prev = kinds.setdefault(name, fam_kind)
        if prev != fam_kind:
            # same family name with conflicting instrument kinds: expose
            # under a suffixed family rather than emit an invalid mix
            name = f"{name}_{fam_kind}"
            kinds.setdefault(name, fam_kind)
        families.setdefault(name, []).append(inst)
    for name, value in (extra_counters or {}).items():
        name = _sanitize_name(name)
        kinds[name] = "counter"
        families[name] = [Counter(name)]
        families[name][0].set(int(value))
    for name, value in (extra_gauges or {}).items():
        name = _sanitize_name(name)
        kinds[name] = "gauge"
        families[name] = [Gauge(name)]
        families[name][0].set(float(value))

    lines: List[str] = []
    for name in sorted(families):
        kind = kinds[name]
        help_text = _HELP.get(name, f"repro {kind} {name}.")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"# HELP {name} {_escape_help(help_text)}")
        for inst in families[name]:
            labels = tuple(getattr(inst, "labels", ()))
            if kind == "counter":
                lines.append(f"{name}_total{_fmt_labels(labels)} "
                             f"{_fmt_value(inst.value)}")
            elif kind == "gauge":
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_value(inst.value)}")
            else:
                qs = inst.quantiles(QUANTILES)
                if inst.count:
                    for q in QUANTILES:
                        ql = labels + (("quantile", str(q)),)
                        lines.append(f"{name}{_fmt_labels(ql)} "
                                     f"{_fmt_value(qs[q])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{inst.count}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(float(inst.total))}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def telemetry_exposition(telemetry, journal=None) -> str:
    """Render a :class:`repro_torch.obs.Telemetry` bundle (registry + the
    tracer's out-of-registry tallies + optional WAL depth)."""
    tracer = telemetry.tracer
    extra_counters = {
        "trace_sink_errors": tracer.sink_errors,
        "trace_rotations": tracer.rotations,
        "trace_dropped": tracer.dropped,
    }
    extra_gauges = {}
    if journal is not None:
        extra_gauges["journal_depth"] = journal.depth
        extra_counters["journal_ops_logged"] = journal.ops_logged
        extra_counters["journal_barriers_logged"] = journal.barriers_logged
    return render_openmetrics(telemetry.registry,
                              extra_counters=extra_counters,
                              extra_gauges=extra_gauges)


# ------------------------------- validation --------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{.*\})?"
    r" (?P<value>\S+)(?: \S+)?$")
_LABEL_ITEM_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_VALUE_RE = re.compile(r"^(NaN|[+-]?Inf|[+-]?\d+(\.\d+)?([eE][+-]?\d+)?)$")
_KINDS = ("counter", "gauge", "summary", "histogram", "info", "unknown")
_SUFFIXES = {"counter": ("_total", "_created"),
             "summary": ("", "_count", "_sum", "_created"),
             "histogram": ("_bucket", "_count", "_sum", "_created")}


def _family_of(sample_name: str, types: Dict[str, str]) -> Optional[str]:
    """Longest declared family whose allowed suffixes produce this name."""
    for fam in sorted(types, key=len, reverse=True):
        kind = types[fam]
        for suf in _SUFFIXES.get(kind, ("",)):
            if sample_name == fam + suf:
                return fam
    return None


def validate_openmetrics(text: str) -> List[str]:
    """Line-format errors in an exposition (empty list == valid).

    Checks the subset of the OpenMetrics spec a scraper trips on first:
    every sample belongs to a family declared by a preceding ``# TYPE``
    with a ``# HELP`` line, counters expose ``_total`` samples, label
    pairs parse with correct ``\\"``/``\\n``/``\\\\`` escaping, values
    are numbers, the exposition ends with ``# EOF``, and no family is
    declared twice.
    """
    errors: List[str] = []
    types: Dict[str, str] = {}
    helps: Dict[str, bool] = {}
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines = lines[:-1]
    if not lines or lines[-1] != "# EOF":
        errors.append("missing '# EOF' terminator")
    for i, line in enumerate(lines, 1):
        if not line:
            errors.append(f"line {i}: blank line")
            continue
        if line == "# EOF":
            if i != len(lines):
                errors.append(f"line {i}: '# EOF' before end of exposition")
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) != 4 or parts[3] not in _KINDS:
                errors.append(f"line {i}: malformed TYPE line: {line!r}")
                continue
            name = parts[2]
            if name in types:
                errors.append(f"line {i}: family {name!r} declared twice")
            types[name] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 4:
                errors.append(f"line {i}: malformed HELP line: {line!r}")
                continue
            helps[parts[2]] = True
            continue
        if line.startswith("#"):
            errors.append(f"line {i}: unknown comment {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            errors.append(f"line {i}: unparseable sample line: {line!r}")
            continue
        fam = _family_of(m.group("name"), types)
        if fam is None:
            # a bare counter-family name is the sharper diagnosis: the
            # writer forgot the mandatory _total sample suffix
            if types.get(m.group("name")) == "counter":
                errors.append(f"line {i}: counter sample "
                              f"{m.group('name')!r} must end with _total")
            else:
                errors.append(f"line {i}: sample {m.group('name')!r} has "
                              f"no preceding TYPE declaration")
        labels = m.group("labels")
        if labels is not None:
            body = labels[1:-1]
            consumed = _LABEL_ITEM_RE.sub("", body).replace(",", "")
            if consumed.strip():
                errors.append(f"line {i}: malformed labels {labels!r}")
            for lm in _LABEL_ITEM_RE.finditer(body):
                raw = lm.group(2)
                # an unescaped backslash or a raw newline cannot appear
                if re.search(r'(?<!\\)(?:\\\\)*\\(?![\\"n])', raw):
                    errors.append(f"line {i}: bad escape in label value "
                                  f"{raw!r}")
        if not _VALUE_RE.match(m.group("value")):
            errors.append(f"line {i}: non-numeric value "
                          f"{m.group('value')!r}")
    for fam in types:
        if fam not in helps:
            errors.append(f"family {fam!r} has TYPE but no HELP line")
    return errors


# --------------------------------- server ----------------------------------

class ExpoServer:
    """Scrape endpoint on a daemon thread: ``GET /metrics`` (or ``/``)
    renders a fresh exposition of the bound telemetry each request."""

    def __init__(self, telemetry, *, port: int = 0, host: str = "127.0.0.1",
                 journal=None):
        self.telemetry = telemetry
        self.journal = journal
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = telemetry_exposition(
                    outer.telemetry, outer.journal).encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-obs-expo", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------- CLI -----------------------------------

def registry_from_trace(records: list) -> MetricsRegistry:
    """Rebuild the scrape-facing registry a traced run would have fed.

    Query records become ``query_wall_us`` / ``query_device_us``
    histogram samples and per-service ``service_queries`` /
    ``service_degraded`` / ``service_errors`` counters — the same names,
    labels and quantile math as the live service, so the one-shot CLI and
    a live scrape expose identical surfaces.
    """
    reg = MetricsRegistry()
    for r in records:
        if r.get("span") != "query":
            continue
        service = r.get("service", "?")
        if "error" in r:
            reg.counter("service_errors", service=service).inc()
            continue
        kind, mode = r.get("kind", "?"), r.get("mode", "?")
        reg.histogram("query_wall_us", service=service, kind=kind,
                      mode=mode).observe(r.get("wall_us", 0.0))
        if r.get("device_us") is not None:
            reg.histogram("query_device_us", service=service, kind=kind,
                          mode=mode).observe(r["device_us"])
        if r.get("degraded"):
            reg.counter("service_degraded", service=service).inc()
        else:
            reg.counter("service_queries", service=service).inc()
    return reg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.expo",
        description="Render trace JSONL file(s) as an OpenMetrics "
                    "exposition (one-shot), optionally serving it.")
    p.add_argument("traces", nargs="+", help="JSONL trace file(s)")
    p.add_argument("--check", action="store_true",
                   help="validate the exposition line format; non-zero "
                        "exit on any error")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve the exposition on this port instead of "
                        "printing it (0 = ephemeral; blocks)")
    a = p.parse_args(argv)

    from . import Telemetry
    from .report import load_many
    records = load_many(a.traces)
    tel = Telemetry(registry=registry_from_trace(records), accountant=None)
    text = telemetry_exposition(tel)
    if a.check:
        errors = validate_openmetrics(text)
        if errors:
            for e in errors:
                print(f"EXPO FAIL: {e}", file=sys.stderr)
            return 1
    if a.serve is not None:
        srv = ExpoServer(tel, port=a.serve)
        print(f"serving {srv.url} "
              f"({len(records)} records)", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            srv.close()
        return 0
    print(text, end="")
    if a.check:
        print(f"EXPO OK: {len(text.splitlines())} lines", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
