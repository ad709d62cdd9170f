"""Exporters: Prometheus text format, JSON-lines, Chrome trace_event.

Port of `repro.obs.export` (pure Python). Three render targets for one
run's registry + tracer:

  * `prometheus_text(registry)` — the Prometheus text exposition format
    (counters/gauges verbatim, histograms as cumulative ``_bucket{le=}``
    series plus ``_sum``/``_count``), scrape-ready. A minimal validating
    `parse_prometheus` lives here too so CI can assert the export stays
    well-formed without a prometheus client dependency.
  * `write_jsonl(path, registry, tracer)` — one JSON object per line:
    every metric as a ``{"type": "metric", ...}`` record, every trace
    event as ``{"type": "event", ...}`` — the grep/jq-friendly event
    log.
  * `chrome_trace(tracer)` / `write_chrome_trace(path, tracer)` — the
    Chrome ``trace_event`` JSON array format. Open the file in Perfetto
    (https://ui.perfetto.dev) or chrome://tracing to see every request's
    span laid out on its track.

All exporters are read-only over the registry/tracer state and safe to
call mid-run (a snapshot of the moment they run).
"""
from __future__ import annotations

import json
import re


def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _SANITIZE_RE.sub("_", name)
    if not name or not _NAME_RE.fullmatch(name):
        name = "_" + name
    return name


def _prom_labels(labels, extra=()) -> str:
    items = list(labels) + list(extra)
    if not items:
        return ""
    inner = ",".join(f'{_prom_name(str(k))}="{_escape_label(v)}"'
                     for k, v in items)
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def prometheus_text(registry) -> str:
    """Render a registry in the Prometheus text exposition format."""
    by_name: dict[tuple, list] = {}
    for kind, m in registry.metrics():
        by_name.setdefault((kind, _prom_name(m.name)), []).append(m)
    lines = []
    for (kind, name), metrics in by_name.items():
        lines.append(f"# TYPE {name} {kind}")
        for m in metrics:
            if kind in ("counter", "gauge"):
                lines.append(f"{name}{_prom_labels(m.labels)} "
                             f"{_fmt(m.value)}")
                continue
            # histogram: cumulative buckets at each occupied upper edge
            # (+ the zero bucket's edge) then +Inf, _sum, _count.
            cum = m.zero_count
            if m.zero_count:
                lines.append(f"{name}_bucket"
                             f"{_prom_labels(m.labels, [('le', '0')])}"
                             f" {cum}")
            for i in sorted(m.buckets):
                cum += m.buckets[i]
                le = _fmt(m.bucket_edge(i))
                lines.append(f"{name}_bucket"
                             f"{_prom_labels(m.labels, [('le', le)])}"
                             f" {cum}")
            lines.append(f"{name}_bucket"
                         f"{_prom_labels(m.labels, [('le', '+Inf')])}"
                         f" {m.count}")
            lines.append(f"{name}_sum{_prom_labels(m.labels)} "
                         f"{_fmt(m.total)}")
            lines.append(f"{name}_count{_prom_labels(m.labels)} {m.count}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict[str, list]:
    """Minimal validating parser for the text format this module emits.

    Returns {metric name -> [(labels dict, float value), ...]}. Raises
    ValueError on any malformed line, so a check can run the export
    through it and catch a formatting regression before a scraper does."""
    out: dict[str, list] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample on line {lineno}: {line!r}")
        raw = m.group("labels")
        labels = {}
        if raw:
            consumed = _LABEL_RE.findall(raw)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in consumed)
            if rebuilt != raw:
                raise ValueError(
                    f"malformed labels on line {lineno}: {raw!r}")
            labels = dict(consumed)
        val = m.group("value")
        value = float("inf") if val == "+Inf" else float(val)
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def metrics_jsonl_records(registry) -> list[dict]:
    records = []
    for kind, m in registry.metrics():
        rec = {"type": "metric", "kind": kind, "name": m.name,
               "labels": dict(m.labels)}
        if kind == "histogram":
            rec.update(m.summary())
        else:
            rec["value"] = m.value
        records.append(rec)
    return records


def trace_jsonl_records(tracer) -> list[dict]:
    records = []
    for e in tracer.spans():
        rec = {"type": "event", "name": e.name, "ph": e.ph, "ts": e.ts,
               "tid": e.tid}
        if e.dur is not None:
            rec["dur"] = e.dur
        if e.attrs:
            rec["attrs"] = e.attrs
        records.append(rec)
    return records


def write_jsonl(path: str, registry=None, tracer=None) -> int:
    """Write the metrics snapshot and/or trace events as JSON lines.

    Returns the number of records written."""
    records = []
    if registry is not None:
        records += metrics_jsonl_records(registry)
    if tracer is not None:
        records += trace_jsonl_records(tracer)
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return len(records)


def chrome_trace(tracer, *, pid: int = 0) -> dict:
    """Render a tracer as Chrome trace_event JSON (the object form).

    ts/dur are converted to MICROSECONDS per the format spec. Async
    B/E span pairs are emitted as duration begin/end events on
    ``tid = event.tid`` (e.g. a tenant id), so Perfetto lays each
    track's spans out on its own row."""
    events = []
    for e in tracer.spans():
        rec = {"name": e.name, "ph": e.ph, "ts": e.ts * 1e6, "pid": pid,
               "tid": e.tid, "args": dict(e.attrs)}
        if e.ph == "X":
            rec["dur"] = (e.dur or 0.0) * 1e6
        if e.ph == "i":
            rec["s"] = "t"
        events.append(rec)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer, *, pid: int = 0) -> int:
    """Write `chrome_trace` JSON to `path`; returns the event count."""
    doc = chrome_trace(tracer, pid=pid)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
