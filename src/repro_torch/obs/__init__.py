"""Observability layer: metrics registry, tracing, exporters.

Port of `repro.obs` (pure Python, no tensor code). The retrieval stack
publishes its exact analytic ledgers (stage bytes, µJ/query) and its
phase spans here. Host-side only, and zero-cost when disabled via
`NULL_REGISTRY` / `NULL_TRACER`. A span around work on the card measures
the launch unless the caller synchronizes inside it (see `tracing`).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     LabeledRegistry, MetricsRegistry,
                                     NullRegistry, NULL_REGISTRY)
from repro_torch.obs.tracing import (NullTracer, NULL_TRACER, TraceEvent,
                                     Tracer)
from repro_torch.obs.export import (chrome_trace, metrics_jsonl_records,
                                    parse_prometheus, prometheus_text,
                                    trace_jsonl_records, write_chrome_trace,
                                    write_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "LabeledRegistry", "MetricsRegistry",
    "NullRegistry",
    "NULL_REGISTRY", "NullTracer", "NULL_TRACER", "TraceEvent", "Tracer",
    "chrome_trace", "metrics_jsonl_records", "parse_prometheus",
    "prometheus_text", "trace_jsonl_records", "write_chrome_trace",
    "write_jsonl",
]
