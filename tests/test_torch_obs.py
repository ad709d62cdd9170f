"""The port's observability layer (`repro_torch.obs`) against the JAX
package's (`repro.obs`): the same metric and trace calls go into both, and
the snapshots, Prometheus text, JSON-lines records and Chrome traces
(under a simulated clock) must be equal, as must the errors they raise.
Then the retrieval ledgers: each package's `SchedulePlan.publish` and
`energy.observe_cost` into its own registry export the same text.
"""
import pytest

torch = pytest.importorskip("torch")

import itertools
import json
import math

import numpy as np

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.core import RetrievalConfig as JConfig
from repro.core import energy as jenergy
from repro.core import engine as jengine
from repro_torch.core import energy as tenergy
from repro_torch.core import engine as tengine
from repro_torch.core.retrieval import RetrievalConfig

BOTH = (jobs, tobs)


def _drive_registry(obs):
    """Every registry call the layer offers; returns what it exports."""
    r = obs.MetricsRegistry()
    c = r.counter("req", path="warm")
    c.inc()
    c.inc(4)
    r.inc("req", 2, path="cold")
    r.inc("bytes moved", 1.5)                      # sanitized name
    r.gauge("depth").set(7.0)
    r.set_gauge("hit_rate", 0.25, tier='l"1')      # escaped label
    rng = np.random.default_rng(5)
    h = r.histogram("lat", path="warm")
    for v in rng.lognormal(-2.0, 1.5, 300):
        h.observe(float(v))
    h.observe(0.0)
    h.observe(-1.0)
    h.observe(3.5, 7)
    coarse = r.histogram("coarse", buckets_per_doubling=4)
    for v in (0.001, 0.002, 0.002, 5.0, 1e6):
        coarse.observe(v)
    view = r.labeled(shard="3")
    view.inc("req", 3)
    view.labeled(replica="b").observe("lat", 0.5)
    view.set_gauge("depth", 2.0)
    other = obs.MetricsRegistry()
    other.counter("req", path="warm").inc(10)
    for v in rng.uniform(1e-6, 1e3, 50):
        other.histogram("lat", path="warm").observe(float(v))
    other.gauge("depth").set(9.0)
    r.merge(other)
    text = obs.prometheus_text(r)
    return dict(
        text=text, parsed=obs.parse_prometheus(text), snapshot=r.snapshot(),
        jsonl=obs.metrics_jsonl_records(r),
        percentiles=[(m.percentile(q), m.rel_error_bound) for kind, m
                     in r.metrics() if kind == "histogram"
                     for q in (0, 1, 25, 50, 90, 99, 100)],
        kinds=[(kind, m.name, m.labels) for kind, m in r.metrics()],
        view_get=view.get("counter", "req").value,
        view_snapshot=view.snapshot() == r.snapshot())


def test_registry_calls_export_identically():
    want, got = (_drive_registry(obs) for obs in BOTH)
    assert got == want
    assert "bytes_moved 1.5" in got["text"]


def _drive_tracer(obs, tmp_path, tag):
    ticks = itertools.count()
    tr = obs.Tracer(clock=lambda: next(ticks) * 0.001)
    with tr.span("ingest", tid=1, rows=512):       # the tracer's clock
        tr.instant("admit", tid=1, request=0)
    tr.begin("request", 0, now=0.5, tid=5, request=0)
    tr.begin("request", "r1", tid=6)
    with tr.span("flush", now=0.75, batch=4):      # simulated: dur 0
        pass
    tr.end("r1", launch=0)
    tr.end(0, now=1.25)
    reg = obs.MetricsRegistry()
    reg.counter("hits").inc(2)
    reg.histogram("lat").observe(0.5)
    n_chrome = obs.write_chrome_trace(str(tmp_path / f"{tag}.json"), tr,
                                      pid=2)
    n_jsonl = obs.write_jsonl(str(tmp_path / f"{tag}.jsonl"), registry=reg,
                              tracer=tr)
    return dict(
        chrome=obs.chrome_trace(tr, pid=2), jsonl=obs.trace_jsonl_records(tr),
        open=tr.open_spans(), len=len(tr), flush=len(tr.spans("flush")),
        counts=(n_chrome, n_jsonl),
        files=[(tmp_path / f"{tag}{ext}").read_bytes()
               for ext in (".json", ".jsonl")])


def test_tracer_under_a_simulated_clock_exports_identically(tmp_path):
    want = _drive_tracer(jobs, tmp_path, "ref")
    got = _drive_tracer(tobs, tmp_path, "port")
    assert got == want
    evs = got["chrome"]["traceEvents"]
    assert [e["ph"] for e in evs] == ["i", "X", "B", "B", "X", "E", "E"]
    # the span reads ticks 0 and 2 (the instant inside it read tick 1)
    assert evs[1]["dur"] == pytest.approx(2000.0)
    assert json.loads(got["files"][0])["traceEvents"] == evs


ERRORS = {
    "negative counter": lambda o: o.Counter("c").inc(-1),
    "nan observation": lambda o: o.Histogram("h").observe(float("nan")),
    "zero weight": lambda o: o.Histogram("h").observe(1.0, 0),
    "percentile past 100": lambda o: o.Histogram("h").percentile(101),
    "no buckets": lambda o: o.Histogram("h", buckets_per_doubling=0),
    "geometry mismatch": lambda o: o.Histogram("a").merge(
        o.Histogram("b", buckets_per_doubling=4)),
    "malformed sample": lambda o: o.parse_prometheus("not a metric line!"),
    "malformed labels": lambda o: o.parse_prometheus('m{a="1",,b="2"} 3'),
    "double begin": lambda o: [t := o.Tracer(), t.begin("r", 1, now=0.0),
                               t.begin("r", 1, now=1.0)],
    "orphan end": lambda o: o.Tracer().end(8, now=1.0),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_reference(case):
    raised = []
    for obs in BOTH:
        with pytest.raises((ValueError, KeyError)) as info:
            ERRORS[case](obs)
        raised.append(type(info.value))
    assert raised[0] is raised[1]


def test_null_objects_are_inert_in_both():
    for obs in BOTH:
        n, t = obs.NULL_REGISTRY, obs.NULL_TRACER
        assert not n.enabled and not t.enabled
        n.counter("x").inc(5)
        n.histogram("h").observe(1.0, 3)
        n.labeled(shard="1").gauge("g").set(2.0)
        assert n.metrics() == [] and n.get("counter", "x") is None
        assert n.snapshot() == {"counters": {}, "gauges": {},
                                "histograms": {}}
        assert math.isnan(n.histogram("h").percentile(50))
        t.begin("request", 1, now=0.0)
        t.end(2)
        with t.span("y"):
            pass
        assert t.open_spans() == [] and len(t) == 0
        assert obs.chrome_trace(t)["traceEvents"] == []
        assert obs.prometheus_text(n) == "\n"
    assert tobs.__all__ == jobs.__all__


@pytest.mark.parametrize("seed", range(4))
def test_percentiles_match_reference_on_random_samples(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.lognormal(0.0, 3.0, 400), np.zeros(seed * 7),
                           rng.uniform(0.999, 1.001, 50)])
    out = []
    for obs in BOTH:
        h = obs.Histogram("lat", buckets_per_doubling=4 + 4 * seed)
        for v in vals:
            h.observe(float(v))
        out.append((h.buckets, h.zero_count, h.count, h.total,
                    [h.percentile(q) for q in (1, 25, 50, 90, 99, 100)],
                    h.summary()))
    assert out[0] == out[1]


PLANS = [dict(kind="masked"), dict(kind="windowed", window=2048),
         dict(kind="cluster", num_clusters=64, view_rows=1024),
         dict(kind="cluster", num_clusters=64, view_rows=1024,
              prescreen_c0=256)]


def test_plan_publish_and_energy_observe_export_identically():
    texts = []
    for plan, energy, cfg_cls, obs in ((jengine.plan, jenergy, JConfig, jobs),
                                       (tengine.plan, tenergy,
                                        RetrievalConfig, tobs)):
        reg = obs.MetricsRegistry()
        for kw in PLANS:
            kw = dict(kw)
            cfg = cfg_cls(k=5, prescreen_c0=kw.pop("prescreen_c0", None))
            p = plan(cfg, num_docs=1 << 20, dim=512, batch=32, **kw)
            p.publish(reg)
            energy.observe_cost(
                reg, energy.cost_cascade(p.stages, 512, batch=p.batch),
                queries=32)
        texts.append(obs.prometheus_text(reg))
    assert texts[0] == texts[1]
    parsed = tobs.parse_prometheus(texts[1])
    assert {lab["stage"] for lab, _ in parsed["stage_bytes_hbm"]} == {
        "prune", "prescreen", "approx", "exact"}
