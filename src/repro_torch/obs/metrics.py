"""Metrics substrate: counters, gauges, log-bucketed histograms, registry.

Port of `repro.obs.metrics` (pure Python; it touches no tensor). The
retrieval stack's observables are exact analytic ledgers (SchedulePlan
stage bytes, energy.cost_cascade pJ); this module is what they publish
into:

  * `Counter` / `Gauge` — monotone totals and last-value samples.
  * `Histogram`        — LOG-BUCKETED distribution with exact counts:
    bucket edges are ``2 ** (i / buckets_per_doubling)``, so any
    reported percentile is the geometric midpoint of the bucket holding
    the exact order statistic and is within a documented RELATIVE error
    bound of it (``rel_error_bound = 2 ** (1 / (2*bpd)) - 1``, ~2.2% at
    the default 16 buckets per doubling) regardless of the value range —
    no a-priori min/max, storage is a sparse dict keyed by bucket index.
  * `MetricsRegistry`  — get-or-create by (name, labels); callers on hot
    paths hold the returned metric object so a publish is one int add.
  * `NullRegistry`     — the disabled layer: same API, every operation a
    no-op, `enabled` False so instrumentation blocks can skip derived
    work (plan publishing, energy pricing) entirely.

Overhead contract: everything here is host-side Python on either side of
a launch. Nothing reads a device tensor, so publishing never synchronizes
with the card and never changes what the kernels compute.

Registries MERGE: ``a.merge(b)`` accumulates counters, bucket counts and
gauge last-writes, so per-worker registries can be combined into one
fleet view; percentiles depend only on integer bucket counts, so merging
is order-independent (associative/commutative) for every reported
quantile. Single-threaded by design; no locks are taken.
"""
from __future__ import annotations

import math


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _format_name(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """A monotonically increasing total (resettable for windowed reads)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Counter({_format_name(self.name, self.labels)}={self.value})"


class Gauge:
    """A last-value sample (queue depth, hit rate, bytes resident)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0.0

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Gauge({_format_name(self.name, self.labels)}={self.value})"


class Histogram:
    """Log-bucketed distribution with exact counts and bounded-error
    percentiles.

    Bucket i covers ``[2**(i/bpd), 2**((i+1)/bpd))`` with representative
    value ``2**((i+0.5)/bpd)`` (the geometric midpoint), where bpd =
    `buckets_per_doubling`. `percentile(q)` locates the bucket holding
    the exact rank-``ceil(q/100 * count)`` order statistic by cumulative
    count and returns its representative, so the reported value is
    within `rel_error_bound` of the exact order statistic for any value
    distribution. Non-positive observations land in a dedicated zero
    bucket (reported exactly as 0.0) so simulated-clock durations of
    zero stay exact.
    """

    __slots__ = ("name", "labels", "buckets_per_doubling", "buckets",
                 "count", "total", "zero_count", "min", "max")

    def __init__(self, name: str, labels: tuple = (), *,
                 buckets_per_doubling: int = 16):
        if buckets_per_doubling < 1:
            raise ValueError("buckets_per_doubling must be >= 1")
        self.name = name
        self.labels = labels
        self.buckets_per_doubling = buckets_per_doubling
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.zero_count = 0
        self.min = math.inf
        self.max = -math.inf

    @property
    def rel_error_bound(self) -> float:
        """Max relative error of any reported percentile vs the exact
        order statistic (geometric-midpoint representative of a
        ``2**(1/bpd)``-growth bucket)."""
        return 2.0 ** (1.0 / (2 * self.buckets_per_doubling)) - 1.0

    def observe(self, v: float, n: int = 1) -> None:
        """Record value `v`; `n` > 1 records it as n identical samples
        (one launch pricing a per-query cost for a batch of n)."""
        v = float(v)
        if math.isnan(v):
            raise ValueError(f"histogram {self.name}: NaN observation")
        if n < 1:
            raise ValueError(f"histogram {self.name}: n must be >= 1")
        self.count += n
        self.total += v * n
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= 0.0:
            self.zero_count += n
            return
        i = math.floor(math.log2(v) * self.buckets_per_doubling)
        self.buckets[i] = self.buckets.get(i, 0) + n

    def bucket_edge(self, i: int) -> float:
        """Upper edge of bucket i (Prometheus `le` boundary)."""
        return 2.0 ** ((i + 1) / self.buckets_per_doubling)

    def bucket_rep(self, i: int) -> float:
        """Representative (geometric midpoint) of bucket i."""
        return 2.0 ** ((i + 0.5) / self.buckets_per_doubling)

    def percentile(self, q: float) -> float:
        """Bounded-relative-error estimate of the q-th percentile.

        Returns the representative of the bucket holding the exact
        rank-``max(1, ceil(q/100 * count))`` order statistic (NaN on an
        empty histogram)."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        if self.count == 0:
            return math.nan
        rank = max(1, math.ceil(q / 100.0 * self.count))
        if rank <= self.zero_count:
            return 0.0
        cum = self.zero_count
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= rank:
                return self.bucket_rep(i)
        return self.bucket_rep(max(self.buckets))   # fp-rounding guard

    def percentiles(self, qs=(50, 95, 99)) -> dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}

    def merge(self, other: "Histogram") -> None:
        """Accumulate another histogram's counts into this one.

        Bucket counts are integers, so merge order can never change any
        reported percentile (associative + commutative)."""
        if other.buckets_per_doubling != self.buckets_per_doubling:
            raise ValueError("cannot merge histograms with different "
                             "bucket geometry")
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        self.count += other.count
        self.total += other.total
        self.zero_count += other.zero_count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def reset(self) -> None:
        self.buckets.clear()
        self.count = 0
        self.total = 0.0
        self.zero_count = 0
        self.min = math.inf
        self.max = -math.inf

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.total}
        if self.count:
            out.update(min=self.min, max=self.max,
                       mean=self.total / self.count,
                       **self.percentiles())
        return out

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Histogram({_format_name(self.name, self.labels)}, "
                f"count={self.count})")


class MetricsRegistry:
    """Get-or-create home for every metric, keyed (name, sorted labels).

    One registry per serving process (or per window — registries merge).
    Hot-path callers fetch their metric objects ONCE and hold them; the
    per-event cost is then a single int/float update with no dict
    lookup. `enabled` is True so instrumentation blocks that derive
    values (plan publishing, energy pricing) run; the `NullRegistry`
    counterpart turns the whole layer off.
    """

    enabled = True

    def __init__(self):
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}

    def _get(self, kind: str, cls, name: str, labels: dict, **kw):
        key = (kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[2], **kw)
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, *, buckets_per_doubling: int = 16,
                  **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels,
                         buckets_per_doubling=buckets_per_doubling)

    # -- convenience one-shots (cold paths; hot paths hold the object) ----

    def inc(self, name: str, n: int | float = 1, **labels) -> None:
        self.counter(name, **labels).inc(n)

    def set_gauge(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        self.histogram(name, **labels).observe(v)

    # -- introspection ----------------------------------------------------

    def metrics(self):
        """(kind, metric) pairs in insertion order."""
        return [(k[0], m) for k, m in self._metrics.items()]

    def get(self, kind: str, name: str, **labels):
        """The metric if it exists, else None (never creates)."""
        return self._metrics.get((kind, name, _label_key(labels)))

    def snapshot(self) -> dict:
        """Plain-data view of every metric (JSON-ready)."""
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for (kind, name, labels), m in self._metrics.items():
            key = _format_name(name, labels)
            if kind == "counter":
                out["counters"][key] = m.value
            elif kind == "gauge":
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.summary()
        return out

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Accumulate another registry into this one (see module doc:
        associative for counters and every histogram percentile; gauges
        take the other registry's last write). Returns self."""
        for key, m in other._metrics.items():
            kind, name, labels = key
            mine = self._metrics.get(key)
            if mine is None:
                kw = ({"buckets_per_doubling": m.buckets_per_doubling}
                      if kind == "histogram" else {})
                mine = type(m)(name, labels, **kw)
                self._metrics[key] = mine
            if kind == "counter":
                mine.inc(m.value)
            elif kind == "gauge":
                mine.set(m.value)
            else:
                mine.merge(m)
        return self

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    def labeled(self, **labels) -> "LabeledRegistry":
        """A view of this registry that stamps `labels` onto every metric
        it creates (e.g. `registry.labeled(shard="3")`): per-shard serving
        runtimes instrument themselves normally and their series land
        side by side in ONE registry, distinguished by label."""
        return LabeledRegistry(self, labels)


class LabeledRegistry:
    """A label-injecting facade over a MetricsRegistry (same API).

    Caller-supplied labels win on collision, so a site can still
    sub-divide a labeled view's series."""

    enabled = True

    def __init__(self, parent, labels: dict):
        self._parent = parent
        self._labels = dict(labels)

    def _merged(self, labels: dict) -> dict:
        return {**self._labels, **labels}

    def counter(self, name: str, **labels) -> Counter:
        return self._parent.counter(name, **self._merged(labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._parent.gauge(name, **self._merged(labels))

    def histogram(self, name: str, *, buckets_per_doubling: int = 16,
                  **labels) -> Histogram:
        return self._parent.histogram(
            name, buckets_per_doubling=buckets_per_doubling,
            **self._merged(labels))

    def inc(self, name: str, n: int | float = 1, **labels) -> None:
        self.counter(name, **labels).inc(n)

    def set_gauge(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        self.histogram(name, **labels).observe(v)

    def get(self, kind: str, name: str, **labels):
        return self._parent.get(kind, name, **self._merged(labels))

    def labeled(self, **labels) -> "LabeledRegistry":
        return LabeledRegistry(self._parent, self._merged(labels))

    def metrics(self):
        return self._parent.metrics()

    def snapshot(self) -> dict:
        return self._parent.snapshot()


class _NullMetric:
    """One no-op object behind every NullRegistry handle."""

    __slots__ = ()
    name = "null"
    labels = ()
    value = 0
    count = 0
    total = 0.0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v, n=1):
        pass

    def reset(self):
        pass

    def percentile(self, q):
        return math.nan

    def percentiles(self, qs=(50, 95, 99)):
        return {}

    def summary(self):
        return {"count": 0, "sum": 0.0}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """The observability layer switched OFF: same API, every call a no-op.

    `enabled` is False so instrumentation sites can skip work that only
    exists to be published (energy pricing, plan fan-out): with a
    NullRegistry the retrieval path does exactly what it does without
    the observability layer."""

    enabled = False

    def counter(self, name, **labels):
        return _NULL_METRIC

    def gauge(self, name, **labels):
        return _NULL_METRIC

    def histogram(self, name, *, buckets_per_doubling=16, **labels):
        return _NULL_METRIC

    def inc(self, name, n=1, **labels):
        pass

    def set_gauge(self, name, v, **labels):
        pass

    def observe(self, name, v, **labels):
        pass

    def metrics(self):
        return []

    def get(self, kind, name, **labels):
        return None

    def snapshot(self):
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def merge(self, other):
        return self

    def reset(self):
        pass

    def labeled(self, **labels):
        """Labels on nothing are nothing: the null view is its own
        labeled view (keeps `registry.labeled(...)` unconditional)."""
        return self


NULL_REGISTRY = NullRegistry()
