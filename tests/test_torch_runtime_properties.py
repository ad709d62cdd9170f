"""Property tests: the port's serving runtime under random request
schedules, in lockstep with the reference's.

The port's counterpart of tests/test_runtime_properties.py, at the same
example counts. For every interleaving of submit/poll/flush with random
tenants, deadlines and clock advances, the port's `ServingRuntime` and the
reference's are driven call for call, and the port must:

  * never drop a request and never duplicate one,
  * never leak across tenants,
  * return results bit-identical to the same query dispatched alone
    through the port's index, which equals the reference's one-lane
    dispatch (indices and scores bit for bit; candidates outside ROADMAP
    C1's near ties),
  * form the reference's launches: the same `launch_index` per request,
    the same handles from every poll and flush.

The index is fragmented, so every batch runs the full-arena masked scan,
whose per-lane results do not depend on the batch.

The trace property is written against its specification (one balanced
submit -> resolve span chain per request, and a bit-identical trace on
replay), not copied: the reference's replay check is flaky (ROADMAP C6)
because `poll()` retires a launch only if its arrays happen to be ready,
which moves the request-end events within the list from run to run; the
timestamps are on the simulated clock either way. A CPU launch of the
port has finished when it returns, so its replay is exact; against the
reference the port's trace is held event for event up to that order.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis; see requirements.txt")

import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import RetrievalConfig as JConfig
from repro.core import quantize_int8 as j_quantize
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.serve.runtime import RuntimeConfig as JRuntimeConfig
from repro.serve.runtime import ServingRuntime as JRuntime
from repro.tenancy import MultiTenantIndex as JIndex
from repro_torch.core.retrieval import RetrievalConfig
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import RuntimeConfig, ServingRuntime
from repro_torch.tenancy import MultiTenantIndex
from test_torch_tenancy import _masked_exempt

DIM = 32
NUM_TENANTS = 3
NUM_QUERIES = 6
FIELDS = ("indices", "scores", "candidate_indices")


@functools.cache
def corpus():
    """Twin fragmented indexes, the query pool, the owner map, and each
    query's one-lane result through the port's index, held to the
    reference's."""
    rng = np.random.default_rng(42)
    jidx = JIndex(128, DIM, JConfig(k=3))
    idx = MultiTenantIndex(128, DIM, RetrievalConfig(k=3), device="cpu")
    docs = {t: [] for t in range(NUM_TENANTS)}
    for _ in range(3):
        for t in range(NUM_TENANTS):
            d = rng.normal(size=(4, DIM)).astype(np.float32)
            jidx.ingest(t, jnp.asarray(d))
            idx.ingest(t, d)
            docs[t].append(d)
    assert all(len(idx.table.segments(t)) > 1 for t in range(NUM_TENANTS))
    pool = {}
    for t in range(NUM_TENANTS):
        d = np.concatenate(docs[t])[:NUM_QUERIES]
        noisy = d + 0.05 * rng.normal(size=d.shape)
        pool[t] = np.asarray(j_quantize(jnp.asarray(noisy.astype(np.float32)),
                                        per_vector=True)[0])
    seq = {}
    for t in range(NUM_TENANTS):
        for i in range(NUM_QUERIES):
            tids = np.asarray([t], np.int32)
            jres = jidx.retrieve(jnp.asarray(pool[t][i])[None], tids)
            res = idx.retrieve(pool[t][i][None], tids)
            for f in ("indices", "scores"):
                np.testing.assert_array_equal(getattr(res, f).numpy(),
                                              np.asarray(getattr(jres, f)))
            got = res.candidate_indices.numpy()
            differ = got != np.asarray(jres.candidate_indices)
            if differ.any():
                exempt = _masked_exempt(jidx, jnp.asarray(pool[t][i])[None],
                                        tids, got.shape[1])
                assert not (differ & ~exempt).any()
            seq[(t, i)] = res
    return jidx, idx, pool, idx.arena.owner.numpy(), seq


schedules = st.lists(
    st.one_of(
        st.tuples(st.just("submit"),
                  st.integers(0, NUM_TENANTS - 1),      # tenant
                  st.integers(0, NUM_QUERIES - 1),      # query id
                  st.floats(0.0, 10.0)),                # deadline slack
        st.tuples(st.just("poll"),
                  st.floats(0.0, 5.0),                  # clock advance
                  st.just(0), st.just(0.0)),
        st.tuples(st.just("flush"), st.just(0), st.just(0), st.just(0.0)),
    ),
    min_size=1, max_size=30)


def _twins(cfg, *, obs=False):
    jidx, idx, *_ = corpus()
    jkw = dict(registry=JRegistry(), tracer=JTracer()) if obs else {}
    tkw = dict(registry=MetricsRegistry(), tracer=Tracer()) if obs else {}
    return (JRuntime(jidx, JRuntimeConfig(**cfg), **jkw),
            ServingRuntime(idx, RuntimeConfig(**cfg), **tkw))


def _drive(rts, schedule):
    """Run one schedule on each runtime in turn, call for call. Returns
    per runtime the (handle, tenant, query id) list and the request ids
    every poll/flush returned; the calls must return the same ids."""
    *_, pool, _, _ = corpus()
    now = 0.0
    submitted = [[] for _ in rts]
    returned = [[] for _ in rts]
    for op, a, b, c in schedule:
        if op == "poll":
            now += a
        for k, rt in enumerate(rts):
            if op == "submit":
                submitted[k].append((rt.submit(a, pool[a][b], now=now,
                                               deadline=now + c), a, b))
            else:
                out = rt.poll(now=now) if op == "poll" else rt.flush()
                returned[k].append([h.request_id for h in out])
        assert all(r == returned[0] for r in returned)
    for k, rt in enumerate(rts):
        returned[k].append([h.request_id for h in rt.flush()])
    assert all(r == returned[0] for r in returned)
    return submitted, returned


@settings(max_examples=20, deadline=None)
@given(schedule=schedules,
       max_batch=st.sampled_from([1, 2, 4, 8]),
       fairness=st.sampled_from(["deadline_rr", "fifo"]))
def test_runtime_never_drops_duplicates_or_leaks(schedule, max_batch,
                                                 fairness):
    _, _, _, owner, seq = corpus()
    jrt, rt = _twins(dict(max_batch=max_batch, max_wait=1.0,
                          fairness=fairness, auto_flush=False))
    (jsub, sub), (_, returned) = _drive((jrt, rt), schedule)
    resolved_ids = [i for ids in returned for i in ids]
    assert rt.pending() == 0
    assert sorted(resolved_ids) == sorted(h.request_id for h, _, _ in sub)
    assert len(set(resolved_ids)) == len(resolved_ids)
    assert rt.queries_served == jrt.queries_served == len(sub)
    assert rt.launches == jrt.launches
    assert len({h.request_id for h, _, _ in sub}) == len(sub)
    for (jh, _, _), (h, t, qi) in zip(jsub, sub, strict=True):
        assert h.done() and h.state == jh.state == "resolved"
        assert h.launch_index == jh.launch_index
        res = h.result()
        got = res.indices.numpy()
        assert (owner[got[got >= 0]] == t).all(), (t, got.tolist())
        for f in FIELDS:
            assert torch.equal(getattr(res, f), getattr(seq[(t, qi)], f)[0])


def _key(events):
    return [(e.name, e.ph, e.ts, e.tid, tuple(sorted(e.attrs.items())))
            for e in events]


@settings(max_examples=15, deadline=None)
@given(schedule=schedules,
       max_batch=st.sampled_from([1, 2, 4]),
       fairness=st.sampled_from(["deadline_rr", "fifo"]))
def test_trace_completeness_under_random_schedules(schedule, max_batch,
                                                   fairness):
    """One balanced submit -> resolve ("request" B/E) span chain per
    request, span ids exactly the submitted request ids, registry totals
    that agree with the trace, a bit-identical trace on replay, and the
    reference's events, in an order that may differ only where the
    reference's launches landed late (module docstring)."""
    cfg = dict(max_batch=max_batch, max_wait=1.0, fairness=fairness,
               auto_flush=False)
    jrt, rt = _twins(cfg, obs=True)
    (_, sub), _ = _drive((jrt, rt), schedule)
    reg, tracer = rt.registry, rt.tracer
    assert tracer.open_spans() == []
    begins = [e for e in tracer.spans("request") if e.ph == "B"]
    ends = [e for e in tracer.spans("request") if e.ph == "E"]
    assert len(begins) == len(ends) == len(sub)
    want_ids = sorted(h.request_id for h, _, _ in sub)
    assert sorted(e.attrs["request"] for e in begins) == want_ids
    assert sorted(e.attrs["request"] for e in ends) == want_ids
    assert len({e.attrs["request"] for e in begins}) == len(begins)
    assert len({e.attrs["request"] for e in ends}) == len(ends)
    t_begin = {e.attrs["request"]: e.ts for e in begins}
    for e in ends:
        assert e.ts >= t_begin[e.attrs["request"]]
        assert e.attrs["launch"] >= 0
    assert reg.get("counter", "serve_requests_submitted").value == len(sub)
    assert reg.get("counter", "serve_requests_resolved").value == len(sub)
    assert reg.get("histogram", "serve_queue_wait_seconds").count == len(sub)
    # replay: the same events in the same order
    _, rt2 = _twins(cfg, obs=True)
    _drive((rt2,), schedule)
    assert _key(tracer.spans()) == _key(rt2.tracer.spans())
    # the reference's events, up to the order of late-landing launches
    assert sorted(_key(tracer.spans())) == sorted(_key(jrt.tracer.spans()))


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 12), max_batch=st.sampled_from([2, 4]))
def test_deadlines_eventually_force_every_launch(n, max_batch):
    *_, pool, _, _ = corpus()
    jrt, rt = _twins(dict(max_batch=max_batch, max_wait=1.0,
                          auto_flush=False))
    pairs = []
    for i in range(n):
        t = i % NUM_TENANTS
        pairs.append((jrt.submit(t, pool[t][0], now=float(i) * 0.01),
                      rt.submit(t, pool[t][0], now=float(i) * 0.01)))
    jl, tl = jrt.poll(now=100.0), rt.poll(now=100.0)
    assert [h.request_id for h in tl] == [h.request_id for h in jl]
    assert rt.pending() == jrt.pending() == 0
    assert all(h.result() is not None for _, h in pairs)
    assert all(h.done() for _, h in pairs)
    for jh, h in pairs:
        assert h.launch_index == jh.launch_index


@settings(max_examples=15, deadline=None)
@given(schedule=schedules,
       max_batch=st.sampled_from([1, 2, 4, 8]),
       fairness=st.sampled_from(["deadline_rr", "fifo"]))
def test_async_pipeline_bit_identical_to_sync(schedule, max_batch, fairness):
    """Async dispatch returns what the synchronous path returns and forms
    the same launches, on the port and against the reference's async
    runtime; mid-schedule `result(wait=False)` probes never disturb it."""
    *_, pool, _, _ = corpus()

    def cfg(depth):
        return dict(max_batch=max_batch, max_wait=1.0, fairness=fairness,
                    auto_flush=False, async_depth=depth)

    _, rt_sync = _twins(cfg(0))
    jrt, rt_async = _twins(cfg(2))
    rts = (rt_sync, rt_async, jrt)
    now = 0.0
    pairs = []
    for op, a, b, c in schedule:
        if op == "submit":
            pairs.append(tuple(rt.submit(a, pool[a][b], now=now,
                                         deadline=now + c) for rt in rts))
        elif op == "poll":
            now += a
            for rt in rts:
                rt.poll(now=now)
            if pairs:
                pairs[-1][1].result(wait=False)
        else:
            for rt in rts:
                rt.flush()
    for rt in rts:
        rt.flush()
    assert rt_async.in_flight() == 0
    assert rt_async.launches == rt_sync.launches == jrt.launches
    for hs, ha, hj in pairs:
        assert hs.state == ha.state == "resolved"
        assert ha.launch_index == hs.launch_index == hj.launch_index
        for f in FIELDS:
            assert torch.equal(getattr(hs.result(), f),
                               getattr(ha.result(), f))
        np.testing.assert_array_equal(ha.result().indices.numpy(),
                                      np.asarray(hj.result().indices))
