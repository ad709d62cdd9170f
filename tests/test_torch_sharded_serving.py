"""The port's sharded serving runtime (`repro_torch.serve.sharded`) in
lockstep with the reference's (`repro.serve.sharded`), on the CPU.

Every case builds a reference `ShardedServingRuntime` and the port's from
the same config, with every port shard on the one CPU device (the
reference's shards share its one default device), and sends both the
same calls (`SRT` below). After every call the port is held to the
reference: request ids, the placement table, the heartbeat monitor's
workers, the live shards, each `fail_shard` report, every resolved
handle's indices, scores and candidate ids (bit for bit) and the request
ledger; after every flush the whole `ledger()` and every handle's state.
The cases are tests/test_sharded_serving.py:138-363, each in lockstep,
plus a trace over (shards, spread, metric) with deletes and a failover.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core.retrieval import RetrievalConfig as JConfig
from repro.obs import MetricsRegistry as JRegistry
from repro.serve.runtime import RuntimeConfig as JRuntimeConfig
from repro.serve.sharded import ShardedRuntimeConfig as JShardedConfig
from repro.serve.sharded import ShardedServingRuntime as JSharded
from repro_torch.core.retrieval import RetrievalConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (RuntimeConfig, ServingRuntime, ShardedHandle,
                               ShardedRuntimeConfig, ShardedServingRuntime)
from repro_torch.tenancy import MultiTenantIndex

CPU = "cpu"
DIM = 32
K = 4
NT = 5          # tenants
ND = 20         # docs per tenant
# Histograms of wall-clock time: compared by count only.
WALL = ("serve_launch_wall_seconds", "serve_resolve_lag_seconds")


def _corpus(seed=0, queries=1):
    rng = np.random.default_rng(seed)
    docs = {t: rng.integers(-40, 41, (ND, DIM), dtype=np.int8)
            for t in range(NT)}
    qs = {t: rng.integers(-40, 41, (queries, DIM), dtype=np.int8)
          for t in range(NT)}
    return docs, qs


def _cfgs(num_shards, spread=1, metric="mips", max_batch=4):
    """(reference config, port config): candidate_frac=1.0, the stage-1
    budget covering every tenant's rows in every placement."""
    kw = dict(num_shards=num_shards, capacity_per_shard=256, dim=DIM,
              spread=spread)
    rkw = dict(max_batch=max_batch, max_wait=1.0, cache_bytes=0,
               auto_flush=False)
    return (JShardedConfig(**kw, retrieval=JConfig(k=K, metric=metric,
                                                   candidate_frac=1.0),
                           runtime=JRuntimeConfig(**rkw)),
            ShardedRuntimeConfig(**kw, retrieval=RetrievalConfig(
                k=K, metric=metric, candidate_frac=1.0),
                runtime=RuntimeConfig(**rkw)))


def _exact(docs, qs, t, i=0):
    return docs[t].astype(np.int64) @ qs[t][i].astype(np.int64)


def _check_scores(docs, qs, t, r, i=0):
    """Score-exact oracle (tie-tolerant on indices)."""
    exact = _exact(docs, qs, t, i)
    want = np.sort(exact)[::-1][:K]
    got_i, got_s = np.asarray(r.indices), np.asarray(r.scores)
    assert np.array_equal(got_s, want), (t, got_s, want)
    assert (got_i >= 0).all() and len(set(got_i.tolist())) == K
    assert np.array_equal(exact[got_i], got_s)


def _same_result(got, want, what=""):
    for f in ("indices", "scores", "candidate_indices"):
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


class SRT:
    """A reference ShardedServingRuntime and the port's, driven call for
    call and compared after every call."""

    def __init__(self, num_shards, *, registry=False, **kw):
        jcfg, tcfg = _cfgs(num_shards, **kw)
        self.jreg, self.treg = ((JRegistry(), MetricsRegistry()) if registry
                                else (None, None))
        self.j = JSharded(jcfg, registry=self.jreg)
        self.t = ShardedServingRuntime(tcfg, devices=[CPU],
                                       registry=self.treg)
        self.handles = []              # (reference handle, port handle)
        self.j_done, self.t_done = set(), set()
        self._compared = set()
        self.check(barrier=True)

    def ingest_codes(self, tenant, codes):
        got = self.t.ingest_codes(tenant, codes)
        np.testing.assert_array_equal(got, self.j.ingest_codes(tenant, codes))
        assert got.dtype == np.int64
        self.check()
        return got

    def delete(self, tenant, ordinals):
        self.j.delete(tenant, ordinals)
        self.t.delete(tenant, ordinals)
        assert self.t.num_docs(tenant) == self.j.num_docs(tenant)
        self.check()

    def submit(self, tenant, q, **kw):
        jh, th = self.j.submit(tenant, q, **kw), self.t.submit(tenant, q, **kw)
        assert isinstance(th, ShardedHandle)
        assert (th.request_id, th.tenant_id) == (jh.request_id, jh.tenant_id)
        assert sorted(th._req.subs) == sorted(jh._req.subs)
        self.handles.append((jh, th))
        self.check()
        return th

    def poll(self, now=None):
        self._harvested(self.j.poll(now=now), self.t.poll(now=now))
        self.check()

    def flush(self, now=None):
        # A request the port's poll resolved (its CPU launches have landed
        # when they return) may be the reference's flush's to resolve; after
        # a flush every handle is resolved in both (check compares states).
        self._harvested(self.j.flush(now=now), self.t.flush(now=now))
        self.check(barrier=True)

    def _harvested(self, jl, tl):
        """poll and flush hand out each request once."""
        for done, handles in ((self.j_done, jl), (self.t_done, tl)):
            ids = [h.request_id for h in handles]
            assert len(set(ids)) == len(ids) and not done & set(ids)
            done.update(ids)

    def barrier(self):
        # How many launches each retires differs as resolution does (see
        # flush); after it every dispatched sub-request has landed in both.
        self.j.barrier()
        self.t.barrier()
        self.check()

    def fail_shard(self, sid, now=None):
        rep = self.t.fail_shard(sid, now=now)
        assert rep == self.j.fail_shard(sid, now=now)
        self.check()
        return rep

    def check(self, barrier=False):
        t, j = self.t, self.j
        assert t.placement.table() == j.placement.table()
        assert t.placement.live_shards == j.placement.live_shards
        assert t.live_shards == j.live_shards
        assert t.monitor.workers() == j.monitor.workers()
        assert t.mesh.devices.size == j.mesh.devices.size
        tl, jl = t.ledger(), j.ledger()
        if barrier:
            assert tl == jl
        else:
            # resolution waits on the reference's asynchronous CPU
            # dispatch, the port's lands when launched: the rest matches
            for key in ("submitted", "resubmitted", "failovers",
                        "docs_restored", "duplicated", "dropped"):
                assert tl[key] == jl[key], key
        for jh, th in self.handles:
            if barrier:
                assert th.state == jh.state and th.done() == jh.done()
            if (jh._req.result is not None and th._req.result is not None
                    and th.request_id not in self._compared):
                _same_result(th._req.result, jh._req.result,
                             f"request {th.request_id}")
                self._compared.add(th.request_id)

    def check_registry(self):
        """Every per-shard series, sample for sample (the wall-clock
        histograms by count)."""
        jm = [(k, m.name, m.labels) for k, m in self.jreg.metrics()]
        assert [(k, m.name, m.labels) for k, m in self.treg.metrics()] == jm
        for (kind, jmet), (_, tmet) in zip(self.jreg.metrics(),
                                           self.treg.metrics()):
            if kind != "histogram":
                assert tmet.value == jmet.value, (kind, jmet.name)
            elif jmet.name in WALL:
                assert tmet.count == jmet.count, jmet.name
            else:
                assert tmet.summary() == jmet.summary(), jmet.name
        return self.treg


def _ingest_all(srt, docs, rounds=1):
    per = ND // rounds
    for r in range(rounds):
        for t in range(NT):
            srt.ingest_codes(t, docs[t][r * per:(r + 1) * per])


# -- a trace over (shards, spread, metric) ------------------------------------

@pytest.mark.parametrize("shards, spread, metric", [
    (1, 1, "mips"), (2, 1, "mips"), (3, 1, "mips"), (3, 2, "mips"),
    (3, 1, "cosine")])
def test_trace_in_lockstep(shards, spread, metric):
    """Ingest in two rounds (every tenant's rows fragment), submits with
    polls, a flush, deletes, a failover of the shard that owns tenant 0
    (with shards > 1), more submits, a flush."""
    docs, qs = _corpus(31, queries=3)
    srt = SRT(shards, spread=spread, metric=metric)
    _ingest_all(srt, docs, rounds=2)
    for t in range(NT):
        assert len(srt.t.placement.owners(t)) == spread
    now = 0.0
    for i in range(3 * NT):
        now += 0.01
        t = i % NT
        srt.submit(t, qs[t][i // NT], now=now)
        if i % 4 == 3:
            srt.poll(now=now)
    srt.barrier()
    srt.flush(now=now + 1)
    srt.delete(1, [0, 7, 19])
    srt.delete(3, [2])
    for i in range(2 * NT):
        now += 0.01
        t = (3 * i) % NT
        srt.submit(t, qs[t][i % 3], now=now)
        if i == NT and shards > 1:
            rep = srt.fail_shard(srt.t.placement.shard_of(0), now=now)
            assert rep["moved_tenants"]
        if i % 3 == 2:
            srt.poll(now=now)
    srt.flush(now=now + 1)
    led = srt.t.ledger()
    assert led["submitted"] == led["resolved"] == 5 * NT
    assert led["dropped"] == led["duplicated"] == led["outstanding"] == 0
    for _, th in srt.handles:
        got = np.asarray(th.result().indices)
        assert (got < ND).all()
        if th.tenant_id == 1 and th.request_id >= 3 * NT:
            assert not set(got.tolist()) & {0, 7, 19}
        if metric == "mips" and th.tenant_id not in (1, 3):
            i = [k for k in range(3) if np.array_equal(
                th._req.query, qs[th.tenant_id][k])][0]
            _check_scores(docs, qs, th.tenant_id, th.result(), i)


# -- tests/test_sharded_serving.py:138-363, in lockstep ------------------------

def test_one_shard_sharded_matches_plain_runtime_bitwise():
    """A 1-shard runtime is the plain ServingRuntime plus a slot -> ordinal
    translation: indices (translated), scores and byte ledgers equal."""
    docs, qs = _corpus()
    srt = SRT(1)
    cfg = srt.t.cfg
    idx = MultiTenantIndex(cfg.capacity_per_shard, DIM, cfg.retrieval,
                           device=CPU)
    prt = ServingRuntime(idx, cfg.runtime)
    base = {}
    for t in range(NT):
        srt.ingest_codes(t, docs[t])
        base[t] = int(idx.ingest_codes(t, docs[t])[0])
    hs = {t: srt.submit(t, qs[t][0], now=0.0) for t in range(NT)}
    hp = {t: prt.submit(t, qs[t][0], now=0.0) for t in range(NT)}
    srt.flush(now=0.1)
    prt.flush(now=0.1)
    for t in range(NT):
        rs, rp = hs[t].result(), hp[t].result()
        ip = rp.indices.numpy()
        np.testing.assert_array_equal(rs.indices,
                                      np.where(ip >= 0, ip - base[t], -1))
        np.testing.assert_array_equal(rs.scores, rp.scores.numpy())
    led = srt.t.ledger()
    assert led["stage1_bytes_hbm"] == prt.stage1_bytes_streamed
    assert led["launches"] == prt.launches
    assert led["shard_lanes_served"] == {0: prt.queries_served}


def test_multi_shard_matches_single_shard_bitwise():
    docs, qs = _corpus()
    results = {}
    for s in (1, 3):
        srt = SRT(s)
        _ingest_all(srt, docs)
        hs = {t: srt.submit(t, qs[t][0], now=0.0) for t in range(NT)}
        srt.flush(now=0.1)
        results[s] = {t: hs[t].result() for t in range(NT)}
    for t in range(NT):
        a, b = results[1][t], results[3][t]
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.scores, b.scores)
        _check_scores(docs, qs, t, b)


def test_spread_two_merge_matches_brute_force():
    docs, qs = _corpus(3)
    srt = SRT(3, spread=2)
    _ingest_all(srt, docs)
    hs = {t: srt.submit(t, qs[t][0], now=0.0) for t in range(NT)}
    srt.flush(now=0.1)
    for t in range(NT):
        _check_scores(docs, qs, t, hs[t].result())
        assert len(hs[t]._req.subs) == 2        # really fanned out


def test_spread_requires_mips():
    with pytest.raises(ValueError, match="spread"):
        ShardedRuntimeConfig(num_shards=3, spread=2,
                             retrieval=RetrievalConfig(metric="cosine"))
    for bad in (dict(num_shards=0), dict(num_shards=2, spread=3)):
        with pytest.raises(ValueError):
            ShardedRuntimeConfig(**bad)


def test_cosine_single_owner_end_to_end():
    docs, qs = _corpus(5)
    srt = SRT(3, metric="cosine")
    _ingest_all(srt, docs)
    h = srt.submit(2, qs[2][0], now=0.0)
    srt.flush(now=0.1)
    r = h.result()
    assert (np.asarray(r.indices) >= 0).all()
    exact = _exact(docs, qs, 2).astype(np.float64)
    cos = exact / np.sqrt((docs[2].astype(np.float64) ** 2).sum(1))
    assert set(np.asarray(r.indices).tolist()) == \
        set(np.argsort(-cos, kind="stable")[:K].tolist())


def test_failover_exactly_once_and_correct():
    docs, qs = _corpus(11)
    srt = SRT(3)
    _ingest_all(srt, docs)
    pre = {t: srt.submit(t, qs[t][0], now=0.0) for t in range(NT)}
    srt.flush(now=0.1)
    mid = {t: srt.submit(t, qs[t][0], now=0.2) for t in range(NT)}
    victim = srt.t.placement.shard_of(0)
    rep = srt.fail_shard(victim, now=0.3)
    assert victim not in srt.t.live_shards
    assert rep["requests_resubmitted"] >= 1
    assert rep["docs_restored"] == ND * len(rep["moved_tenants"])
    post = {t: srt.submit(t, qs[t][0], now=0.4) for t in range(NT)}
    srt.flush(now=0.5)
    for t in range(NT):
        for h in (pre[t], mid[t], post[t]):
            _check_scores(docs, qs, t, h.result())
    led = srt.t.ledger()
    assert led["submitted"] == led["resolved"] == 3 * NT
    assert led["dropped"] == 0 and led["duplicated"] == 0
    assert led["resolved_by_tenant"] == {t: 3 for t in range(NT)}
    assert led["failovers"] == 1
    assert str(victim) not in srt.t.monitor.workers()
    assert srt.t.mesh.devices.size <= len(srt.t.live_shards)


def test_failover_resolved_results_are_not_recomputed():
    docs, qs = _corpus(13)
    srt = SRT(2)
    _ingest_all(srt, docs)
    h = srt.submit(0, qs[0][0], now=0.0)
    srt.flush(now=0.1)
    r1 = h.result()
    srt.fail_shard(srt.t.placement.shard_of(0), now=0.2)
    assert h.result() is r1                 # cached, never re-run
    assert srt.t.ledger()["resolved"] == 1


def test_failover_skips_deleted_docs():
    docs, qs = _corpus(17)
    srt = SRT(2)
    _ingest_all(srt, docs)
    srt.delete(0, [0, 3])
    srt.fail_shard(srt.t.placement.shard_of(0), now=0.0)
    assert srt.t.num_docs(0) == ND - 2
    h = srt.submit(0, qs[0][0], now=0.1)
    srt.flush(now=0.2)
    got = np.asarray(h.result().indices)
    assert 0 not in got and 3 not in got
    exact = _exact(docs, qs, 0)
    exact[[0, 3]] = np.iinfo(np.int64).min
    np.testing.assert_array_equal(h.result().scores,
                                  np.sort(exact)[::-1][:K])


def test_cannot_fail_last_shard_or_use_dead_shard():
    docs, qs = _corpus()
    srt = SRT(2)
    srt.ingest_codes(0, docs[0])
    dead = srt.t.placement.shard_of(0)
    srt.fail_shard(dead)
    for rt in (srt.j, srt.t):
        with pytest.raises(RuntimeError):
            rt.fail_shard(rt.live_shards[0])
        with pytest.raises(RuntimeError, match="dead"):
            rt.fail_shard(dead)
        with pytest.raises(ValueError):
            rt.ingest_codes(0, docs[0][:, :DIM - 1])


def test_per_shard_labeled_metrics():
    docs, qs = _corpus()
    srt = SRT(2, registry=True)
    _ingest_all(srt, docs)
    for t in range(NT):
        srt.submit(t, qs[t][0], now=0.0)
    srt.flush(now=0.1)
    reg = srt.check_registry()
    per_shard = [reg.get("counter", "serve_requests_submitted", shard=str(s))
                 for s in (0, 1)]
    assert all(c is not None for c in per_shard)
    assert sum(c.value for c in per_shard) == NT


def test_ingest_quantizes_under_the_shared_scale():
    """`ingest` of float embeddings: the same codes, ordinals and results
    as the reference (the fixed arena scale, shared by every shard)."""
    rng = np.random.default_rng(9)
    srt = SRT(3)
    assert srt.t._scale == float(srt.j._scale)
    for t in range(NT):
        emb = rng.normal(size=(ND, DIM)).astype(np.float32) * 0.1
        np.testing.assert_array_equal(srt.t.ingest(t, emb),
                                      srt.j.ingest(t, emb))
        np.testing.assert_array_equal(np.stack(srt.t._corpus[t]),
                                      np.stack(srt.j._corpus[t]))
    for t in range(NT):
        srt.submit(t, rng.integers(-40, 41, DIM, dtype=np.int8), now=0.0)
    srt.flush(now=0.1)


def test_without_a_card_the_default_devices_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedServingRuntime(_cfgs(2)[1])


# -- schedule fuzz: failover composed with arbitrary interleavings -----------

_ops = st.lists(
    st.one_of(
        st.tuples(st.just("submit"), st.integers(0, NT - 1)),
        st.tuples(st.just("poll"), st.just(0)),
        st.tuples(st.just("flush"), st.just(0)),
        st.tuples(st.just("fail"), st.integers(0, 2)),
    ),
    min_size=1, max_size=20)


@settings(max_examples=8, deadline=None)
@given(schedule=_ops, num_shards=st.sampled_from([2, 3]))
def test_failover_fuzz_in_lockstep(schedule, num_shards):
    docs, qs = _corpus(23)
    srt = SRT(num_shards)
    _ingest_all(srt, docs)
    now, fails = 0.0, 0
    for op, a in schedule:
        now += 0.01
        if op == "submit":
            srt.submit(a, qs[a][0], now=now)
        elif op == "poll":
            srt.poll(now=now)
        elif op == "flush":
            srt.flush(now=now)
        elif op == "fail" and len(srt.t.live_shards) > 1:
            srt.fail_shard(srt.t.live_shards[a % len(srt.t.live_shards)],
                           now=now)
            fails += 1
    srt.flush(now=now + 1)
    for jh, th in srt.handles:
        assert th.done()
        _check_scores(docs, qs, th.tenant_id, th.result())
    led = srt.t.ledger()
    assert led["submitted"] == led["resolved"] == len(srt.handles)
    assert led["outstanding"] == 0
    assert led["dropped"] == 0 and led["duplicated"] == 0
    assert led["failovers"] == fails
