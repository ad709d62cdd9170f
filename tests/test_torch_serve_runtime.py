"""The port's serving runtime (`repro_torch.serve`) against the reference's
(`repro.serve.runtime`), driven in lockstep on the CPU.

Every case builds twin indexes from the same numpy inputs (the reference
index and the port's, `test_torch_tenancy.Pair`) and sends the same
submit/poll/flush calls to a reference `ServingRuntime` and the port's
(`RT` below). After every call the port is held to the reference: request
ids, deadlines and `launch_index` per request, handle states (exactly at
barriers; "dispatched or not" between them, since the reference's CPU
launches land asynchronously while the port's CPU launches have landed
when they return), results, and after every flush the ledgers
(`stage1_bytes_streamed`, `_sram`, `_vmapped`, `stage_bytes`,
`stage_bytes_sram`, `prefetch_bytes`), `last_plan`, `cache_stats()`
and the energy ledger. Integers must be bit-identical; the energy
ledger's floats must match to a relative 1e-12. The one allowed
difference is ROADMAP C1's: stage-1 candidate positions whose reference
cosine key lies within 2 ulp of a rank neighbour, counted in
`RT.exempted` and printed after each case (`-s`). With the cache on, its
`block_tier` sidecar is compared too.

The cases are the reference's tests/test_serve_runtime.py, its two
precision-tier cases included. Two of them count XLA compiles in the
reference; here
`test_warm_launch_reuses_the_device_table` and
`test_observability_same_device_work_and_bit_parity` hold what those
counts protected instead (see their docstrings). The engine's slab and
view policies are also held against the reference engine directly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from repro.core import engine as jengine
from repro.core import quantize_int8 as j_quantize
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.serve.runtime import HotClusterCache as JCache
from repro.serve.runtime import RuntimeConfig as JRuntimeConfig
from repro.serve.runtime import ServingRuntime as JRuntime
from repro_torch.core import engine as tengine
from repro_torch.core.retrieval import NO_TENANT
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import (HotClusterCache, RequestHandle,
                               RuntimeConfig, ServingRuntime)
from repro_torch.serve import runtime as truntime
from test_torch_cluster import _jax_exemptions
from test_torch_tenancy import DIM, ROOT, Pair, _eq, _masked_exempt, _port_plan

ENERGY_RTOL = 1e-12
LEDGERS = ("launches", "queries_served", "stage1_bytes_streamed",
           "stage1_bytes_sram", "stage1_bytes_vmapped", "prefetch_bytes",
           "stage_bytes", "stage_bytes_sram")
COUNTERS = ("serve_requests_submitted", "serve_requests_resolved",
            "serve_launches", "serve_deferred_fill_entries",
            "serve_prefetch_bytes", "cache_hits", "cache_misses",
            "cache_evictions", "cache_stale_evictions", "cache_rejected",
            "cache_fill_bytes", "cache_fill_dispatches", "cache_demotions",
            "cache_promotions")


def _pow2(n):
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _dispatched(state):
    return state in ("in_flight", "resolved")


_RUNTIMES = []      # this test's RTs, for the exemption report


@pytest.fixture(autouse=True)
def report_exemptions(request):
    _RUNTIMES.clear()
    yield
    if _RUNTIMES:
        print(f"{request.node.name}: "
              f"{sum(rt.exempted for rt in _RUNTIMES)} candidate positions "
              "exempted")


class RT:
    """A reference ServingRuntime and the port's over a Pair's twin
    indexes, driven call for call and compared after every call."""

    def __init__(self, pair, *, obs=False, **cfg):
        _RUNTIMES.append(self)
        self.pair = pair
        regs = (JRegistry(), MetricsRegistry()) if obs else (None, None)
        tracers = (JTracer(), Tracer()) if obs else (None, None)
        self.jreg, self.treg = regs
        self.jtracer, self.ttracer = tracers
        self.j = JRuntime(pair.j, JRuntimeConfig(**cfg), registry=regs[0],
                          tracer=tracers[0])
        self.t = ServingRuntime(pair.t, RuntimeConfig(**cfg),
                                registry=regs[1], tracer=tracers[1])
        self.handles = []          # (reference handle, port handle)
        self.lanes = {}            # request id -> (launch, lane)
        self.batches = {}          # launch -> (padded queries, tids)
        self.exempted = 0
        self._compared = set()
        launch = self.j._launch

        def record(group, now=None):
            if group:
                pb = _pow2(len(group))
                q = np.zeros((pb, DIM), np.int8)
                tids = np.full((pb,), NO_TENANT, np.int32)
                for i, p in enumerate(group):
                    q[i], tids[i] = p.query, p.handle.tenant_id
                    self.lanes[p.handle.request_id] = (self.j.launches, i)
                self.batches[self.j.launches] = (q, tids)
            return launch(group, now)

        self.j._launch = record

    # -- lockstep calls ---------------------------------------------------

    def submit(self, tenant, q, **kw):
        jh = self.j.submit(tenant, q, **kw)
        th = self.t.submit(tenant, q, **kw)
        assert isinstance(th, RequestHandle)
        assert ((th.request_id, th.tenant_id, th.deadline)
                == (jh.request_id, jh.tenant_id, jh.deadline))
        self.handles.append((jh, th))
        self.check()
        return th

    def poll(self, now=None):
        jl, tl = self.j.poll(now=now), self.t.poll(now=now)
        assert [h.request_id for h in tl] == [h.request_id for h in jl]
        self.check()
        return tl

    def flush(self, now=None):
        jl, tl = self.j.flush(now=now), self.t.flush(now=now)
        assert [h.request_id for h in tl] == [h.request_id for h in jl]
        self.check(barrier=True)
        return tl

    def barrier(self):
        self.t.barrier()
        self.j.barrier()
        self.check(barrier=True)

    def turn(self, tenants, queries, per=2, now=0.0):
        """The reference's run_batch: `per` requests per tenant, flush."""
        hs = [self.submit(t, queries[t][i], now=now)
              for t in tenants for i in range(per)]
        self.flush()
        return hs

    # -- comparisons ------------------------------------------------------

    def check(self, barrier=False):
        j, t = self.j, self.t
        assert t.pending() == j.pending()
        assert t.launches == j.launches
        exact = barrier or self.t.cfg.async_depth == 0
        for jh, th in self.handles:
            assert th.launch_index == jh.launch_index
            if exact:
                assert th.state == jh.state
            else:
                assert _dispatched(th.state) == _dispatched(jh.state)
            if th.state == jh.state == "resolved" and \
                    th.request_id not in self._compared:
                self._compare(jh, th)
                self._compared.add(th.request_id)
        if barrier:
            assert t.in_flight() == j.in_flight() == 0
            self.check_ledgers()

    def _compare(self, jh, th):
        jr, tr = jh.result(), th.result()
        _eq(tr.indices, jr.indices, "indices")
        _eq(tr.scores, jr.scores, "scores")
        got, want = tr.candidate_indices.numpy(), np.asarray(
            jr.candidate_indices)
        assert got.shape == want.shape
        differ = got != want
        if differ.any():
            launch, lane = self.lanes[jh.request_id]
            exempt = self._exempt(launch, differ.shape)[lane]
            self.exempted += int(exempt.sum())
            assert not (differ & ~exempt).any(), (
                "candidates differ outside the reference's near ties")

    def _exempt(self, launch, lane_shape):
        """The reference's near-tie candidate positions of one launch (its
        arena has not changed since: callers compare after each call)."""
        q, tids = self.batches[launch]
        jidx = self.pair.j
        jq = jnp.asarray(q)
        if jidx.cfg.metric == "mips":
            return np.zeros((len(tids),) + lane_shape, bool)
        policy = jidx.cluster_policy(tids)
        if policy is not None:
            return _jax_exemptions(jq, jidx.arena.db(), policy, jidx.cfg)[1]
        c = jidx.cfg.num_candidates(jidx.arena.capacity)
        return _masked_exempt(jidx, jq, tids, c)

    def check_ledgers(self):
        for name in LEDGERS:
            assert getattr(self.t, name) == getattr(self.j, name), name
        if self.j.last_plan is None:
            assert self.t.last_plan is None
        else:
            assert self.t.last_plan == _port_plan(self.j.last_plan)
            self.energy_ledger()
        self.cache_stats()
        if self.jreg is not None:
            for name in COUNTERS:
                assert (self.treg.get("counter", name).value
                        == self.jreg.get("counter", name).value), name

    def cache_stats(self):
        stats = self.t.cache_stats()
        assert stats == self.j.cache_stats()
        if self.j.cache is not None:
            want = self.j.cache.block_tier
            if want is None:
                assert self.t.cache.block_tier is None
            else:
                _eq(self.t.cache.block_tier, want, "block_tier")
        return stats

    def energy_ledger(self):
        got = dataclasses.asdict(self.t.energy_ledger())
        want = dataclasses.asdict(self.j.energy_ledger())
        assert got.keys() == want.keys()
        for key in want:
            assert math.isclose(got[key], want[key], rel_tol=ENERGY_RTOL,
                                abs_tol=0.0), key
        return self.t.energy_ledger()


# ---------------------------------------------------------------------------
# Fixtures: the reference's make_clustered_index / make_plain_index
# ---------------------------------------------------------------------------

def _queries(docs, n):
    return {t: np.asarray(j_quantize(jnp.asarray(d[:n]),
                                     per_vector=True)[0])
            for t, d in docs.items()}


def make_clustered_pair(tenants=4, docs_per_tenant=96, k=3, seed=0,
                        num_clusters=8, nprobe=2, block_rows=32,
                        capacity=1024, prescreen_c0=None):
    rng = np.random.default_rng(seed)
    pair = Pair(capacity, k=k, clusters=dict(
        num_clusters=num_clusters, nprobe=nprobe, block_rows=block_rows))
    if prescreen_c0 is not None:
        pair.set_cfg(prescreen_c0=prescreen_c0)
    docs = {}
    for t in range(tenants):
        d = rng.normal(size=(docs_per_tenant, DIM)).astype(np.float32)
        pair.ingest(t, d)
        docs[t] = d
    pair.compact()
    return pair, _queries(docs, 8)


def make_plain_pair(tenants=3, seed=0, capacity=256, k=3):
    """No clustering; interleaved ingests fragment every tenant, so a
    batch runs the full-arena masked scan."""
    rng = np.random.default_rng(seed)
    pair = Pair(capacity, k=k)
    docs = {t: [] for t in range(tenants)}
    for _ in range(3):
        for t in range(tenants):
            d = rng.normal(size=(5, DIM)).astype(np.float32)
            pair.ingest(t, d)
            docs[t].append(d)
    docs = {t: np.concatenate(v) for t, v in docs.items()}
    assert any(len(pair.t.table.segments(t)) > 1 for t in range(tenants))
    return pair, _queries(docs, 6)


def _uncached(pair, q, tenants, per=2):
    """The port's index.retrieve of the same batch, unpadded."""
    tids = np.asarray([t for t in tenants for _ in range(per)], np.int32)
    Q = np.stack([q[t][i] for t in tenants for i in range(per)])
    return pair.t.retrieve(Q, tids)


def _assert_lanes(handles, ref):
    for lane, h in enumerate(handles):
        res = h.result()
        for field in ("indices", "scores", "candidate_indices"):
            assert torch.equal(getattr(res, field),
                               getattr(ref, field)[lane]), field


# ---------------------------------------------------------------------------
# Admission: deadlines, max-batch, fairness, handles
# ---------------------------------------------------------------------------

def test_deadline_admission_virtual_clock():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=8, max_wait=5.0, auto_flush=False)
    h = rt.submit(0, q[0][0], now=0.0)
    assert not rt.t.ready(now=0.0) and rt.poll(now=4.9) == []
    assert not h.done() and rt.t.pending() == 1
    assert rt.t.next_deadline() == rt.j.next_deadline() == 5.0
    assert rt.poll(now=5.0) == [h] and rt.t.pending() == 0
    assert h.result() is not None and h.done()
    rt.barrier()


def test_full_batch_launches_immediately_from_submit():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=2, max_wait=100.0)
    h1 = rt.submit(0, q[0][0], now=0.0)
    assert not h1.done() and h1.state == "pending"
    h2 = rt.submit(1, q[1][0], now=0.0)
    assert rt.t.launches == 1
    assert h1.state in ("in_flight", "resolved")
    assert h1.result() is not None and h2.result() is not None
    assert h1.done() and h2.done() and rt.t.launches == 1
    rt.barrier()


def test_explicit_deadline_overrides_max_wait():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=8, max_wait=100.0, auto_flush=False)
    h = rt.submit(0, q[0][0], now=0.0, deadline=1.0)
    assert rt.poll(now=0.5) == [] and rt.poll(now=1.0) == [h]
    rt.barrier()


def test_result_wait_false_is_none_until_ready_and_drains():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=8, auto_flush=False)
    h = rt.submit(0, q[0][0], now=0.0)
    assert h.state == "pending"
    assert h.result(wait=False) is None and h.state == "pending"
    res = h.result()
    rt.j.flush()
    rt.check(barrier=True)
    assert h.done() and h.state == "resolved"
    assert res.indices.shape == (3,)
    assert h.result(wait=False) is res


def test_handle_states_through_async_pipeline():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=2, max_wait=100.0, auto_flush=False,
            async_depth=2)
    h1 = rt.submit(0, q[0][0], now=0.0)
    h2 = rt.submit(1, q[1][0], now=0.0)
    assert rt.poll(now=0.0) == [h1, h2]
    assert rt.t.launches == 1
    assert {h1.state, h2.state} <= {"in_flight", "resolved"}
    assert rt.t.in_flight() <= 1
    rt.barrier()
    assert rt.t.in_flight() == 0
    assert h1.state == h2.state == "resolved" and h1.done() and h2.done()


def test_async_depth_zero_is_synchronous():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=2, max_wait=100.0, async_depth=0)
    h1 = rt.submit(0, q[0][0], now=0.0)
    h2 = rt.submit(1, q[1][0], now=0.0)
    assert h1.state == h2.state == "resolved"
    assert rt.t.in_flight() == 0 and h1.done() and h2.done()


def test_async_backpressure_bounds_inflight_depth():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=1, max_wait=100.0, auto_flush=False,
            async_depth=2)
    handles = [rt.submit(t % 3, q[t % 3][t % 4], now=0.0) for t in range(6)]
    rt.poll(now=1000.0)
    assert rt.t.launches == 6 and rt.t.in_flight() <= 2
    rt.barrier()
    assert all(h.state == "resolved" for h in handles)


def test_round_robin_fairness_no_tenant_starvation():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=4, auto_flush=False)
    chatty = [rt.submit(0, q[0][i], now=0.0) for i in range(6)]
    quiet = [rt.submit(t, q[t][0], now=0.0) for t in (1, 2)]
    rt.flush()
    first = [h for h in chatty + quiet if h.launch_index == 0]
    assert {h.tenant_id for h in first} == {0, 1, 2}
    assert sum(h.tenant_id == 0 for h in first) == 2
    launches = [h.launch_index for h in
                sorted(chatty, key=lambda h: h.request_id)]
    assert launches == sorted(launches)


def test_fifo_mode_preserves_arrival_grouping():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=4, fairness="fifo", auto_flush=False)
    handles = [rt.submit(0, q[0][i], now=0.0) for i in range(5)]
    handles.append(rt.submit(1, q[1][0], now=0.0))
    rt.flush()
    assert [h.launch_index for h in handles] == [0, 0, 0, 0, 1, 1]


def test_partial_batch_pads_to_pow2_bucket():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=8, auto_flush=False)
    for i in range(3):
        rt.submit(0, q[0][i], now=0.0)
    rt.flush()
    assert rt.t.last_plan.batch == 4 and rt.t.queries_served == 3


def test_submit_validation():
    pair, q = make_plain_pair()
    rt = ServingRuntime(pair.t)
    with pytest.raises(ValueError, match="tenant id"):
        rt.submit(-1, q[0][0])
    with pytest.raises(ValueError, match="query must be"):
        rt.submit(0, q[0][0][:DIM // 2])
    with pytest.raises(ValueError, match="max_batch"):
        RuntimeConfig(max_batch=0)
    with pytest.raises(ValueError, match="fairness"):
        RuntimeConfig(fairness="lifo")
    with pytest.raises(ValueError, match="precision_tiers"):
        RuntimeConfig(precision_tiers=True)
    with pytest.raises(ValueError, match="precision_tiers"):
        JRuntimeConfig(precision_tiers=True)
    assert RuntimeConfig(cache_bytes=1 << 20, precision_tiers=True)


# ---------------------------------------------------------------------------
# Hot-cluster cache: bit-exact parity, invalidation, accounting
# ---------------------------------------------------------------------------

def test_cache_hit_path_bit_identical_to_miss_path():
    pair, q = make_clustered_pair()
    rt = RT(pair, max_batch=8, cache_bytes=1 << 20, auto_flush=False)
    cold = rt.turn(range(4), q)
    assert rt.cache_stats()["misses"] > 0
    hbm_after_cold = rt.t.stage1_bytes_streamed
    warm = rt.turn(range(4), q)
    assert rt.t.stage1_bytes_streamed == hbm_after_cold
    assert rt.t.last_plan.stage1_bytes == 0
    assert rt.t.last_plan.stage1_bytes_sram > 0
    ref = _uncached(pair, q, range(4))
    _assert_lanes(cold, ref)
    _assert_lanes(warm, ref)


def test_cache_straddling_arena_mutation_evicts_stale_views():
    rng = np.random.default_rng(7)
    pair, q = make_clustered_pair(seed=7)
    rt = RT(pair, max_batch=8, cache_bytes=1 << 20, auto_flush=False)
    rt.turn(range(4), q)
    assert len(rt.t.cache) == len(rt.j.cache) > 0
    gen_before = pair.t.arena.generation
    new = rng.normal(size=(4, DIM)).astype(np.float32)
    pair.ingest(0, new)
    pair.delete(1, pair.t.table.slots(1)[:2])
    assert pair.t.arena.generation > gen_before
    handles = rt.turn(range(4), q)
    assert rt.cache_stats()["stale_evictions"] > 0
    _assert_lanes(handles, _uncached(pair, q, range(4)))
    qn = np.asarray(j_quantize(jnp.asarray(new[:1]), per_vector=True)[0])
    h = rt.submit(0, qn[0], now=0.0)
    rt.flush()
    fresh = pair.t.retrieve(qn, np.asarray([0], np.int32))
    assert torch.equal(h.result().indices, fresh.indices[0])
    assert torch.equal(h.result().scores, fresh.scores[0])
    gone = pair.t.arena.owner.numpy() < 0
    for hh in handles:
        got = hh.result().indices.numpy()
        assert not gone[got[got >= 0]].any()


def test_cache_budget_shrinkage_monotone_hbm_bytes():
    byts, results = [], []
    for budget in (1 << 20, 6 * 1024, 0):
        pair, q = make_clustered_pair(seed=3)
        rt = RT(pair, max_batch=8, cache_bytes=budget, auto_flush=False)
        hs = []
        for _ in range(3):
            hs.extend(rt.turn(range(4), q))
        byts.append(rt.t.stage1_bytes_streamed)
        results.append([h.result().indices for h in hs])
    assert byts[0] <= byts[1] <= byts[2] and byts[0] < byts[2]
    for got in results[1:]:
        for a, b in zip(results[0], got):
            assert torch.equal(a, b)


def test_session_prior_rewarms_cache_after_mutation():
    rng = np.random.default_rng(5)
    pair, q = make_clustered_pair(seed=5)
    rt = RT(pair, max_batch=8, cache_bytes=1 << 20, prior_clusters=8,
            auto_flush=False)
    rt.turn(range(4), q)
    pair.ingest(0, rng.normal(size=(4, DIM)).astype(np.float32))
    hits_before = rt.cache_stats()["hits"]
    rt.turn(range(4), q)
    assert rt.t.prefetch_bytes > 0
    assert rt.cache_stats()["hits"] > hits_before


def _blk_rows(*blocks, br=4):
    return np.concatenate([np.arange(br) + b * br for b in blocks])


class CachePair:
    """A reference HotClusterCache and the port's, called in lockstep; the
    slot ids, counters, byte accounting and entries must agree."""

    def __init__(self, budget, precision_tiers=False):
        self.j = JCache(budget_bytes=budget, precision_tiers=precision_tiers)
        self.t = HotClusterCache(budget_bytes=budget,
                                 precision_tiers=precision_tiers)

    def __getattr__(self, name):
        jf, tf = getattr(self.j, name), getattr(self.t, name)

        def call(*a, **kw):
            want, got = jf(*a, **kw), tf(*a, **kw)
            if want is None or got is None:
                assert want is got
            elif isinstance(want, np.ndarray):
                _eq(got, want, name)
            elif hasattr(want, "slab_blocks"):
                _eq(got.slab_blocks, want.slab_blocks, name)
                assert (got.n_rows, got.nbytes, got.tier) == (
                    want.n_rows, want.nbytes, want.tier)
            else:
                assert got == want, name
            self.check()
            return got
        return call

    def check(self):
        j, t = self.j, self.t
        assert len(t) == len(j)
        assert t.snapshot() == j.snapshot()
        assert (t.bytes_used, t.num_slab_blocks, t._free, t.version,
                t.generation) == (j.bytes_used, j.num_slab_blocks, j._free,
                                  j.version, j.generation)
        assert list(t._entries) == list(j._entries)
        for key, e in j._entries.items():
            mine = t._entries[key]
            _eq(mine.slab_blocks, e.slab_blocks, "slab_blocks")
            assert (mine.n_rows, mine.nbytes, mine.tier) == (
                e.n_rows, e.nbytes, e.tier)
            if e.plane_blocks is not None:
                _eq(mine.plane_blocks, e.plane_blocks, "plane_blocks")
        assert t._fill_rows == j._fill_rows
        assert t._fill_blocks == j._fill_blocks


def test_lru_cache_unit_behavior():
    cache = CachePair(100)
    cache.configure(block_rows=4, bytes_per_row=10)
    cache.sync_generation(1)
    assert cache.t.num_slab_blocks == 2
    assert list(cache.put(0, 0, _blk_rows(3))) == [0]
    assert list(cache.put(0, 1, _blk_rows(5))) == [1]
    assert cache.get(0, 0) is not None
    slots = cache.put(0, 2, _blk_rows(7))
    assert slots is not None and len(slots) == 1
    assert cache.t.bytes_used <= 100 and len(cache.t) == 2
    assert cache.peek(0, 0) and not cache.peek(0, 1)
    assert cache.t.evictions == 1
    cache.sync_generation(2)
    assert len(cache.t) == 0 and cache.t.stale_evictions == 2
    assert len(cache.t._free) == 2
    with pytest.raises(ValueError):
        HotClusterCache(budget_bytes=-1)


def test_packed_admission_uses_fewer_slots_than_straddling_blocks():
    cache = CachePair(400)
    cache.configure(block_rows=4, bytes_per_row=10)
    cache.sync_generation(1)
    straddle = np.arange(2, 6)
    assert len(cache.put(0, 0, straddle)) == 1
    assert cache.t._entries[(0, 0)].n_rows == 4
    fragmented = np.asarray([0, 1, 9, 10])
    assert len(cache.put(0, 1, fragmented)) == 2
    for rows, want in ((straddle, 1), (fragmented, 2)):
        assert (HotClusterCache.entry_blocks(rows, 4)
                == JCache.entry_blocks(rows, 4) == want)


def test_eviction_skips_zero_slot_empty_cluster_memos():
    cache = CachePair(100)
    cache.configure(block_rows=4, bytes_per_row=10)
    cache.sync_generation(1)
    cache.put(0, 5, [])
    cache.put(0, 0, _blk_rows(1))
    cache.put(0, 1, _blk_rows(2))
    cache.put(0, 2, _blk_rows(3))
    assert cache.peek(0, 5)
    assert not cache.peek(0, 0) and cache.t.evictions == 1
    with pytest.raises(ValueError, match="preload"):
        RuntimeConfig(preload=True)


def test_oversized_view_rejected_without_flushing_cache():
    cache = CachePair(100)
    cache.configure(block_rows=4, bytes_per_row=10)
    cache.sync_generation(1)
    cache.put(0, 0, _blk_rows(1))
    cache.put(1, 0, _blk_rows(2))
    assert cache.put(2, 7, _blk_rows(3, 4, 5)) is None
    assert cache.t.rejected == 1 and cache.t.evictions == 0
    assert cache.peek(0, 0) and cache.peek(1, 0) and not cache.peek(2, 7)
    assert cache.t.bytes_used == 80


def test_rejected_reput_keeps_resident_entry():
    cache = CachePair(100)
    cache.configure(block_rows=4, bytes_per_row=10)
    cache.sync_generation(1)
    cache.put(0, 0, _blk_rows(1))
    used = cache.t.bytes_used
    assert cache.put(0, 0, _blk_rows(1, 2, 3)) is None
    assert cache.t.rejected == 1 and cache.peek(0, 0)
    assert cache.t.bytes_used == used
    entry = cache.get(0, 0)
    assert entry is not None and entry.n_rows == 4
    assert cache.put(0, 0, _blk_rows(2, 3)) is not None
    assert cache.t.bytes_used == 80 and len(cache.t) == 1


def test_empty_clusters_memoized_as_zero_byte_hits():
    rng = np.random.default_rng(9)
    pair = Pair(1024, k=3, clusters=dict(num_clusters=8, nprobe=2,
                                         block_rows=32))
    docs = {}
    for t in range(3):
        d = rng.normal(size=(96, DIM)).astype(np.float32)
        pair.ingest(t, d)
        docs[t] = d
    base = rng.normal(size=(1, DIM)).astype(np.float32)
    d3 = (base + 0.01 * rng.normal(size=(24, DIM))).astype(np.float32)
    pair.ingest(3, d3)
    docs[3] = d3
    pair.compact()
    labels = pair.t.arena.cluster_labels
    owner = pair.t.arena.owner.numpy()
    assert len(set(labels[owner == 3])) < 2
    queries = _queries(docs, 2)
    rt = RT(pair, max_batch=8, cache_bytes=1 << 20, prior_clusters=0,
            auto_flush=False)
    rt.turn(range(4), queries)
    misses_cold = rt.cache_stats()["misses"]
    assert misses_cold > 0
    for _ in range(3):
        rt.turn(range(4), queries)
    stats = rt.cache_stats()
    assert stats["misses"] == misses_cold and stats["hits"] > 0
    assert rt.t.last_plan.stage1_bytes == 0
    assert stats["hits"] / (stats["hits"] + stats["misses"]) >= 0.7


def test_preload_under_slab_pressure_stays_bit_identical():
    pair, q = make_clustered_pair(tenants=4)
    demand = sum(
        HotClusterCache.entry_blocks(rows, 32) * 32 * (DIM // 2)
        for t in range(4) for rows in pair.t.cluster_rows(t).values())
    rt = RT(pair, max_batch=8, cache_bytes=demand // 2, preload=True,
            auto_flush=False)
    batches = [(0,), (1,), (2, 3), (0, 1), (1, 2, 3), (0, 1, 2, 3), (0, 1)]
    for tenants in batches:
        handles = [(t, i, rt.submit(t, q[t][i], now=0.0))
                   for t in tenants for i in range(2)]
        rt.flush()
        for t, i, h in handles:
            ref = pair.t.retrieve(q[t][i][None], np.asarray([t], np.int32))
            assert torch.equal(h.result().indices, ref.indices[0])
            assert torch.equal(h.result().scores, ref.scores[0])
    assert rt.cache_stats()["evictions"] > 0


def test_preload_serves_compact_table_when_budget_fits():
    pair, q = make_clustered_pair()
    rt = RT(pair, max_batch=8, cache_bytes=1 << 20, preload=True,
            auto_flush=False)
    for _ in range(2):
        handles = rt.turn(range(4), q)
    stats = rt.cache_stats()
    assert stats["misses"] == 0
    assert rt.t.last_plan.stage1_bytes == 0
    assert rt.t.last_plan.stage1_bytes_sram > 0
    _assert_lanes(handles, _uncached(pair, q, range(4)))
    tids = np.asarray([t for t in range(4) for _ in range(2)], np.int32)
    _, table = pair.t.cluster_layout(tids)
    compact, w = rt.t.cache.compact_table(tids, table.shape[1])
    jcompact, jw = rt.j.cache.compact_table(tids, table.shape[1])
    assert w == jw <= table.shape[2]
    _eq(compact, jcompact, "compact table")


def test_max_wait_zero_means_no_deadline_launches():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=4, max_wait=0.0, auto_flush=False)
    h = rt.submit(0, q[0][0], now=0.0)
    assert rt.t.next_deadline() is None
    assert rt.poll(now=1e9) == [] and not h.done()
    explicit = rt.submit(1, q[1][0], now=0.0, deadline=5.0)
    assert set(rt.poll(now=5.0)) == {h, explicit}
    assert rt.t.pending() == 0
    rt.barrier()


def test_runtime_ledger_matches_plan_accounting():
    pair, q = make_clustered_pair()
    rt = RT(pair, max_batch=8, cache_bytes=1 << 20, auto_flush=False)
    rt.turn(range(4), q)
    plan = rt.t.last_plan
    assert plan.kind == "cluster"
    assert rt.t.stage_bytes["approx"] == plan.stage1_bytes
    assert rt.t.stage_bytes["prune"] == plan.stages[0].bytes_hbm
    rt.turn(range(4), q)
    plan2 = rt.t.last_plan
    approx = [s for s in plan2.stages if s.name == "approx"][0]
    assert approx.bytes_hbm == plan2.stage1_bytes == 0
    assert approx.bytes_sram == plan2.stage1_bytes_sram > 0
    assert rt.energy_ledger().total_uj > 0


def test_scheduler_wrapper_still_fifo_and_ledgered():
    from repro.tenancy import CrossTenantBatchScheduler as JScheduler
    from repro_torch.tenancy import CrossTenantBatchScheduler
    pair, q = make_clustered_pair()
    jsched = JScheduler(pair.j, max_batch=4)
    sched = CrossTenantBatchScheduler(pair.t, max_batch=4)
    rids = []
    for t, i in [(t, 0) for t in range(4)] + [(0, 1)]:
        rid = sched.submit(t, q[t][i])
        assert rid == jsched.submit(t, q[t][i])
        rids.append(rid)
    assert sched.pending() == jsched.pending() == 5
    out, jout = sched.flush(), jsched.flush()
    assert sched.pending() == 0 and sched.launches == jsched.launches == 2
    assert set(out) == set(jout) == set(rids)
    for rid in rids:
        _eq(out[rid].indices, jout[rid].indices, "indices")
        _eq(out[rid].scores, jout[rid].scores, "scores")
    assert sched.stage1_bytes_streamed == jsched.stage1_bytes_streamed > 0
    assert sched.stage1_bytes_vmapped == jsched.stage1_bytes_vmapped
    assert sched.stage_bytes == jsched.stage_bytes
    assert sum(sched.stage_bytes.values()) > 0


def test_warm_launch_reuses_the_device_table(monkeypatch):
    """The reference counts XLA traces here (`test_cached_path_trace_
    stability`): its slab path must compile a bounded set of cascades and
    fill scatters, and a fully warm launch nothing new. Torch compiles
    nothing, so this holds what that protected: over launches with varied
    batch sizes, hit/miss patterns, eviction churn and an arena mutation
    (in lockstep with the reference, results and ledgers equal), a fully
    warm steady-state launch re-uses the cached device table (same slot
    map version, the same tensor) and uploads only its queries — no
    table, validity or fill upload and no fill dispatch."""
    pair, q = make_clustered_pair(docs_per_tenant=96)
    rt = RT(pair, max_batch=8, cache_bytes=24 * 1024, auto_flush=False)
    rng = np.random.default_rng(0)

    def varied_launches(turns):
        for i in range(turns):
            for j in range((1, 2, 3, 8)[i % 4]):
                t = j % 4
                rt.submit(t, q[t][int(rng.integers(8))], now=0.0)
            rt.flush()

    varied_launches(12)
    pair.ingest(0, rng.normal(size=(4, DIM)).astype(np.float32))
    varied_launches(8)
    stats = rt.cache_stats()
    assert stats["hits"] > 0 and stats["evictions"] > 0
    # A steady state: the same two lanes until nothing is admitted.
    for _ in range(3):
        rt.turn((1,), q, per=2)
    cache = rt.t.cache
    version, tables = cache.version, dict(cache._table_cache)
    assert tables
    uploads = []
    real_upload = truntime.upload
    monkeypatch.setattr(truntime, "upload", lambda arr, dev: (
        uploads.append(arr.shape), real_upload(arr, dev))[1])
    fills = cache.snapshot()["fill_dispatches"]
    rt.turn((1,), q, per=2)
    assert cache.version == version
    assert cache._table_cache.keys() == tables.keys()
    assert all(cache._table_cache[k] is v for k, v in tables.items())
    assert uploads == [(2, DIM)]
    assert cache.snapshot()["fill_dispatches"] == fills
    assert rt.t.last_plan.stage1_bytes == 0


def test_cache_stats_snapshot_and_reset_windows():
    pair, q = make_clustered_pair()
    rt = RT(pair, max_batch=4, cache_bytes=256 * 1024, auto_flush=False)
    for turn in range(3):
        for t in range(4):
            rt.submit(t, q[t][turn], now=0.0)
        rt.flush()
    fill = rt.t.cache.snapshot()
    assert fill == rt.j.cache.snapshot()
    assert fill["misses"] > 0 and fill["fill_bytes"] > 0
    assert set(fill) == {"hits", "misses", "evictions", "stale_evictions",
                         "rejected", "fill_bytes", "fill_dispatches"}
    entries_before = len(rt.t.cache)
    rt.t.cache.reset_stats()
    rt.j.cache.reset_stats()
    assert rt.t.cache.hits == 0 and rt.t.cache.misses == 0
    assert len(rt.t.cache) == entries_before
    for turn in range(3):
        for t in range(4):
            rt.submit(t, q[t][turn], now=0.0)
        rt.flush()
    steady = rt.t.cache.snapshot()
    assert steady["hits"] > 0 and steady["misses"] == 0
    assert steady["fill_bytes"] == 0
    cs = rt.cache_stats()
    assert cs["hits"] == steady["hits"] and cs["fill_bytes"] == 0
    assert cs["bytes_used"] == rt.t.cache.bytes_used > 0


def test_observability_same_device_work_and_bit_parity():
    """The reference's `test_observability_zero_compiles_and_bit_parity`
    pins three things: results with a real registry and tracer equal the
    ones without, no extra jit trace, and a balanced trace whose totals
    match the registry. The first and third are held here as there (and
    the registry's counters against the reference's, in lockstep); the
    compile count becomes what it protected: the metrics-off and
    metrics-on launch paths do the same tensor work — the same aten
    operators, the same number of times, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    pair, q = make_clustered_pair(docs_per_tenant=96)
    cfg = dict(max_batch=8, cache_bytes=256 * 1024, auto_flush=False)

    def drive(rt, submit):
        out = []
        for turn in range(4):
            hs = [submit(t, q[t][turn % 8], now=float(turn))
                  for t in range(4)]
            rt.flush()
            out.extend(h.result() for h in hs)
        return out

    def ops(run):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = run()
        return out, {e.key: e.count for e in prof.key_averages()
                     if e.key.startswith("aten::")}

    def port(**obs):
        rt = ServingRuntime(pair.t, RuntimeConfig(**cfg), **obs)
        return drive(rt, rt.submit)

    reg, tracer = MetricsRegistry(), Tracer()
    port()          # the index's own one-time work (layouts, codebook)
    base, base_ops = ops(port)
    obs, obs_ops = ops(lambda: port(registry=reg, tracer=tracer))
    assert obs_ops == base_ops
    for a, b in zip(base, obs, strict=True):
        for field in ("indices", "scores", "candidate_indices"):
            assert torch.equal(getattr(a, field), getattr(b, field))
    assert tracer.open_spans() == []
    assert reg.get("counter", "serve_requests_submitted").value == 16
    assert reg.get("counter", "serve_requests_resolved").value == 16
    assert reg.get("counter", "serve_launches").value == 4
    assert reg.get("histogram", "serve_batch_occupancy").count == 4
    assert reg.get("histogram", "energy_uj_per_query").count == 16
    assert reg.get("counter", "stage_bytes_hbm", stage="approx").value > 0
    assert reg.get("counter", "cache_misses").value > 0
    lock = RT(pair, obs=True, **cfg)
    drive(lock, lock.submit)
    for kind, metric in lock.jreg.metrics():
        if kind != "counter":
            continue
        mine = lock.treg.get("counter", metric.name, **dict(metric.labels))
        assert mine.value == metric.value, metric.name


# ---------------------------------------------------------------------------
# Precision tiers
# ---------------------------------------------------------------------------

def test_precision_tiers_admit_sign_promote_on_reprobe():
    """The reference's tier lifecycle under an ample budget, in lockstep:
    misses admit at the sign tier (no slots), a re-probe promotes to full
    (plane bytes charged once, as the miss they replace), and the third
    pass serves full-tier hits with no stage-1 device-memory bytes; every
    pass equals the uncached prescreen cascade."""
    pair, q = make_clustered_pair(prescreen_c0=32)
    rt = RT(pair, obs=True, max_batch=8, cache_bytes=1 << 20,
            precision_tiers=True, auto_flush=False)
    ref = _uncached(pair, q, range(4))
    _assert_lanes(rt.turn(range(4), q), ref)            # pass 1: cold
    s1 = rt.cache_stats()
    assert s1["sign_entries"] > 0 and s1["full_entries"] == 0
    assert s1["promotions"] == 0
    tier = rt.t.cache.block_tier
    assert (tier == truntime.TIER_SIGN).any()
    assert not (tier == truntime.TIER_FULL).any()
    _assert_lanes(rt.turn(range(4), q), ref)            # pass 2: promote
    s2 = rt.cache_stats()
    assert s2["promotions"] > 0 and s2["full_entries"] > 0
    assert (rt.t.cache.block_tier == truntime.TIER_FULL).any()
    hbm_before = rt.t.stage1_bytes_streamed
    _assert_lanes(rt.turn(range(4), q), ref)            # pass 3: warm
    assert rt.t.stage1_bytes_streamed == hbm_before
    assert rt.t.last_plan.stage1_bytes == 0
    assert rt.t.last_plan.stage1_bytes_sram > 0
    assert rt.cache_stats()["hits"] > s2["hits"]


def test_precision_tiers_demote_under_pressure_bit_identical():
    """A slab budget far below the working set: full entries are demoted
    to the sign tier instead of dropped, results stay equal to the
    uncached cascade and to a full-precision cache on the same trace, the
    sign tier keeps more residents than the slab has slots, and the tiered
    cache streams no more stage-1 plane bytes than the full-precision
    one; both runtimes in lockstep with the reference, registry and all."""
    pair, q = make_clustered_pair(prescreen_c0=32)
    tight = 4 * 32 * (DIM // 2)      # 4 slab slots; the working set is ~8+
    rt = RT(pair, obs=True, max_batch=8, cache_bytes=tight,
            precision_tiers=True, auto_flush=False)
    rt_full = RT(pair, obs=True, max_batch=8, cache_bytes=tight,
                 auto_flush=False)
    ref = _uncached(pair, q, range(4))
    for _ in range(3):
        _assert_lanes(rt.turn(range(4), q), ref)
        _assert_lanes(rt_full.turn(range(4), q), ref)
    snap = rt.cache_stats()
    assert snap["demotions"] > 0
    assert (snap["sign_entries"] + snap["full_entries"]
            > rt.t.cache.num_slab_blocks)
    assert rt.t.stage1_bytes_streamed <= rt_full.t.stage1_bytes_streamed
    assert rt.treg.get("counter", "cache_demotions").value == \
        snap["demotions"]


def _session_pair(tenants=8, docs_per_tenant=256, num_clusters=32,
                  nprobe=8, turns=12, prescreen_c0=64, seed=0):
    """The reference bench's session trace at a small size: planted
    centres bootstrap the codebook, each tenant's docs sit near random
    centres, and each turn every tenant queries a noisy copy of one of its
    docs near its focus centre (kept with probability 0.8, else redrawn
    from a Zipf(1.1) over the centres). Returns (pair, turns of (tenant,
    int8 query) and the quarter budget of the tenants' packed views)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(num_clusters, DIM)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    br = 32
    cap = -(-(tenants * docs_per_tenant + num_clusters) // br) * br
    pair = Pair(cap, k=5, clusters=dict(num_clusters=num_clusters,
                                        nprobe=nprobe, block_rows=br))
    pair.set_cfg(prescreen_c0=prescreen_c0)
    pair.ingest(0, centres)
    planted, docs = {}, {}
    for t in range(tenants):
        planted[t] = rng.integers(0, num_clusters, docs_per_tenant)
        d = centres[planted[t]] + 0.2 * rng.normal(
            size=(docs_per_tenant, DIM))
        docs[t] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
            np.float32)
        pair.ingest(t, docs[t])
    pair.compact()
    pops = 1.0 / np.arange(1, num_clusters + 1) ** 1.1
    pops /= pops.sum()
    focus = rng.choice(num_clusters, size=tenants, p=pops)
    trace = []
    for _ in range(turns):
        redraw = rng.random(tenants) >= 0.8
        focus = np.where(redraw, rng.choice(num_clusters, size=tenants,
                                            p=pops), focus)
        turn = []
        for t in range(tenants):
            mine = np.flatnonzero(planted[t] == focus[t])
            x = docs[t][int(rng.choice(mine)) if mine.size
                        else int(rng.integers(docs_per_tenant))]
            x = x + 0.1 * rng.normal(size=DIM)
            turn.append((t, np.asarray(j_quantize(jnp.asarray(
                (x / np.linalg.norm(x)).astype(np.float32))[None],
                per_vector=True)[0][0])))
        trace.append(turn)
    demand = sum(HotClusterCache.entry_blocks(r, br)
                 for t in range(tenants)
                 for r in pair.t.cluster_rows(t).values()) * br * (DIM // 2)
    return pair, trace, demand // 4


def test_precision_tiers_on_a_session_trace_trade_stage1_for_stage0():
    """On a session trace under a quarter budget with the prescreen, the
    reference's tiers stream MORE stage-1 plane bytes than the
    full-precision cache (sign entries hold budget a full entry would use,
    and a sign-tier hit streams its plane blocks), and fewer stage-0 +
    stage-1 bytes in all (sign bytes served from the cache): the
    reference's own ledgers, which the port's equal in lockstep. The
    unit case above (four slots, the same queries every pass) shows the
    opposite order of stage-1 bytes, so neither order is a property of
    the tiers."""
    pair, trace, budget = _session_pair()
    rts = {tiers: RT(pair, max_batch=8, cache_bytes=budget, preload=True,
                     precision_tiers=tiers, auto_flush=False)
           for tiers in (False, True)}
    for i, turn in enumerate(trace):
        for rt in rts.values():
            for t, q in turn:
                rt.submit(t, q, now=float(i))
            rt.flush()
    full, tiered = rts[False].t, rts[True].t
    assert tiered.cache.demotions > 0 and tiered.cache.promotions > 0
    assert tiered.stage1_bytes_streamed > full.stage1_bytes_streamed
    assert (tiered.stage1_bytes_streamed + tiered.stage_bytes["prescreen"]
            < full.stage1_bytes_streamed + full.stage_bytes["prescreen"])


def test_tier_cache_calls_match_the_reference_cache():
    """The tiered cache's slot map call for call against the reference's:
    sign admissions hold no slots, slot pressure demotes the least
    recently used full entry, byte pressure demotes and then drops sign
    entries, a promotion re-admits at full precision; `lookup_lane_tiers`
    splits the bytes the same way."""
    cache = CachePair(3 * 4 * 8, precision_tiers=True)
    cache.configure(block_rows=4, bytes_per_row=8)
    cache.sync_generation(1)
    assert cache.t.num_slab_blocks == 3
    cache.put(0, 0, _blk_rows(1), tier=truntime.TIER_SIGN)
    cache.put(0, 1, _blk_rows(2))
    cache.put(0, 2, _blk_rows(3, 4))
    cache.put(1, 0, _blk_rows(5), tier=truntime.TIER_SIGN)
    assert cache.lookup_lane_tiers(0, [0, 1, 2, 3]) is not None
    cache.put(1, 1, _blk_rows(6, 7))             # slot pressure: demote
    assert cache.t.demotions >= 1
    for c in range(2, 8):                        # byte pressure
        cache.put(2, c, _blk_rows(8 + c), tier=truntime.TIER_SIGN)
    cache.promote(0, 1, _blk_rows(2))
    assert cache.lookup_lane_tiers(2, [5, 6, 7, 9]) is not None
    assert cache.t.snapshot()["sign_entries"] > 0
    with pytest.raises(ValueError, match="dim % 8"):
        HotClusterCache(64, precision_tiers=True).configure(4, 6)
    plain = HotClusterCache(64)
    plain.configure(4, 8)
    with pytest.raises(ValueError, match="precision_tiers"):
        plain.put(0, 0, _blk_rows(1), tier=truntime.TIER_SIGN)


# ---------------------------------------------------------------------------
# Async pipeline parity: the deferred-bookkeeping contract
# ---------------------------------------------------------------------------

def test_async_pipeline_matches_sync_seeded_schedules():
    pair, q = make_plain_pair()

    def drive(depth, seed):
        rng = np.random.default_rng(seed)
        rt = RT(pair, max_batch=int(rng.choice([1, 2, 4])), max_wait=1.0,
                auto_flush=False, async_depth=depth)
        now, handles = 0.0, []
        for _ in range(24):
            op = rng.integers(3)
            if op == 0:
                t = int(rng.integers(3))
                handles.append(rt.submit(t, q[t][int(rng.integers(6))],
                                         now=now, deadline=now + 5.0))
            elif op == 1:
                now += float(rng.uniform(0.0, 2.0))
                rt.poll(now=now)
                if handles:
                    handles[-1].result(wait=False)
            else:
                rt.flush()
        rt.flush()
        assert rt.t.in_flight() == 0
        return rt.t.launches, [h.result() for h in handles]

    for seed in range(4):
        launches_s, res_s = drive(0, seed)
        launches_a, res_a = drive(2, seed)
        assert launches_a == launches_s
        for rs, ra in zip(res_s, res_a, strict=True):
            for field in ("indices", "scores", "candidate_indices"):
                assert torch.equal(getattr(rs, field), getattr(ra, field))


def test_async_cached_path_parity_and_ledgers():
    pair, q = make_clustered_pair(seed=7)

    def run(depth, max_batch):
        rt = RT(pair, max_batch=max_batch, cache_bytes=1 << 20,
                prior_clusters=8, auto_flush=False, async_depth=depth)
        outs = []
        for turn in range(6):
            hs = [rt.submit(t, q[t][(turn + j) % 8], now=float(turn))
                  for t in range(4) for j in range(2)]
            rt.flush()
            outs.append(torch.stack([h.result().indices for h in hs]))
        stats = rt.cache_stats()
        return (outs, rt.t.stage1_bytes_streamed, rt.t.stage1_bytes_sram,
                stats["hits"], stats["misses"])

    outs_s, *led_s = run(0, max_batch=8)
    outs_a, *led_a = run(2, max_batch=8)
    for a, s in zip(outs_a, outs_s, strict=True):
        assert torch.equal(a, s)
    assert led_a == led_s
    outs_s4, *_ = run(0, max_batch=4)
    outs_a4, *_ = run(2, max_batch=4)
    for a, s in zip(outs_a4, outs_s4, strict=True):
        assert torch.equal(a, s)


def test_handles_are_single_assignment():
    pair, q = make_plain_pair()
    rt = RT(pair, max_batch=2)
    h = rt.submit(0, q[0][0], now=0.0)
    rt.flush()
    first = h.result()
    assert h.result() is first
    assert isinstance(h, RequestHandle)
    assert dataclasses.is_dataclass(rt.t.cfg)


# ---------------------------------------------------------------------------
# The engine's slab and view policies against the reference engine
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("prescreen_c0", [None, 48])
def test_slab_policy_matches_the_reference_engine(monkeypatch,
                                                  prescreen_c0):
    """Every SlabPolicy the two runtimes hand their engines over a warm-up
    trace (misses, hits, the compact table) is the same policy — integer
    fields bit for bit, the f32 rsqrt sidecar within 1 ulp (ROADMAP C1) —
    and the port's engine given the reference's policy returns the
    reference engine's result, with the sign prescreen on and off."""
    seen = {"j": [], "t": []}
    jcall = jengine.RetrievalEngine.retrieve_with_clusters
    tcall = tengine.RetrievalEngine.retrieve_with_clusters

    def snap(x):
        # Copies: later fills write the slab in place (the port) or
        # donate its buffers (the reference).
        return x if x is None or isinstance(x, int) else np.array(x)

    def spy(key, call):
        def run(self, q, db, policy):
            fields = {f.name: snap(getattr(policy, f.name))
                      for f in dataclasses.fields(policy)}
            res, top = call(self, q, db, policy)
            seen[key].append((snap(q), fields, (res, top)))
            return res, top
        return run

    monkeypatch.setattr(jengine.RetrievalEngine, "retrieve_with_clusters",
                        spy("j", jcall))
    monkeypatch.setattr(tengine.RetrievalEngine, "retrieve_with_clusters",
                        spy("t", tcall))
    pair, q = make_clustered_pair(prescreen_c0=prescreen_c0)
    rt = RT(pair, max_batch=8, cache_bytes=1 << 20, auto_flush=False)
    rt.turn(range(4), q)
    rt.turn(range(4), q)
    rt2 = RT(pair, max_batch=8, cache_bytes=1 << 20, preload=True,
             auto_flush=False)
    rt2.turn(range(4), q)
    assert len(seen["j"]) == len(seen["t"]) == 3
    for (jq, jp, (jres, jtop)), (tq, tp, (tres, ttop)) in zip(
            seen["j"], seen["t"], strict=True):
        _eq(tq, jq, "queries")
        for name in ("packed_labels", "tenant_ids", "centroid_msb",
                     "centroid_norms", "cluster_valid", "slab_blocks",
                     "block_gid0", "block_count", "slab_plane"):
            _eq(tp[name], jp[name], name)
        np.testing.assert_array_max_ulp(tp["inv_norms"], jp["inv_norms"],
                                        maxulp=1)
        assert ((tp["nprobe"], tp["block_rows"])
                == (jp["nprobe"], jp["block_rows"]))
        if prescreen_c0 is None:
            assert tp["sign_plane"] is None and jp["sign_plane"] is None
        else:
            _eq(tp["sign_plane"], jp["sign_plane"], "sign_plane")
        _eq(ttop, jtop, "top clusters")
        ported = tengine.SlabPolicy(**{
            name: _t(v) if isinstance(v, np.ndarray) else v
            for name, v in jp.items() if name != "block_tier"})
        res, top = tcall(pair.t.engine, _t(jq), pair.t.arena.db(), ported)
        for got in (res, tres):
            _eq(got.indices, jres.indices, "indices")
            _eq(got.scores, jres.scores, "scores")
        _eq(top, jtop, "top clusters")
        plan = pair.t.engine.plan_for(pair.t.arena.db(), jq.shape[0], ported)
        assert plan == _port_plan(pair.j.engine.plan_for(
            pair.j.arena.db(), jq.shape[0], jengine.SlabPolicy(**{
                name: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for name, v in jp.items()})))


def test_view_policy_matches_the_reference_engine():
    """A ViewPolicy built from the cluster prune's expansion (as the
    reference's pre-slab cache path built it) through both engines; the
    port's view result also equals its own cluster-policy result."""
    pair, q = make_clustered_pair()
    tids = np.asarray([t for t in range(4) for _ in range(2)], np.int32)
    Q = np.stack([q[t][i] for t in range(4) for i in range(2)])
    jpol = pair.j.cluster_policy(tids)
    jdb = pair.j.arena.db()
    top = jengine.select_clusters(jnp.asarray(Q) >> 4, jpol, pair.j.cfg,
                                  jengine.stage_fns("jnp"))
    rows, member, _ = jengine.expand_cluster_view(jpol, top, jdb.num_docs)
    msb_rows = jnp.take(jdb.msb_plane, jnp.maximum(rows, 0), axis=0)
    jres = pair.j.engine.retrieve(jnp.asarray(Q), jdb, jengine.ViewPolicy(
        rows=rows, member=member, msb_rows=msb_rows))
    view = tengine.ViewPolicy(rows=_t(rows), member=_t(member),
                              msb_rows=_t(msb_rows))
    db = pair.t.arena.db()
    res = pair.t.engine.retrieve(_t(Q), db, view)
    _eq(res.indices, jres.indices, "indices")
    _eq(res.scores, jres.scores, "scores")
    cold = pair.t.engine.retrieve(_t(Q), db, pair.t.cluster_policy(tids))
    for field in ("indices", "scores", "candidate_indices"):
        assert torch.equal(getattr(res, field), getattr(cold, field))
    plan = pair.t.engine.plan_for(db, len(tids), view)
    assert plan.kind == "view" and plan.rows_scanned == rows.shape[1]
    assert plan == _port_plan(pair.j.engine.plan_for(jdb, len(tids),
                                                     jengine.ViewPolicy(
                                                         rows, member,
                                                         msb_rows)))


def test_slab_table_ids_checked_on_the_host():
    """ROADMAP C2: a launch table id outside [-1, NB + S) raises before
    the upload instead of relying on a clamp."""
    pair, q = make_clustered_pair()
    rt = ServingRuntime(pair.t, RuntimeConfig(max_batch=8,
                                              cache_bytes=1 << 20,
                                              auto_flush=False))
    for t in range(4):
        rt.submit(t, q[t][0], now=0.0)
    rt.flush()
    cache = rt.cache
    tids = np.arange(4, dtype=np.int32)
    _, table = pair.t.cluster_layout(tids)
    limit = pair.t.capacity // cache.block_rows + cache.num_slab_blocks
    fresh = np.asarray([7, 1, 2, 3], np.int32)   # lane 0: nothing resident
    for bad in (limit, -2):
        broken = table.copy()
        broken[0, 0, 0] = bad
        with pytest.raises(ValueError, match="slab table ids"):
            cache.combined_table(fresh, broken)
    assert cache.combined_table(tids, table).shape == table.shape


def test_serve_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.tenancy\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
