"""The port's multi-tenant streaming index (`repro_torch.tenancy`) against
the JAX package's (`repro.tenancy`) on the same numpy inputs.

Every case drives both packages with the same operations and holds the
port to the reference bit for bit after every one: slot ids, the arena's
planes, sign plane, norms, owner, cluster labels and counters, the tenant
table, compaction mappings, codebooks, the chosen policy's `last_plan`,
and the results (indices, scores, candidates). The one allowed difference
is ROADMAP C1's: stage-1 candidate positions whose reference cosine key
lies within 2 ulp of a rank neighbour (`test_torch_engine._exempt`).

The cases are the reference's `tests/test_tenancy.py` without its
scheduler and RAG cases (the scheduler wraps the serving runtime, which
is not ported yet), a property test over random insert/delete/compact
histories (as `tests/test_arena_properties.py`), a clustered index, and
state carried across with `repro_torch.convert`.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import RetrievalConfig as JConfig
from repro.core import engine as jengine
from repro.core import similarity as jsim
from repro.core.clustering import ClusterParams as JClusterParams
from repro.core.quantization import quantize_int8 as j_quantize
from repro.core.retrieval import (
    two_stage_retrieve_masked as j_two_stage_masked)
from repro.data import retrieval_corpus
from repro.tenancy import Arena as JArena
from repro.tenancy import ArenaFull as JArenaFull
from repro.tenancy import MultiTenantIndex as JIndex
from repro.tenancy import PlacementTable as JPlacement
from repro_torch import convert
from repro_torch.core import retrieval as tretrieval
from repro_torch.core.clustering import ClusterParams
from repro_torch.core.retrieval import NO_TENANT, RetrievalConfig
from repro_torch.core.engine import SchedulePlan, StagePlan
from repro_torch.tenancy import (Arena, ArenaFull, MultiTenantIndex,
                                 PlacementTable)
from test_torch_cluster import _jax_exemptions
from test_torch_engine import _exempt

DIM = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_arena_equal(ta: Arena, ja: JArena) -> None:
    for name in ("msb_plane", "lsb_plane", "norms_sq", "owner", "scale"):
        _eq(getattr(ta, name), getattr(ja, name), name)
    if ja.sign_plane is None:
        assert ta.sign_plane is None
    else:
        _eq(ta.sign_plane, ja.sign_plane, "sign_plane")
    _eq(ta.cluster_labels, ja.cluster_labels, "cluster_labels")
    assert ((ta._next, ta._tombstones, ta.generation, ta.num_live,
             ta.num_free) == (ja._next, ja._tombstones, ja.generation,
                              ja.num_live, ja.num_free))
    assert dataclasses.asdict(ta.stats) == dataclasses.asdict(ja.stats)


def _masked_exempt(jidx, jq, tids, c):
    """The reference's own masked stage-1 keys over the whole arena ->
    its near-tie candidate positions (B, c). The windowed scan ranks the
    same keys over a window holding every row of the tenant, so this
    covers it too."""
    jdb = jidx.arena.db()
    scores = jengine.stage1_plane_batched_jnp(jq >> 4, jdb.msb_plane)
    member = jidx.arena.owner[None, :] == jnp.asarray(tids)[:, None]
    key = jnp.where(member, jsim.cosine_key_f32(scores, jdb.norms_sq[None]),
                    -jnp.inf)
    keys, _ = jax.lax.top_k(key, min(c + 1, key.shape[1]))
    keys = np.asarray(keys)
    if keys.shape[1] == c:                   # the whole arena: no boundary
        keys = np.concatenate(
            [keys, np.full((keys.shape[0], 1), -np.inf, np.float32)], axis=1)
    return _exempt(keys)


class Pair:
    """A JAX `MultiTenantIndex` and the port's, driven in lockstep."""

    def __init__(self, capacity=256, *, k=3, metric="cosine", clusters=None,
                 backend="cuda"):
        self.j = JIndex(capacity, DIM, JConfig(k=k, metric=metric),
                        clusters=(None if clusters is None
                                  else JClusterParams(**clusters)))
        self.t = MultiTenantIndex(
            capacity, DIM, RetrievalConfig(k=k, metric=metric,
                                           backend=backend),
            clusters=None if clusters is None else ClusterParams(**clusters),
            device="cpu")
        self.exempted = 0

    def check_state(self):
        assert_arena_equal(self.t.arena, self.j.arena)
        assert self.t.table.tenant_ids == self.j.table.tenant_ids
        for tid in self.j.table.tenant_ids:
            assert self.t.table.slots(tid) == self.j.table.slots(tid)
            assert self.t.table.segments(tid) == self.j.table.segments(tid)
        if self.j.clusters is not None:
            tc, jc = self.t.clusters, self.j.clusters
            assert tc.generation == jc.generation
            assert tc.trained == jc.trained
            if jc.trained:
                _eq(tc._centroids, jc._centroids, "centroids")
            _eq(tc._sums, jc._sums, "sums")
            _eq(tc._counts, jc._counts, "counts")

    def ingest(self, tenant, docs):
        js = self.j.ingest(tenant, jnp.asarray(docs))
        ts = self.t.ingest(tenant, docs)
        _eq(ts, js, "slots")
        self.check_state()
        return js

    def delete(self, tenant, slots):
        self.j.delete(tenant, slots)
        self.t.delete(tenant, slots)
        self.check_state()

    def compact(self):
        jm = self.j.compact()
        tm = self.t.compact()
        _eq(tm, jm, "compaction mapping")
        self.check_state()
        return jm

    def set_cfg(self, **kw):
        self.j.cfg = dataclasses.replace(self.j.cfg, **kw)
        self.t.cfg = dataclasses.replace(self.t.cfg, **kw)

    def retrieve(self, q, tids):
        """q: numpy int8 (D,) or (B, D). Returns the reference's result
        as numpy after holding the port's to it."""
        jres = self.j.retrieve(jnp.asarray(q), tids)
        tres = self.t.retrieve(q, tids)
        assert self.t.last_plan == _port_plan(self.j.last_plan)
        for field in ("indices", "scores"):
            _eq(getattr(tres, field), getattr(jres, field), field)
        got_c = _np(tres.candidate_indices)
        want_c = np.asarray(jres.candidate_indices)
        assert got_c.shape == want_c.shape
        differ = np.atleast_2d(got_c != want_c)
        if differ.any():
            exempt = self._exempt(q, tids, want_c)
            self.exempted += int(exempt.sum())
            assert not (differ & ~exempt).any(), (
                "candidates differ outside the reference's near ties")
        return {f: np.asarray(getattr(jres, f))
                for f in ("indices", "scores", "candidate_indices")}

    def _exempt(self, q, tids, want_c):
        jq = jnp.atleast_2d(jnp.asarray(q))
        tids = np.atleast_1d(np.asarray(tids, np.int32))
        cfg = self.j.cfg
        if cfg.metric == "mips":
            return np.zeros(np.atleast_2d(want_c).shape, bool)
        if self.j.last_plan.kind == "cluster":
            policy = self.j.cluster_policy(tids)
            return _jax_exemptions(jq, self.j.arena.db(), policy, cfg)[1]
        return _masked_exempt(self.j, jq, tids, np.atleast_2d(want_c).shape[1])


def _port_plan(jplan):
    """The reference's SchedulePlan as the port's type (same fields)."""
    fields = dataclasses.asdict(jplan)
    fields["stages"] = tuple(StagePlan(**s) for s in fields["stages"])
    return SchedulePlan(**fields)


def qcodes(q):
    """Per-tensor INT8 query codes, as the reference's tests quantize."""
    return np.asarray(j_quantize(jnp.asarray(q))[0])


def build_pair(num_tenants=3, docs_per_tenant=40, capacity=256, k=3,
               noise=0.05, metric="cosine", backend="cuda"):
    pair = Pair(capacity, k=k, metric=metric, backend=backend)
    data = {}
    for t in range(num_tenants):
        docs, queries, gold = retrieval_corpus(
            docs_per_tenant, DIM, num_queries=6, seed=t, noise=noise)
        data[t] = (docs, queries, gold, pair.ingest(t, docs))
    return pair, data


# ---------------------------------------------------------------------------
# The reference's tests/test_tenancy.py cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_insert_retrieve_roundtrip(backend):
    pair, data = build_pair(backend=backend)
    for t, (docs, queries, gold, slots) in data.items():
        for j in range(3):
            res = pair.retrieve(qcodes(queries[j]), t)
            assert res["indices"][0] == slots[gold[j]]
    assert pair.t.last_plan.kind == "masked"
    tids = np.array([2, 0, 1, 0], np.int32)
    q = np.stack([qcodes(data[t][1][i]) for i, t in enumerate(tids)])
    res = pair.retrieve(q, tids)
    assert pair.t.last_plan.kind == "windowed"
    for i, t in enumerate(tids):
        assert res["indices"][i, 0] == data[t][3][data[t][2][i]]


def test_online_insert_visible_without_rebuild():
    pair, data = build_pair()
    new_doc = retrieval_corpus(1, DIM, num_queries=1, seed=99)[0]
    (slot,) = pair.ingest(1, new_doc)
    res = pair.retrieve(qcodes(new_doc[0]), 1)
    assert res["indices"][0] == slot
    assert pair.t.arena.stats.rebuilds == 0


def test_tombstoned_doc_never_returned():
    pair, data = build_pair()
    docs, queries, gold, slots = data[0]
    victim = int(slots[gold[0]])
    q = qcodes(queries[0])
    assert pair.retrieve(q, 0)["indices"][0] == victim
    pair.delete(0, [victim])
    res = pair.retrieve(q, 0)
    assert victim not in res["indices"]
    assert victim not in res["candidate_indices"]


def test_segment_isolation_even_for_identical_docs():
    docs, queries, gold = retrieval_corpus(30, DIM, num_queries=4, seed=0)
    pair = Pair(128)
    slots_a = pair.ingest(0, docs)
    slots_b = pair.ingest(1, docs)                  # identical corpus
    owner = pair.t.arena.owner.numpy()
    for j in range(4):
        for tenant, slots in ((0, slots_a), (1, slots_b)):
            got = pair.retrieve(qcodes(queries[j]), tenant)["indices"]
            got = got[got >= 0]
            assert np.all(owner[got] == tenant)
            assert got[0] == slots[gold[j]]


def test_unknown_tenant_gets_nothing():
    pair, _ = build_pair()
    q = qcodes(retrieval_corpus(1, DIM, 1, seed=5)[1][0])
    res = pair.retrieve(q, 42)
    assert np.all(res["indices"] == -1) and np.all(res["scores"] == 0)
    res = pair.retrieve(np.stack([q, q]), np.array([42, NO_TENANT], np.int32))
    assert np.all(res["indices"] == -1) and np.all(res["scores"] == 0)


def test_tenant_with_fewer_docs_than_k_pads_invalid():
    pair = Pair(64, k=5)
    docs = retrieval_corpus(2, DIM, num_queries=1, seed=3)[0]
    slots = pair.ingest(0, docs)
    got = pair.retrieve(qcodes(docs[0]), 0)["indices"]
    assert set(got[got >= 0]) <= {int(s) for s in slots}
    assert np.sum(got >= 0) == 2 and np.sum(got == -1) == 3
    got = pair.retrieve(qcodes(docs[:1]), np.array([0], np.int32))["indices"]
    assert np.sum(got >= 0) == 2


def test_compaction_preserves_results():
    pair, data = build_pair(num_tenants=3, docs_per_tenant=30)
    for t, (docs, queries, gold, slots) in data.items():
        victims = [int(s) for i, s in enumerate(slots)
                   if i not in set(gold[:4])][:5]
        pair.delete(t, victims)
    before = {(t, j): pair.retrieve(qcodes(data[t][1][j]), t)["indices"]
              for t in data for j in range(4)}
    live_before = pair.t.num_live
    mapping = pair.compact()
    assert pair.t.num_live == live_before
    for t in data:
        assert len(pair.t.table.segments(t)) == 1
    for (t, j), old in before.items():
        after = pair.retrieve(qcodes(data[t][1][j]), t)["indices"]
        np.testing.assert_array_equal(
            after, np.where(old >= 0, mapping[np.maximum(old, 0)], -1))


def test_windowed_and_fullscan_paths_agree():
    pair, data = build_pair(num_tenants=4, docs_per_tenant=40,
                            capacity=4096)
    tids = np.asarray([0, 1, 2, 3], np.int32)
    q = np.stack([qcodes(data[t][1][0]) for t in tids])
    fast = pair.retrieve(q, tids)
    assert pair.t.last_plan.kind == "windowed"
    assert pair.t.last_plan.rows_scanned == 64
    slow = tretrieval.batched_retrieve_masked(
        torch.from_numpy(q), pair.t.arena.db(), pair.t.arena.owner,
        torch.from_numpy(tids), pair.t.cfg, device="cpu")
    np.testing.assert_array_equal(fast["indices"][:, 0],
                                  slow.indices.numpy()[:, 0])
    for t in range(4):
        f = fast["scores"][t]
        np.testing.assert_array_equal(f[f != 0],
                                      slow.scores.numpy()[t][:len(f[f != 0])])


def test_mips_metric_masked():
    pair, data = build_pair(metric="mips")
    for t in (0, 1):
        docs, queries, gold, slots = data[t]
        res = pair.retrieve(qcodes(queries[0]), t)
        assert res["indices"][0] == slots[gold[0]]


def test_arena_full_and_compaction_reclaims():
    ja, ta = JArena(8, DIM), Arena(8, DIM, device="cpu")
    codes = np.ones((8, DIM), np.int8)
    slots = ta.insert(codes, 0)
    _eq(slots, ja.insert(jnp.asarray(codes), 0))
    with pytest.raises(ArenaFull):
        ta.insert(codes[:1], 0)
    with pytest.raises(JArenaFull):
        ja.insert(jnp.asarray(codes[:1]), 0)
    ta.delete(slots[:4])
    ja.delete(slots[:4])
    with pytest.raises(ArenaFull):               # tombstones NOT yet free
        ta.insert(codes[:1], 0)
    _eq(ta.compact(), ja.compact())
    _eq(ta.insert(codes[:4], 1), ja.insert(jnp.asarray(codes[:4]), 1))
    assert ta.num_live == 8 and ta.stats.rebuilds == 0
    assert_arena_equal(ta, ja)


def test_arena_rejects_negative_tenant_and_bad_dims():
    arena = Arena(8, DIM, device="cpu")
    with pytest.raises(ValueError):
        arena.insert(np.ones((1, DIM), np.int8), -1)
    with pytest.raises(ValueError):
        arena.insert(np.ones((1, DIM + 2), np.int8), 0)
    with pytest.raises(ValueError):                  # float rows: quantize!
        arena.insert(np.ones((1, DIM), np.float32), 0)
    with pytest.raises(ValueError):
        Arena(8, DIM + 1, device="cpu")
    assert arena.num_live == 0 and arena.generation == 0


def test_duplicate_and_repeated_delete_keeps_num_live_truthful():
    ja, ta = JArena(8, DIM), Arena(8, DIM, device="cpu")
    codes = np.ones((4, DIM), np.int8)
    slots = ta.insert(codes, 0)
    ja.insert(jnp.asarray(codes), 0)
    for victims in ([int(slots[0]), int(slots[0])], [int(slots[0])]):
        ta.delete(victims)
        ja.delete(victims)
        assert ta.num_live == 3
        assert_arena_equal(ta, ja)
    with pytest.raises(IndexError):
        ta.delete([5])                           # never allocated


def test_sentinel_tenant_ids_cannot_resurrect_tombstones():
    pair, data = build_pair()
    pair.delete(0, data[0][3][:4])
    q = qcodes(data[0][1][0])
    with pytest.raises(ValueError):
        pair.t.retrieve(q, -1)
    with pytest.raises(ValueError):
        pair.t.retrieve(q[None], np.asarray([-1], np.int32))
    with pytest.raises(KeyError):                # not tenant 1's slots
        pair.t.delete(1, data[0][3][4:5])


# ---------------------------------------------------------------------------
# Arena semantics the port states itself
# ---------------------------------------------------------------------------

def test_read_codes_out_of_range_follows_jnp_take():
    codes = np.arange(4 * DIM).reshape(4, DIM).astype(np.int8)
    ja, ta = JArena(8, DIM), Arena(8, DIM, device="cpu")
    ja.insert(jnp.asarray(codes), 0)
    ta.insert(codes, 0)
    for slots in ([0, 3], [9, 1], [-1, 2], [-8, -9, 100], [7]):
        _eq(ta.read_codes(slots), ja.read_codes(slots), str(slots))
    assert (ta.read_codes([8]).numpy() == -1).all()


def test_db_aliases_the_live_planes():
    """The port mutates in place: a view taken before a mutation shows
    it (the reference's view is a snapshot of its generation)."""
    ta = Arena(8, DIM, device="cpu")
    db = ta.db()
    slots = ta.insert(np.ones((2, DIM), np.int8), 0)
    assert ta.db() is db and int(db.norms_sq[1]) == DIM
    ta.delete(slots[:1])
    assert int(db.norms_sq[0]) == 0 and int(db.msb_plane[0].sum()) == 0
    ta.compact()
    assert int(db.norms_sq[0]) == DIM and int(db.norms_sq[1]) == 0


# ---------------------------------------------------------------------------
# Random mutation histories (as tests/test_arena_properties.py)
# ---------------------------------------------------------------------------

P_DIM, P_CAPACITY, P_TENANTS = 16, 64, 3

ops = st.lists(
    st.tuples(st.sampled_from(["insert", "delete", "compact"]),
              st.integers(0, P_TENANTS - 1),
              st.integers(1, 6)),
    min_size=1, max_size=40)


def make_codes(counter: int, rows: int) -> np.ndarray:
    base = np.arange(P_DIM, dtype=np.int64) * 31
    out = [((base + (counter + r) * 17) % 255 - 127) for r in range(rows)]
    return np.asarray(out, np.int8)


@given(ops)
@settings(max_examples=12, deadline=None)
def test_arena_state_matches_reference_under_random_mutation(op_seq):
    ja, ta = JArena(P_CAPACITY, P_DIM), Arena(P_CAPACITY, P_DIM,
                                              device="cpu")
    model: dict[int, int] = {}           # slot -> tenant
    counter = 0
    for op, tenant, amount in op_seq:
        if op == "insert":
            codes = make_codes(counter, amount)
            if amount > ta.num_free:
                with pytest.raises(ArenaFull):
                    ta.insert(codes, tenant)
                continue
            slots = ta.insert(codes, tenant)
            _eq(slots, ja.insert(jnp.asarray(codes), tenant), "slots")
            labels = [tenant % 2] * amount
            ta.set_labels(slots, labels)
            ja.set_labels(slots, labels)
            model.update({int(s): tenant for s in slots})
            counter += amount
        elif op == "delete":
            mine = sorted(s for s, t in model.items() if t == tenant)
            victims = mine[:amount] + mine[:1]      # a duplicate id too
            ta.delete(victims)
            ja.delete(victims)
            for s in mine[:amount]:
                del model[s]
        else:
            mapping = ta.compact()
            _eq(mapping, ja.compact(), "compaction mapping")
            model = {int(mapping[s]): t for s, t in model.items()}
        assert_arena_equal(ta, ja)
    if model:
        _eq(ta.read_codes(sorted(model)), ja.read_codes(sorted(model)))
    q = make_codes(counter + 1000, 1)[0]
    jres = j_two_stage_masked(jnp.asarray(q), ja.db(), ja.owner,
                              jnp.int32(0), JConfig(k=3))
    tres = tretrieval.two_stage_retrieve_masked(
        torch.from_numpy(q), ta.db(), ta.owner, 0, RetrievalConfig(k=3),
        device="cpu")
    for field in ("indices", "scores", "candidate_indices"):
        _eq(getattr(tres, field), getattr(jres, field), field)
    got = tres.indices.numpy()
    assert all(model.get(int(s)) == 0 for s in got[got >= 0])


# ---------------------------------------------------------------------------
# The clustered index, and state carried across from the reference
# ---------------------------------------------------------------------------

CLUSTERS = dict(num_clusters=4, nprobe=2, block_rows=16)


def _clustered_docs(tenant, n=48):
    return retrieval_corpus(n, DIM, num_queries=6, seed=10 + tenant,
                            noise=0.05, cluster_size=12, cluster_spread=0.3)


def _cluster_batch(pair, data, tids):
    q = np.stack([qcodes(data[t][1][i]) for i, t in enumerate(tids)])
    res = pair.retrieve(q, tids)
    assert pair.t.last_plan.kind == "cluster"
    _eq(pair.t.cluster_layout(tids)[1], pair.j.cluster_layout(tids)[1],
        "cluster block tables")
    return res


def test_clustered_index_matches_reference():
    pair = Pair(512, clusters=CLUSTERS)
    data = {}
    for t in range(3):
        docs, queries, gold = _clustered_docs(t)
        data[t] = (docs, queries, gold, pair.ingest(t, docs))
    tids = np.array([0, 1, 2, 1, 0, 2], np.int32)
    hits = lambda res: sum(  # noqa: E731
        int(data[t][3][data[t][2][i]] in res["indices"][i])
        for i, t in enumerate(tids))
    assert hits(_cluster_batch(pair, data, tids)) == len(tids)
    for t in range(3):
        assert pair.t.cluster_rows(t).keys() == pair.j.cluster_rows(t).keys()
        for c, rows in pair.j.cluster_rows(t).items():
            _eq(pair.t.cluster_rows(t)[c], rows, "cluster rows")
    pair.delete(1, data[1][3][40:44])
    mapping = pair.compact()
    data = {t: (d, q, g, mapping[s]) for t, (d, q, g, s) in data.items()}
    for kw in (dict(metric="mips"), dict(metric="cosine", prescreen_c0=16)):
        pair.set_cfg(**kw)
        assert hits(_cluster_batch(pair, data, tids)) == len(tids)
    print(f"clustered index: {pair.exempted} candidate positions exempted")


def test_state_carried_from_the_reference_continues_on_the_port():
    pair = Pair(512, clusters=CLUSTERS)
    data = {t: _clustered_docs(t) for t in range(3)}
    slots = {t: pair.ingest(t, data[t][0][:30]) for t in (0, 1)}
    pair.delete(0, slots[0][:5])
    ja, jc = pair.j.arena, pair.j.clusters
    port = MultiTenantIndex(512, DIM, pair.t.cfg,
                            clusters=ClusterParams(**CLUSTERS), device="cpu")
    port.arena = convert.arena(
        *(np.asarray(x) for x in (ja.msb_plane, ja.lsb_plane, ja.sign_plane,
                                  ja.norms_sq, ja.owner)),
        ja.cluster_labels, next_slot=ja._next, tombstones=ja._tombstones,
        generation=ja.generation, stats=dataclasses.asdict(ja.stats),
        scale=np.asarray(ja.scale), device="cpu")
    port.clusters = convert.cluster_index(
        jc._centroids, jc._sums, jc._counts, generation=jc.generation,
        seed=jc.seed, iters=jc.iters, device="cpu")
    for t in pair.j.table.tenant_ids:
        port.table.record_insert(t, pair.j.table.slots(t))
    pair.t = port
    pair.check_state()
    pair.ingest(2, data[2][0])                   # the history goes on
    pair.ingest(0, data[0][0][30:])
    pair.delete(1, slots[1][10:12])
    pair.compact()
    tids = np.array([0, 1, 2], np.int32)
    _cluster_batch(pair, {t: (None, data[t][1], None, None) for t in tids},
                   tids)


# ---------------------------------------------------------------------------
# Placement and import hygiene
# ---------------------------------------------------------------------------

def test_placement_matches_reference():
    tp, jp = PlacementTable(range(6), spread=2), JPlacement(range(6),
                                                             spread=2)
    for t in range(40):
        assert tp.owners(t) == jp.owners(t)
        assert tp.doc_shard(t, t * 7) == jp.doc_shard(t, t * 7)
    assert tp.table() == jp.table()
    assert tp.remove_shard(3) == jp.remove_shard(3)
    assert tp.table() == jp.table() and tp.live_shards == jp.live_shards
    with pytest.raises(ValueError):
        tp.owners(-1)


def test_tenancy_and_obs_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.tenancy, repro_torch.obs\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
