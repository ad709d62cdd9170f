"""The port of `core/clustering.py` and the cluster-pruned cascade on small
clustered arenas, against the JAX reference on the CPU: k-means,
assignment, block tables and the online ClusterIndex; the cascade cases
of tests/test_engine.py (backend parity, nprobe = K, no duplicate rows,
the plan ledger) and per-lane (B, K, MB) tables with several tenants.
Results must be bit-identical to the reference's."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.core import BitPlanarDB as JBitPlanarDB
from repro.core import RetrievalConfig as JConfig
from repro.core import build_database as j_build
from repro.core import clustering as jclustering
from repro.core import engine as jengine
from repro.core import quantize_int8 as j_quantize
from repro.core.retrieval import batched_retrieve as j_batched_retrieve
from repro.core.retrieval import cluster_pruned_retrieve as j_cluster_retrieve
from repro_torch import convert
from repro_torch.core import clustering
from repro_torch.core import engine as tengine
from repro_torch.core.bitplanar import BitPlanarDB
from repro_torch.core.quantization import build_database, quantize_int8
from repro_torch.core.retrieval import (NO_TENANT, RetrievalConfig,
                                        batched_retrieve,
                                        cluster_pruned_retrieve)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _codes(n, d, seed):
    return np.random.default_rng(seed).integers(-128, 128,
                                                (n, d)).astype(np.int8)


# ---------------------------------------------------------------------------
# clustering.py
# ---------------------------------------------------------------------------

def test_assign_codes_matches_reference_and_breaks_ties_low():
    codes, cents = _codes(300, 32, 1), _codes(9, 32, 2)
    np.testing.assert_array_equal(
        clustering.assign_codes(codes, cents),
        jclustering.assign_codes(codes, cents))
    # duplicated centroids tie exactly: both packages pick the lower index
    dup = np.concatenate([cents[:3], cents[:3], cents[3:]])
    got = clustering.assign_codes(codes, dup)
    np.testing.assert_array_equal(got, jclustering.assign_codes(codes, dup))
    assert not np.isin(got, [3, 4, 5]).any()
    # tensors are scored where they lie
    np.testing.assert_array_equal(
        clustering.assign_codes(_t(codes), _t(dup)), got)


def test_kmeans_matches_reference():
    codes = _codes(400, 32, 3)
    got_c, got_l = clustering.kmeans_int8(codes, 8, iters=4, seed=0)
    want_c, want_l = jclustering.kmeans_int8(codes, 8, iters=4, seed=0)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_l, want_l)
    assert got_c.dtype == np.int8 and got_l.dtype == np.int32
    small_c, _ = clustering.kmeans_int8(codes[:3], 16, iters=2)
    assert small_c.shape == (3, 32)


@pytest.mark.parametrize("kw", [
    dict(), dict(pad_pow2=False), dict(min_blocks=8),
    dict(rows=np.arange(3, 500, 3)), dict(rows=np.arange(0, 200)),
])
def test_block_table_matches_reference(kw):
    rng = np.random.default_rng(4)
    labels = rng.integers(-1, 6, 517).astype(np.int32)
    labels[rng.integers(0, 517, 40)] = 9          # out of range: skipped
    got = clustering.block_table(labels, 6, 32, **kw)
    want = jclustering.block_table(labels, 6, 32, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    order = clustering.cluster_grouped_order(labels)
    np.testing.assert_array_equal(
        order, jclustering.cluster_grouped_order(labels))


def test_cluster_index_sequence_matches_reference():
    tci = clustering.ClusterIndex(4, 32, seed=1, iters=3, device="cpu")
    jci = jclustering.ClusterIndex(4, 32, seed=1, iters=3)
    with pytest.raises(RuntimeError):
        tci.codebook()
    a, b, c = _codes(60, 32, 5), _codes(20, 32, 6), _codes(300, 32, 7)
    steps = [("add", a), ("add", b), ("remove", b[:7]), ("refresh", None),
             ("refresh", None), ("add", c), ("refresh", None)]
    labels = {}
    for op, x in steps:
        if op == "add":
            lt, lj = tci.add(x), jci.add(x)
            np.testing.assert_array_equal(lt, lj)
            labels[id(x)] = lt
        elif op == "remove":
            tci.remove(x, labels[id(b)][:7])
            jci.remove(x, labels[id(b)][:7])
        else:
            tci.refresh()
            jci.refresh()
        assert tci.generation == jci.generation
        np.testing.assert_array_equal(tci._centroids, jci._centroids)
        np.testing.assert_array_equal(tci._counts, jci._counts)
        np.testing.assert_array_equal(tci._sums, jci._sums)
        cb, jcb = tci.codebook(), jci.codebook()
        for f in ("codes", "msb_plane", "norms_sq"):
            np.testing.assert_array_equal(getattr(cb, f).numpy(),
                                          np.asarray(getattr(jcb, f)))
    first = tci.codebook()
    assert tci.codebook() is first
    assert first.num_clusters == 4 and first.dim == 32


def test_codebook_entry_points_need_cuda_or_an_explicit_cpu():
    cents = _codes(5, 32, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            clustering.ClusterCodebook.from_codes(cents)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.cluster_codebook(cents, np.zeros((5, 16), np.uint8),
                                     np.zeros(5, np.int32))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cluster_pruned_retrieve(
                torch.zeros((1, 32), dtype=torch.int8), None, None,
                np.zeros((5, 1), np.int32), np.zeros(8, np.int32),
                RetrievalConfig(), nprobe=1, block_rows=8)
    jcb = jclustering.ClusterCodebook.from_codes(cents)
    cb = convert.cluster_codebook(*(np.asarray(x) for x in (
        jcb.codes, jcb.msb_plane, jcb.norms_sq)), device="cpu")
    own = clustering.ClusterCodebook.from_codes(cents, device="cpu")
    for f in ("codes", "msb_plane", "norms_sq"):
        np.testing.assert_array_equal(getattr(cb, f).numpy(),
                                      getattr(own, f).numpy())
    with pytest.raises(TypeError, match="norms_sq"):
        convert.cluster_codebook(cents, np.asarray(jcb.msb_plane),
                                 np.zeros(5, np.int64), device="cpu")


# ---------------------------------------------------------------------------
# Small clustered arenas (the cases of tests/test_engine.py)
# ---------------------------------------------------------------------------

DIM = 64


def _clustered(n=512, k_clusters=16, block_rows=32, seed=0):
    """One corpus in cluster-grouped order for both packages."""
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n, DIM)).astype(np.float32)
    jqdb = j_build(jnp.asarray(docs))
    cents, labels = jclustering.kmeans_int8(np.asarray(jqdb.values),
                                            k_clusters, iters=4, seed=seed)
    order = jclustering.cluster_grouped_order(labels)
    docs = docs[order]
    labels = labels[order]
    table = jclustering.block_table(labels, k_clusters, block_rows)
    qf = rng.normal(size=(4, DIM)).astype(np.float32)
    jq, _ = j_quantize(jnp.asarray(qf), per_vector=True)
    q, _ = quantize_int8(torch.from_numpy(qf), per_vector=True)
    return dict(
        jdb=JBitPlanarDB.from_quantized(j_build(jnp.asarray(docs))),
        db=BitPlanarDB.from_quantized(build_database(docs, device="cpu")),
        jcb=jclustering.ClusterCodebook.from_codes(cents),
        cb=clustering.ClusterCodebook.from_codes(cents, device="cpu"),
        table=table, labels=labels, jq=jq, q=q, block_rows=block_rows)


def _both(c, cfg, nprobe, **kw):
    res = cluster_pruned_retrieve(c["q"], c["db"], c["cb"], c["table"],
                                  c["labels"], cfg, nprobe=nprobe,
                                  block_rows=c["block_rows"], device="cpu",
                                  **kw)
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    jcfg = JConfig(k=cfg.k, metric=cfg.metric,
                   max_candidates=cfg.max_candidates,
                   prescreen_c0=cfg.prescreen_c0)
    jres = j_cluster_retrieve(c["jq"], c["jdb"], c["jcb"], c["table"],
                              c["labels"], jcfg, nprobe=nprobe,
                              block_rows=c["block_rows"], **jkw)
    return res, jres


def _equal(res, jres):
    for f in ("indices", "scores", "candidate_indices"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)))


@pytest.mark.parametrize("metric", ["cosine", "mips"])
@pytest.mark.parametrize("nprobe", [2, 16])
def test_cluster_backend_parity_and_reference(metric, nprobe):
    c = _clustered()
    cfg = RetrievalConfig(k=5, metric=metric, backend="torch")
    res, jres = _both(c, cfg, nprobe)
    _equal(res, jres)
    res_k, _ = _both(c, dataclasses.replace(cfg, backend="cuda"), nprobe)
    _equal(res_k, jres)


def test_nprobe_k_recovers_the_full_scan():
    c = _clustered(n=256, k_clusters=8)
    cfg = RetrievalConfig(k=5, max_candidates=256)
    full = batched_retrieve(c["q"], c["db"], cfg, device="cpu")
    pruned, jpruned = _both(c, cfg, 8)
    _equal(pruned, jpruned)
    jfull = j_batched_retrieve(c["jq"], c["jdb"], JConfig(
        k=5, max_candidates=256))
    np.testing.assert_array_equal(full.indices.numpy(),
                                  np.asarray(jfull.indices))
    for i in range(4):
        assert set(full.indices[i].tolist()) == set(
            pruned.indices[i].tolist())
        assert torch.equal(full.scores[i], pruned.scores[i])


def test_cluster_cascade_never_duplicates_rows():
    c = _clustered(n=300, k_clusters=8)
    res, jres = _both(c, RetrievalConfig(k=10, max_candidates=300), 8)
    _equal(res, jres)
    for lane in res.indices.numpy():
        live = lane[lane >= 0]
        assert len(live) == len(set(live.tolist()))


@pytest.mark.parametrize("c0", [None, 32])
def test_cluster_plan_for_matches_reference(c0):
    c = _clustered(n=512, k_clusters=16, block_rows=32)
    kw = dict(labels=c["labels"], cluster_blocks=c["table"], nprobe=2,
              block_rows=32)
    pol = tengine.ClusterPolicy(
        owner=torch.zeros(512, dtype=torch.int32),
        tenant_ids=torch.zeros(4, dtype=torch.int32),
        centroid_msb=c["cb"].msb_plane, centroid_norms=c["cb"].norms_sq,
        **{k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    jpol = jengine.ClusterPolicy(
        owner=jnp.zeros(512, jnp.int32), tenant_ids=jnp.zeros(4, jnp.int32),
        centroid_msb=c["jcb"].msb_plane, centroid_norms=c["jcb"].norms_sq,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    got = tengine.RetrievalEngine(RetrievalConfig(k=5, prescreen_c0=c0),
                                  "cpu").plan_for(c["db"], 4, pol)
    want = jengine.RetrievalEngine(JConfig(k=5, prescreen_c0=c0)).plan_for(
        c["jdb"], 4, jpol)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    names = ["prune", "approx", "exact"] if c0 is None else \
        ["prune", "prescreen", "approx", "exact"]
    assert [s.name for s in got.stages] == names
    assert tengine.probe_rows(pol) == jengine.probe_rows(jpol)


def test_plan_for_refuses_a_foreign_policy():
    """Every retrieval policy of the reference is ported (the slab and view
    policies with the serving runtime): a type that is no retrieval policy
    is refused by name."""
    class ForeignPolicy:
        pass
    eng = tengine.RetrievalEngine(RetrievalConfig(), "cpu")
    db = BitPlanarDB.from_quantized(build_database(
        np.ones((8, 16), np.float32), device="cpu"))
    with pytest.raises(TypeError, match="ForeignPolicy is not a retrieval "
                                        "policy"):
        eng.plan_for(db, 2, ForeignPolicy())


def test_plan_for_takes_the_view_policy():
    """`ViewPolicy`, refused before the serving slice, plans and schedules
    as the reference's: it enters the cascade at the scan."""
    eng = tengine.RetrievalEngine(RetrievalConfig(), "cpu")
    db = BitPlanarDB.from_quantized(build_database(
        np.ones((8, 16), np.float32), device="cpu"))
    view = tengine.ViewPolicy(
        rows=torch.arange(8, dtype=torch.int32).repeat(2, 1),
        member=torch.ones((2, 8), dtype=torch.bool),
        msb_rows=db.msb_plane.repeat(2, 1, 1))
    assert eng.plan_for(db, 2, view).kind == "view"
    assert tengine.cascade_stages(view, RetrievalConfig()) == (
        tengine.ApproxScan(), tengine.ExactRescore())


def _tenant_arena(seed=3):
    """Three tenants interleaved in runs over one clustered arena, some dead
    rows (owner -1, label -1), per-lane (B, K, MB) tables built with
    `block_table(..., rows=tenant_rows)`, and a NO_TENANT lane."""
    c = _clustered(n=512, k_clusters=8, block_rows=32, seed=seed)
    rng = np.random.default_rng(seed)
    owner = (np.arange(512) // 48 % 3).astype(np.int32)
    dead = rng.choice(512, 40, replace=False)
    owner[dead] = -1
    labels = c["labels"].copy()
    labels[dead] = -1
    tids = np.array([0, 2, NO_TENANT, 1], np.int32)
    mb = max(jclustering.block_table(labels, 8, 32, rows=np.nonzero(
        owner == t)[0], pad_pow2=False).shape[1] for t in range(3))
    tables = np.stack([
        jclustering.block_table(labels, 8, 32, min_blocks=mb,
                                rows=np.nonzero(owner == t)[0])
        for t in tids])
    for t, table in zip(tids, tables):
        np.testing.assert_array_equal(table, clustering.block_table(
            labels, 8, 32, min_blocks=mb, rows=np.nonzero(owner == t)[0]))
    return dict(c, labels=labels, table=tables), owner, tids


@pytest.mark.parametrize("c0", [None, 24])
@pytest.mark.parametrize("metric", ["cosine", "mips"])
def test_per_lane_tables_match_reference_and_isolate_tenants(metric, c0):
    c, owner, tids = _tenant_arena()
    for backend in ("torch", "cuda"):
        cfg = RetrievalConfig(k=5, metric=metric, prescreen_c0=c0,
                              backend=backend)
        res, jres = _both(c, cfg, 3, owner=_t(owner), tenant_ids=_t(tids))
        _equal(res, jres)
        ids = res.indices.numpy()
        for i, t in enumerate(tids):
            live = ids[i][ids[i] >= 0]
            if t < 0:
                assert live.size == 0
            else:
                assert live.size and (owner[live] == t).all()
        cand = res.candidate_indices.numpy()
        assert (owner[cand[cand >= 0]] >= 0).all()


def test_owner_and_tenant_ids_go_together():
    c = _clustered()
    with pytest.raises(ValueError, match="together"):
        cluster_pruned_retrieve(c["q"], c["db"], c["cb"], c["table"],
                                c["labels"], RetrievalConfig(), nprobe=2,
                                block_rows=32, owner=torch.zeros(
                                    512, dtype=torch.int32), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cluster_pruned_retrieve(c["q"], c["db"], c["cb"], c["table"],
                                    c["labels"], RetrievalConfig(), nprobe=2,
                                    block_rows=32)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine.RetrievalEngine(RetrievalConfig())
    eng = tengine.RetrievalEngine(RetrievalConfig(), "cpu")
    pol = tengine.ClusterPolicy(
        owner=torch.zeros(512, dtype=torch.int32),
        tenant_ids=torch.zeros(4, dtype=torch.int32),
        labels=_t(c["labels"]).to("meta"), centroid_msb=c["cb"].msb_plane,
        centroid_norms=c["cb"].norms_sq, cluster_blocks=_t(c["table"]),
        nprobe=2, block_rows=32)
    with pytest.raises(ValueError, match="engine runs on"):
        eng.retrieve_with_clusters(c["q"], c["db"], pol)
