"""The port's cluster-pruned cascade against the JAX engine on the golden
corpus of tests/test_recall_regression.py (N=4096, D=256, clusters of 64,
BLOCK_ROWS 64, NPROBE 8): cosine, MIPS and the sign prescreen at
C0 in {512, 256, 128, 64, 32}, on both of the port's backends, and the
golden pins from the port alone.

Final indices and scores must be bit-identical. The selected clusters and
the stage-1 candidates must be identical too, except where the JAX run's
own f32 cosine keys (centroid or stage 1) sit within 2 ulp of a rank
neighbour: the rsqrt rounding divergence of ROADMAP queue C. Each test
reports how many positions it exempted.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import BitPlanarDB as JBitPlanarDB
from repro.core import RetrievalConfig as JConfig
from repro.core import bitplanar as jbitplanar
from repro.core import build_database as j_build
from repro.core import clustering as jclustering
from repro.core import engine as jengine
from repro.core import quantize_int8 as j_quantize
from repro.core import similarity as jsim
from repro.data import retrieval_corpus
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.core.bitplanar import BitPlanarDB
from repro_torch.core.quantization import build_database, quantize_int8
from repro_torch.core.retrieval import (RetrievalConfig,
                                        cluster_pruned_retrieve)
from test_torch_engine import _exempt

N, D, Q, K = 4096, 256, 80, 5
CSIZE, BLOCK_ROWS, NPROBE = 64, 64, 8
SEED = 1234
GOLDEN_HITS = 80
GOLDEN_CASCADE_INDEX_SUM = 881698
GOLDEN_CASCADE_SCORE_SUM = 119156404
PRESCREEN_VIEW = NPROBE * BLOCK_ROWS
GOLDEN_PRESCREEN_HITS = {512: 80, 256: 80, 128: 80, 64: 80, 32: 80}
PRESCREEN_BIT_IDENTICAL_DOWN_TO = 64


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# The slice on the golden corpus
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    docs, queries, gold = retrieval_corpus(
        N, D, num_queries=Q, noise=0.1, cluster_size=CSIZE,
        cluster_spread=0.2, seed=SEED)
    jdb = JBitPlanarDB.from_quantized(j_build(jnp.asarray(docs)))
    jq, _ = j_quantize(jnp.asarray(queries), per_vector=True)
    db = BitPlanarDB.from_quantized(build_database(docs, device="cpu"))
    q, _ = quantize_int8(torch.from_numpy(queries), per_vector=True)
    labels = (np.arange(N) // CSIZE).astype(np.int32)
    nc = int(labels[-1]) + 1
    centers = np.stack([docs[labels == c].mean(axis=0) for c in range(nc)])
    cents, _ = j_quantize(jnp.asarray(centers.astype(np.float32)))
    jcb = jclustering.ClusterCodebook.from_codes(cents)
    cb = convert.cluster_codebook(*(np.asarray(x) for x in (
        jcb.codes, jcb.msb_plane, jcb.norms_sq)), device="cpu")
    table = jclustering.block_table(labels, nc, BLOCK_ROWS)
    return dict(gold=gold, jdb=jdb, jq=jq, db=db, q=q, labels=labels,
                jcb=jcb, cb=cb, table=table)


def _port(g, cfg):
    return cluster_pruned_retrieve(g["q"], g["db"], g["cb"], g["table"],
                                   g["labels"], cfg, nprobe=NPROBE,
                                   block_rows=BLOCK_ROWS, device="cpu")


def _port_policy(g):
    return tengine.ClusterPolicy(
        owner=torch.zeros(N, dtype=torch.int32),
        tenant_ids=torch.zeros(Q, dtype=torch.int32),
        labels=_t(g["labels"]), centroid_msb=g["cb"].msb_plane,
        centroid_norms=g["cb"].norms_sq, cluster_blocks=_t(g["table"]),
        nprobe=NPROBE, block_rows=BLOCK_ROWS)


def _jax_policy(g, b):
    return jengine.ClusterPolicy(
        owner=jnp.zeros(N, jnp.int32), tenant_ids=jnp.zeros(b, jnp.int32),
        labels=jnp.asarray(g["labels"]), centroid_msb=g["jcb"].msb_plane,
        centroid_norms=g["jcb"].norms_sq,
        cluster_blocks=jnp.asarray(g["table"]), nprobe=NPROBE,
        block_rows=BLOCK_ROWS)


def _jax_exemptions(jq, jdb, policy, jcfg):
    """Run the reference's own stages and return its near-tie positions:
    (B, nprobe) over the selected clusters and (B, C) over the stage-1
    candidates (a lane whose cluster choice sits on a near-tie has every
    candidate exempted, since its whole view may change)."""
    ctx = jengine._CascadeCtx(
        query_codes=jq, q_msb=jq >> 4, db=jdb, policy=policy, cfg=jcfg,
        fns=jengine.stage_fns("jnp"),
        q_sign=(jbitplanar.sign_pm1(jq) if jcfg.prescreen_c0 is not None
                else None))
    state = jengine._CascadeState()
    for stage in jengine.cascade_stages(policy, jcfg)[:-2]:
        state = stage.run(state, ctx)
    nprobe = state.top_clusters.shape[1]
    b = jq.shape[0]
    if jcfg.metric == "mips":
        return np.zeros((b, nprobe), bool), None
    cscores = jengine.stage1_plane_batched_jnp(ctx.q_msb,
                                               policy.centroid_msb)
    ckeys = jsim.cosine_key_f32(cscores, policy.centroid_norms)
    k_clusters = policy.centroid_msb.shape[0]
    ckeys, _ = jax.lax.top_k(ckeys, min(nprobe + 1, k_clusters))
    c_ex = _exempt(np.asarray(ckeys))
    if c_ex.shape[1] < nprobe:
        c_ex = np.pad(c_ex, ((0, 0), (0, nprobe - c_ex.shape[1])))
    safe = jnp.maximum(state.rows, 0)
    if state.block_ids is not None:
        s1 = jengine.stage1_gather_batched_jnp(
            ctx.q_msb, jdb.msb_plane, state.block_ids,
            block_rows=policy.block_rows)
    else:
        s1 = jengine.stage1_rows_batched_jnp(ctx.q_msb,
                                             jdb.msb_plane[safe])
    key1 = jnp.where(state.member,
                     jsim.cosine_key_f32(s1, jdb.norms_sq[safe]), -jnp.inf)
    c = min(jcfg.num_candidates(jdb.num_docs), state.rows.shape[1])
    keys1, _ = jax.lax.top_k(key1, min(c + 1, key1.shape[1]))
    keys1 = np.asarray(keys1)
    if keys1.shape[1] == c:                      # the whole view: no boundary
        keys1 = np.concatenate([keys1, np.full((b, 1), -np.inf, np.float32)],
                               axis=1)
    cand_ex = _exempt(keys1) | c_ex.any(axis=1, keepdims=True)
    return c_ex, cand_ex


def _assert_matches(res, top, jres, jtop, exempt, request, label):
    """Bit-identical indices and scores; clusters and candidates identical
    outside the reference's near-tie positions, which are reported."""
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    np.testing.assert_array_equal(res.scores.numpy(),
                                  np.asarray(jres.scores))
    assert res.indices.dtype == torch.int32
    c_ex, cand_ex = exempt
    got_c, want_c = res.candidate_indices.numpy(), np.asarray(
        jres.candidate_indices)
    assert got_c.shape == want_c.shape
    if cand_ex is None:
        cand_ex = np.zeros(want_c.shape, bool)
    differ_t = top.numpy() != np.asarray(jtop)
    differ_c = got_c != want_c
    exempted = int(c_ex.sum() + cand_ex.sum())
    request.node.user_properties += [("exempt_positions", exempted),
                                     ("differing_positions",
                                      int(differ_t.sum() + differ_c.sum()))]
    print(f"{label}: {int(c_ex.sum())} cluster and {int(cand_ex.sum())} "
          f"candidate positions exempted, {int(differ_t.sum())} and "
          f"{int(differ_c.sum())} differ")
    assert not (differ_t & ~c_ex).any()
    assert not (differ_c & ~cand_ex).any()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("metric", ["cosine", "mips"])
def test_cascade_matches_reference_on_golden_corpus(golden, metric, backend,
                                                    request):
    g = golden
    cfg = RetrievalConfig(k=K, metric=metric, backend=backend)
    jcfg = JConfig(k=K, metric=metric)
    res, top = tengine.RetrievalEngine(cfg, "cpu").retrieve_with_clusters(
        g["q"], g["db"], _port_policy(g))
    jpol = _jax_policy(g, Q)
    jres, jtop = jengine.RetrievalEngine(jcfg).retrieve_with_clusters(
        g["jq"], g["jdb"], jpol)
    assert top.dtype == torch.int32 and top.shape == (Q, NPROBE)
    _assert_matches(res, top, jres, jtop,
                    _jax_exemptions(g["jq"], g["jdb"], jpol, jcfg), request,
                    f"{metric}/{backend}")
    wrapped = _port(g, cfg)
    for f in ("indices", "scores", "candidate_indices"):
        assert torch.equal(getattr(wrapped, f), getattr(res, f))
    # without a prune stage there is no selection to report
    _, none = tengine.RetrievalEngine(cfg, "cpu").retrieve_with_clusters(
        g["q"], g["db"], tengine.PlainPolicy())
    assert none is None


def test_golden_cascade_pins_from_the_port_alone(golden):
    g = golden
    res = _port(g, RetrievalConfig(k=K))
    idx = res.indices.numpy()
    assert sum(g["gold"][i] in idx[i] for i in range(Q)) == GOLDEN_HITS
    assert int(res.indices.long().sum()) == GOLDEN_CASCADE_INDEX_SUM
    assert int(res.scores.long().sum()) == GOLDEN_CASCADE_SCORE_SUM


@pytest.mark.parametrize("c0", sorted(GOLDEN_PRESCREEN_HITS))
def test_prescreen_sweep_matches_reference_and_pins(golden, c0, request):
    g = golden
    cfg = RetrievalConfig(k=K, prescreen_c0=c0)
    jcfg = JConfig(k=K, prescreen_c0=c0)
    jpol = _jax_policy(g, Q)
    jres, jtop = jengine.RetrievalEngine(jcfg).retrieve_with_clusters(
        g["jq"], g["jdb"], jpol)
    exempt = _jax_exemptions(g["jq"], g["jdb"], jpol, jcfg)
    for backend in ("torch", "cuda"):
        res, top = tengine.RetrievalEngine(
            dataclasses.replace(cfg, backend=backend),
            "cpu").retrieve_with_clusters(g["q"], g["db"], _port_policy(g))
        _assert_matches(res, top, jres, jtop, exempt, request,
                        f"c0={c0}/{backend}")
        idx = res.indices.numpy()
        assert sum(g["gold"][i] in idx[i] for i in range(Q)) == \
            GOLDEN_PRESCREEN_HITS[c0]
        if c0 >= PRESCREEN_BIT_IDENTICAL_DOWN_TO:
            assert int(res.indices.long().sum()) == GOLDEN_CASCADE_INDEX_SUM
            assert int(res.scores.long().sum()) == GOLDEN_CASCADE_SCORE_SUM


def test_prescreen_of_the_whole_view_is_the_prescreen_off_cascade(golden):
    """c0 >= the view deletes nothing, and a DB without its sign plane
    derives it from the nibble plane: both are bit-identical to the
    prescreen-off cascade."""
    g = golden
    off = _port(g, RetrievalConfig(k=K))
    no_sign = dict(g, db=dataclasses.replace(g["db"], sign_plane=None))
    for backend in ("torch", "cuda"):
        cfg = RetrievalConfig(k=K, prescreen_c0=PRESCREEN_VIEW,
                              backend=backend)
        for gg in (g, no_sign):
            on = _port(gg, cfg)
            for f in ("indices", "scores", "candidate_indices"):
                assert torch.equal(getattr(on, f), getattr(off, f))


