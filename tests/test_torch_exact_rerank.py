"""The engine's exact stage as one kernel (`csrc/stage2_rerank.cu`): its
plain version against the reference's stage (src/repro/core/engine.py,
`ExactRescore.run`: `jnp.take` of the planes and norms, the Pallas exact
kernel in interpret mode, the pins, `jax.vmap(rerank_dense_comparator)` or
`jax.lax.top_k`, the result's masking) bit for bit on the same numpy
inputs; the kernel's ranking rule and its pair loop emulated in plain
Python against the plain comparator; and the wrappers' CUDA branch run on
CPU tensors up to the launch (one launch per engine stage, S + 1 per
sharded batch, refusals that name the operand). The kernel itself runs in
test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import similarity as jsim
from repro.core.engine import MASKED_SCORE as J_MASKED_SCORE
from repro.kernels import ops as jops
from repro.kernels.stage2_int8 import stage2_int8_batched_pallas
from repro_torch.core import engine as eng
from repro_torch.core import similarity as tsim
from repro_torch.core.engine import MASKED_SCORE
from repro_torch.core.index import ShardedIndex
from repro_torch.core.retrieval import RetrievalConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.stage2_int8 import METRICS
from repro_torch.launch.mesh import make_test_mesh
from test_torch_kernels import _capture_launches
from test_torch_primitives import _fraction_cases

INT32_MIN = -(2 ** 31)
THREADS = 1024          # kThreads of csrc/stage2_rerank.cu


def _case(b, c, d, seed, masked):
    """Planes, queries, ids (holes at -1 under a mask, duplicates for
    ties), norms (some zero) and, when `masked`, a membership mask whose
    lane 0 is all false."""
    rng = np.random.default_rng(seed)
    n = max(4 * c, 16)
    msb = rng.integers(0, 256, (n, d // 2)).astype(np.uint8)
    lsb = rng.integers(0, 256, (n, d // 2)).astype(np.uint8)
    q = rng.integers(-128, 128, (b, d)).astype(np.int8)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    if c > 3:
        ids[:, 1] = ids[:, 0]           # a tie: the same row twice
        ids[:, 2] = n - 1
    norms = rng.integers(0, 1 << 20, n).astype(np.int32)
    norms[: n // 4] = 0                 # zero norms: similarity 0
    member = None
    if masked:
        member = rng.random((b, c)) < 0.6
        member[0] = False               # a lane with no member
        ids[~member & (rng.random((b, c)) < 0.5)] = -1
    return q, msb, lsb, ids, norms, member


def _jax_stage(q, msb, lsb, ids, norms, member, k, metric):
    """The reference engine's exact stage (src/repro/core/engine.py
    `ExactRescore.run`) on numpy inputs."""
    cand = jnp.asarray(ids)
    safe = jnp.maximum(cand, 0)
    msb_rows = jnp.take(jnp.asarray(msb), safe, axis=0)
    lsb_rows = jnp.take(jnp.asarray(lsb), safe, axis=0)
    exact = stage2_int8_batched_pallas(
        jops.pack_queries_even_odd(jnp.asarray(q)), msb_rows, lsb_rows,
        block_c=ids.shape[1], interpret=True)
    cand_norms = jnp.take(jnp.asarray(norms), safe, axis=0)
    if member is not None:
        m = jnp.asarray(member)
        exact = jnp.where(m, exact, J_MASKED_SCORE)
        cand_norms = jnp.where(m, cand_norms, 1)
    if metric == "cosine":
        local, top = jax.vmap(lambda s, nn: jsim.rerank_dense_comparator(
            s, nn, k))(exact, cand_norms)
    else:
        top, local = jax.lax.top_k(exact, k)
    indices = jnp.take_along_axis(cand, local, axis=1)
    if member is None:
        return indices, top, cand
    valid = jnp.take_along_axis(m, local, axis=1)
    return (jnp.where(valid, indices, -1), jnp.where(valid, top, 0),
            jnp.where(m, cand, -1))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "mips"])
@pytest.mark.parametrize("b,c,d,k", [(3, 50, 64, 5), (2, 7, 36, 7),
                                     (1, 1, 8, 1)])
def test_plain_stage_equals_reference(b, c, d, k, metric, masked):
    assert MASKED_SCORE == J_MASKED_SCORE
    q, msb, lsb, ids, norms, member = _case(b, c, d, b * c + d, masked)
    want = _jax_stage(q, msb, lsb, ids, norms, member, k, metric)
    got = ref.exact_rerank_by_id_ref(
        torch.from_numpy(q), torch.from_numpy(msb), torch.from_numpy(lsb),
        torch.from_numpy(ids), torch.from_numpy(norms),
        None if member is None else torch.from_numpy(member), k=k,
        metric=metric)
    for g, w, shape in zip(got, want, ((b, k), (b, k), (b, c)), strict=True):
        assert g.dtype == torch.int32 and tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the CPU backend's stage is this plain version
    fns = eng.stage_fns("cuda")
    again = fns.exact_rerank(
        torch.from_numpy(q), torch.from_numpy(msb), torch.from_numpy(lsb),
        torch.from_numpy(ids), torch.from_numpy(norms),
        None if member is None else torch.from_numpy(member), k=k,
        metric=metric)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def _cosine_gt(sa, na, sb, nb) -> bool:
    """The kernel's `cosine_gt` in Python ints (exact, as its 128-bit
    products are)."""
    def sign(s, n):
        return (s > 0) - (s < 0) if n > 0 else 0
    ga, gb = sign(sa, na), sign(sb, nb)
    if ga != gb:
        return ga > gb
    if ga == 0:
        return False
    lhs, rhs = sa * sa * max(nb, 1), sb * sb * max(na, 1)
    assert max(lhs, rhs) < 2 ** 128
    return lhs > rhs if ga > 0 else lhs < rhs


def _emulate(scores, norms, k, metric):
    """The kernel's ranking, lane by lane: wins by count (cosine), rank_i =
    #{j : key_j > key_i, or key_j == key_i and j < i}, position rank_i
    written when below k. Returns the (B, k) candidate positions."""
    out = np.full((len(scores), k), -1, np.int64)
    for lane, (s, n) in enumerate(zip(scores, norms)):
        c = len(s)
        if metric == "cosine":
            key = [sum(_cosine_gt(s[i], n[i], s[j], n[j]) for j in range(c))
                   for i in range(c)]
        else:
            key = list(s)
        for i in range(c):
            r = sum(key[j] > key[i] or (key[j] == key[i] and j < i)
                    for j in range(c))
            if r < k:
                out[lane, r] = i
    return out


@pytest.mark.parametrize("k", [1, 5, 137])
@pytest.mark.parametrize("metric", ["cosine", "mips"])
def test_ranking_rule_equals_the_plain_comparator(metric, k):
    """On the comparator's edge cases (`_fraction_cases` and INT32_MIN),
    three lanes of 137: the emulated rule equals the plain rerank
    (`rerank_dense_comparator`, `stable_topk`) and the plain rerank
    kernel's version."""
    s, n = _fraction_cases()
    s = np.concatenate([s, np.array([INT32_MIN], np.int32)]).reshape(3, 137)
    n = np.concatenate([n, np.array([7], np.int32)]).reshape(3, 137)
    s[1, 10:20] = 5                          # plain ties
    s[2, :4] = INT32_MIN
    n[2, :2] = 0
    got = _emulate(s.tolist(), n.tolist(), k, metric)
    ts, tn = torch.from_numpy(s), torch.from_numpy(n)
    if metric == "cosine":
        want, top = tsim.rerank_dense_comparator(ts, tn, k)
    else:
        top, want = tsim.stable_topk(ts, k)
    np.testing.assert_array_equal(got, want.numpy())
    ids = torch.arange(3 * 137, dtype=torch.int32).reshape(3, 137) + 1000
    idx, top2 = ref.rerank_ref(ts, tn, ids, k=k, metric=metric)
    np.testing.assert_array_equal(idx.numpy(), got + 1000
                                  + 137 * np.arange(3)[:, None])
    assert torch.equal(top2, top)


@pytest.mark.parametrize("c", [1, 5, 50, 257, 1023, 1024, 1025, 2048, 3001])
def test_pair_loop_visits_every_pair_once(c):
    """`count_pairs`' stepping (i = p % C, j = p / C, advanced by T % C and
    T / C with a carry, no division per pair), run for all T threads at
    once: every ordered pair (i, j) exactly once."""
    t = np.arange(THREADS)
    i, j = t % c, t // c
    seen = np.zeros((c, c), np.int64)
    for p0 in range(0, c * c, THREADS):
        live = t + p0 < c * c
        assert (i[live] < c).all() and (j[live] < c).all()
        np.add.at(seen, (i[live], j[live]), 1)
        i, j = i + THREADS % c, j + THREADS // c
        wrap = i >= c
        i, j = np.where(wrap, i - c, i), np.where(wrap, j + 1, j)
    assert (seen == 1).all()


def _plane_case(b=3, c=5, n=9, d=64):
    return (torch.zeros((b, d), dtype=torch.int8),
            torch.zeros((n, d // 2), dtype=torch.uint8),
            torch.zeros((b, c), dtype=torch.int32),
            torch.zeros((n,), dtype=torch.int32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "mips"])
def test_exact_stage_is_one_launch(monkeypatch, metric, masked):
    """On the "cuda" backend `ExactRescore.run` is one launch of the rerank
    kernel (counted `stage2_rerank_by_id`, with the raw query, the mask
    or none, and B, C, D/2, N, k and the metric's code) and no by-id exact
    launch."""
    calls = _capture_launches(monkeypatch)
    q, plane, ids, norms = _plane_case()
    member = torch.ones(ids.shape, dtype=torch.bool) if masked else None
    db = eng.bitplanar.BitPlanarDB(msb_plane=plane, lsb_plane=plane,
                                   norms_sq=norms, scale=torch.ones(()))
    cfg = RetrievalConfig(k=4, metric=metric)
    ctx = eng._CascadeCtx(query_codes=q, q_msb=q, db=db,
                          policy=eng.PlainPolicy(), cfg=cfg,
                          fns=eng.stage_fns("cuda"))
    state = eng.ExactRescore().run(eng._CascadeState(rows=ids, member=member),
                                   ctx)
    res = state.result
    assert [tuple(r.shape) for r in (res.indices, res.scores,
                                     res.candidate_indices)] == [
        (3, 4), (3, 4), (3, 5)]
    assert [c for c, _ in calls] == ["stage2_rerank_by_id"]
    args = calls[0][1]
    assert args[0] == q.data_ptr() and (args[4] is None) == (not masked)
    assert args[-6:] == (3, 5, 32, 9, 4, METRICS[metric])


@pytest.mark.parametrize("metric", ["cosine", "mips"])
@pytest.mark.parametrize("slots", [1, 3])
def test_sharded_batch_is_s_exact_and_one_rerank(monkeypatch, slots,
                                                 metric):
    """`ShardedIndex` on the "cuda" backend: per batch, S plane scans, S
    by-id exact launches and one rerank launch (the final rerank after the
    owners' sum)."""
    calls = _capture_launches(monkeypatch)
    emb = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (40, 64)).astype(np.float32))
    index = ShardedIndex.build(emb, make_test_mesh(slots, 1, "cpu"))
    retrieve = index.retrieve_fn(RetrievalConfig(k=3, metric=metric))
    q = torch.from_numpy(np.random.default_rng(4).integers(
        -128, 128, (4, 64)).astype(np.int8))
    res = retrieve(q)
    assert tuple(res.indices.shape) == (4, 3)
    assert [c for c, _ in calls] == (["stage1_plane"] * slots
                                     + ["stage2_by_id"] * slots
                                     + ["stage2_rerank"])
    c = res.candidate_indices.shape[1]
    assert calls[-1][1][-4:] == (4, c, 3, METRICS[metric])


def test_refusals_name_the_operand(monkeypatch):
    """The CUDA branch's checks: a wrong dtype, shape, k or metric and an
    empty plane each raise naming what is wrong; nothing launches."""
    calls = _capture_launches(monkeypatch)
    q, plane, ids, norms = _plane_case()

    def stage(**kw):
        args = dict(q=q, msb_plane=plane, lsb_plane=plane, ids=ids,
                    norms_sq=norms, member=None, k=2, metric="cosine")
        args.update(kw)
        k, metric = args.pop("k"), args.pop("metric")
        return ops.exact_rerank_by_id(*args.values(), k=k, metric=metric)

    with pytest.raises(TypeError, match="q must be torch.int8"):
        stage(q=q.to(torch.int16))
    with pytest.raises(TypeError, match="ids must be torch.int32"):
        stage(ids=ids.long())
    with pytest.raises(TypeError, match="norms_sq must be torch.int32"):
        stage(norms_sq=norms.long())
    with pytest.raises(TypeError, match="member must be torch.bool"):
        stage(member=torch.ones(ids.shape, dtype=torch.uint8))
    with pytest.raises(TypeError, match="lsb_plane must be torch.uint8"):
        stage(lsb_plane=plane.to(torch.int8))
    with pytest.raises(ValueError, match="q shape"):
        stage(q=q[:, :32].contiguous())
    with pytest.raises(ValueError, match="norms_sq shape"):
        stage(norms_sq=norms[:5])
    with pytest.raises(ValueError, match="member shape"):
        stage(member=torch.ones((3, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="lsb_plane shape"):
        stage(lsb_plane=plane[:4])
    with pytest.raises(ValueError, match="k = 6 is outside the 5"):
        stage(k=6)
    with pytest.raises(ValueError, match="metric must be one of"):
        stage(metric="l2")
    with pytest.raises(ValueError, match="empty plane"):
        stage(msb_plane=plane[:0], lsb_plane=plane[:0], norms_sq=norms[:0])
    with pytest.raises(ValueError, match="above what one thread block"):
        big = torch.zeros((1, 20000), dtype=torch.int32)
        ops.rerank(big, big, big, k=1, metric="mips")
    with pytest.raises(TypeError, match="scores must be torch.int32"):
        ops.rerank(ids.long(), ids, ids, k=2, metric="mips")
    with pytest.raises(ValueError, match="norms shape"):
        ops.rerank(ids, ids[:2], ids, k=2, metric="cosine")
    with pytest.raises(ValueError, match="k = 6 is outside the 5"):
        ops.rerank(ids, ids, ids, k=6, metric="cosine")
    assert calls == []
