"""The port's decode path (`repro_torch.core.engine`'s KV cascade and
`repro_torch.serve.sparse_kv`) against the reference's, on the CPU.

Mirrors tests/test_decode_cascade.py and the sparse-KV cases of
tests/test_serve.py, on numpy inputs fed to both packages:

  * within the port, the engine path is bit-identical to the port's legacy
    oracle (all lengths, mixed lengths, full-coverage paged on both
    backends) and the "cuda" and "torch" backends give the same bits;
  * against the reference (jnp and Pallas in interpret mode), the cache's
    planes, scales and centroids are bit-identical, `kv_plan` equal field
    for field, and the attention output equal within ATOL/RTOL (f32
    products summed in another order). Where the selected positions
    differ, every differing position's key (recomputed in float64) must lie
    within NEAR_TIE of the lane's k-th key: such lanes are exempted from
    the output comparison and counted (`-s` prints the count).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.core import energy as jenergy
from repro.core import engine as jengine
from repro.kernels import ops as jops
from repro.models import attention as jattention
from repro.serve import sparse_kv as jsparse
from repro_torch.core import engine as tengine
from repro_torch.kernels import ops, ref
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import RuntimeConfig, ServingRuntime, sparse_kv
from repro_torch.tenancy import MultiTenantIndex
from repro_torch.core import RetrievalConfig

B, T, H, KH, HD = 2, 64, 8, 4, 32
ATOL = RTOL = 1e-5
NEAR_TIE = 1e-5
BACKENDS = ("torch", "cuda")
EXEMPTED = []


@pytest.fixture(autouse=True)
def report_exemptions(request):
    EXEMPTED.clear()
    yield
    if EXEMPTED:
        print(f"{request.node.name}: {sum(EXEMPTED)} lanes exempted as "
              "near ties")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def make_cache(seed=0, b=B, t=T, kh=KH, hd=HD, paged=False, page_rows=8):
    """(port cache, reference cache, k, v) from one numpy draw."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    tc = sparse_kv.build_quant_cache(_t(k), _t(v))
    jc = jsparse.build_quant_cache(jnp.asarray(k), jnp.asarray(v))
    if paged:
        full = np.full((b,), t, np.int32)
        tc = sparse_kv.build_page_centroids(tc, _t(full), page_rows)
        jc = jsparse.build_page_centroids(jc, jnp.asarray(full), page_rows)
    return tc, jc, k, v


def make_q(seed=2, b=B, h=H, hd=HD):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, 1, h, hd)).astype(np.float32)


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _spy(monkeypatch, module, box):
    """Record the (rows, member) state each cascade hands its exact stage."""
    run = module.KVExactAttend.run

    def spy(self, state, ctx):
        box.append((np.asarray(state.rows), np.asarray(state.member)))
        return run(self, state, ctx)
    monkeypatch.setattr(module.KVExactAttend, "run", spy)


def _keys64(q, tc):
    """The approx stage's key of every cache position in float64:
    max over the lane's query heads of q . msb_nibbles * scale."""
    b, _, h, hd = q.shape
    kh = tc.v.shape[2]
    msb = tc.k_msb.numpy()
    lo = (msb & 0xF).astype(np.int64)
    hi = (msb >> 4).astype(np.int64)
    nib = np.stack([np.where(lo >= 8, lo - 16, lo),
                    np.where(hi >= 8, hi - 16, hi)], -1).reshape(
        *msb.shape[:-1], hd)                                  # (B,T,KH,hd)
    qg = q.reshape(b, kh, h // kh, hd).astype(np.float64)
    s = np.einsum("bkgd,btkd->bkgt", qg, nib.astype(np.float64))
    s = s * tc.k_scale.numpy().astype(np.float64).transpose(0, 2, 1)[
        :, :, None]
    return s.max(axis=2)                                      # (B, KH, T)


def _against_reference(monkeypatch, q, tc, jc, lengths, top_k, **kw):
    """The port (both backends) and the reference (jnp and Pallas) on the
    same schedule: the port's backends bit-identical to each other, the
    output within ATOL/RTOL of the reference's, and the selections equal
    outside near ties."""
    tsel, jsel = [], []
    _spy(monkeypatch, tengine, tsel)
    _spy(monkeypatch, jengine, jsel)
    L = np.asarray(lengths, np.int32)
    outs = [sparse_kv.sparse_decode_attention(_t(q), tc, _t(L), top_k,
                                              backend=be, **kw)
            for be in BACKENDS]
    _eq(outs[0], outs[1], "torch vs cuda backend")
    got = outs[0].numpy()
    assert not np.isnan(got).any()
    for backend in ("jnp", "pallas"):
        cfg = jengine.KVCascadeConfig(
            top_k=top_k, backend=backend,
            **{k: v for k, v in kw.items()})
        want = np.asarray(jengine._kv_cascade(
            jnp.asarray(q), jsparse.kv_policy(jc, jnp.asarray(L)), cfg))
        rows, member = tsel[0]
        jrows, jmember = jsel[-1]
        keys = _keys64(q, tc)
        heads_ok = np.ones(got.shape, bool)
        g = q.shape[2] // tc.v.shape[2]
        exempt = 0
        for bi in range(rows.shape[0]):
            for ki in range(rows.shape[1]):
                a = set(rows[bi, ki][member[bi, ki]].tolist())
                w = set(jrows[bi, ki][jmember[bi, ki]].tolist())
                if a == w:
                    continue
                kth = min(keys[bi, ki, list(a)])
                for pos in a ^ w:
                    assert abs(keys[bi, ki, pos] - kth) <= NEAR_TIE * max(
                        1.0, abs(kth)), ("selection differs outside a near "
                                         "tie", bi, ki, pos)
                exempt += 1
                heads_ok[bi, :, ki * g:(ki + 1) * g] = False
        EXEMPTED.append(exempt)
        np.testing.assert_allclose(got[heads_ok], want[heads_ok],
                                   atol=ATOL, rtol=RTOL)
    return outs[0]


# -- bit parity with the legacy oracle ----------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("length", [0, 3, 17, T])
def test_engine_path_bit_identical_to_legacy(length, backend):
    tc, _, _, _ = make_cache()
    q = _t(make_q())
    L = torch.full((B,), length, dtype=torch.int32)
    want = sparse_kv.sparse_decode_attention_ref(q, tc, L, top_k=16)
    got = sparse_kv.sparse_decode_attention(q, tc, L, top_k=16,
                                            backend=backend)
    _eq(got, want)


def test_engine_path_bit_identical_mixed_lengths():
    tc, _, _, _ = make_cache()
    q = _t(make_q())
    L = torch.tensor([0, 40], dtype=torch.int32)
    want = sparse_kv.sparse_decode_attention_ref(q, tc, L, top_k=16)
    got = sparse_kv.sparse_decode_attention(q, tc, L, top_k=16)
    _eq(got, want)
    assert not got.isnan().any()
    assert not got[0].any()              # the empty lane: exact zeros


@pytest.mark.parametrize("backend", BACKENDS)
def test_paged_full_coverage_degenerates_to_legacy(backend):
    tc, _, _, _ = make_cache(paged=True)
    q = _t(make_q())
    L = torch.full((B,), T, dtype=torch.int32)
    want = sparse_kv.sparse_decode_attention_ref(q, tc, L, top_k=16)
    paged = sparse_kv.sparse_decode_attention(
        q, tc, L, top_k=16, npages=T // 8, backend=backend)
    _eq(paged, want)
    ps = sparse_kv.sparse_decode_attention(
        q, tc, L, top_k=16, npages=T // 8, prescreen_c0=T, backend=backend)
    _eq(ps, want)


@pytest.mark.parametrize("lengths", [(5, 23), (0, 0), (64, 1)])
def test_pruned_cascade_backends_bit_parity(lengths):
    tc, _, _, _ = make_cache(paged=True)
    q = _t(make_q())
    L = torch.tensor(lengths, dtype=torch.int32)
    for kw in ({"npages": 4}, {"npages": 6, "prescreen_c0": 24}):
        a, b = (sparse_kv.sparse_decode_attention(q, tc, L, top_k=8,
                                                  backend=be, **kw)
                for be in BACKENDS)
        _eq(a, b)
        assert not a.isnan().any()


def test_prescreen_passes_one_page_table_per_kv_head(monkeypatch):
    """The sign prescreen hands #8 the (B*KH, NP) page table once, with
    group = G (the query heads of a KV head), not the table copied for
    every query head; its scores equal the per-lane call on the table
    repeated G times."""
    tc, _, _, _ = make_cache(seed=3, b=2, t=128, kh=2, hd=64, paged=True,
                             page_rows=16)
    q = _t(make_q(seed=4, b=2, h=14, hd=64))            # G = 7 query heads
    seen = []
    real = ops.stage0_sign_scores_gather

    def spy(q_sign, plane, ids, **kw):
        out = real(q_sign, plane, ids, **kw)
        seen.append((q_sign, plane, ids, kw, out))
        return out
    monkeypatch.setattr(ops, "stage0_sign_scores_gather", spy)
    sparse_kv.sparse_decode_attention(
        q, tc, torch.tensor([128, 77], dtype=torch.int32), 16, npages=4,
        prescreen_c0=32, page_rows=16, backend="cuda")
    (q_sign, plane, ids, kw, out), = seen
    assert kw == {"block_rows": 16, "group": 7}
    assert ids.shape == (2 * 2, 4) and ids.dtype == torch.int32
    assert ids.is_contiguous() and q_sign.shape == (2 * 2 * 7, 64)
    assert out.shape == (28, 4 * 16)
    _eq(out, real(q_sign, plane, ids.repeat_interleave(7, 0),
                  block_rows=16))


def test_empty_cache_paged_returns_zeros():
    tc, _, _, _ = make_cache(paged=True)
    q = _t(make_q())
    out = sparse_kv.sparse_decode_attention(
        q, tc, torch.zeros(B, dtype=torch.int32), top_k=8, npages=4)
    _eq(out, np.zeros(q.shape, np.float32))


# -- against the reference --------------------------------------------------

@pytest.mark.parametrize("kw,top_k", [
    ({}, 16),
    ({"npages": 8, "page_rows": 8}, 16),
    ({"npages": 4, "page_rows": 8}, 8),
    ({"npages": 6, "prescreen_c0": 24, "page_rows": 8}, 8),
    ({"npages": 8, "prescreen_c0": 64, "page_rows": 8}, 16)])
@pytest.mark.parametrize("lengths", [(64, 64), (5, 23), (0, 40), (64, 1)])
def test_cascade_matches_the_reference(monkeypatch, kw, top_k, lengths):
    tc, jc, _, _ = make_cache(paged=True)
    _against_reference(monkeypatch, make_q(), tc, jc, lengths, top_k, **kw)


@pytest.mark.parametrize("seed", [1, 2])
def test_cascade_matches_the_reference_at_page_rows_16(monkeypatch, seed):
    tc, jc, _, _ = make_cache(seed=seed, b=2, t=128, kh=2, hd=64,
                              paged=True, page_rows=16)
    q = make_q(seed=seed + 10, b=2, h=14, hd=64)      # G = 7 query heads
    _against_reference(monkeypatch, q, tc, jc, (128, 77), 16, npages=4,
                       prescreen_c0=32, page_rows=16)


def test_cache_bit_identical_to_the_reference():
    """The quantized planes, scales and page centroids are the reference's
    bits (round half to even, f32 scales), at several lengths."""
    tc, jc, _, _ = make_cache(paged=True)
    for name in ("k_msb", "k_lsb", "k_scale", "cent_msb", "cent_scale"):
        _eq(getattr(tc, name), getattr(jc, name), name)
    for page_rows in (8, 16):
        for length in ((64, 64), (1, 7), (8, 33), (0, 63)):
            L = np.asarray(length, np.int32)
            got = sparse_kv.build_page_centroids(tc, _t(L), page_rows)
            want = jsparse.build_page_centroids(jc, jnp.asarray(L),
                                                page_rows)
            _eq(got.cent_msb, want.cent_msb, "cent_msb")
            _eq(got.cent_scale, want.cent_scale, "cent_scale")
    with pytest.raises(ValueError, match="page_rows"):
        sparse_kv.build_page_centroids(tc, _t(np.full(B, T)), page_rows=7)


def test_incremental_centroid_update_matches_rebuild():
    """Appending one key and refreshing one page equals a rebuild at the
    new length, and the reference's own update."""
    page_rows = 8
    tc, jc, _, _ = make_cache()
    for length in (1, 7, 8, 33):
        L = np.full((B,), length, np.int32)
        full = sparse_kv.build_page_centroids(tc, _t(L), page_rows)
        prev = sparse_kv.build_page_centroids(tc, _t(L - 1), page_rows)
        cm, cs = sparse_kv.update_page_centroids(
            tc.k_msb, tc.k_lsb, tc.k_scale, prev.cent_msb, prev.cent_scale,
            _t(L), page_rows)
        _eq(cm, full.cent_msb, "cent_msb")
        _eq(cs, full.cent_scale, "cent_scale")
        jprev = jsparse.build_page_centroids(jc, jnp.asarray(L - 1),
                                             page_rows)
        jm, js = jsparse.update_page_centroids(
            jc.k_msb, jc.k_lsb, jc.k_scale, jprev.cent_msb,
            jprev.cent_scale, jnp.asarray(L), page_rows)
        _eq(cm, jm, "cent_msb vs reference")
        _eq(cs, js, "cent_scale vs reference")


def test_centroid_rows_matches_ref_and_the_reference():
    rng = np.random.default_rng(9)
    bq, p, d = 6, 16, 32
    qn = rng.integers(-8, 8, size=(bq, d)).astype(np.int8)
    rows = rng.integers(0, 256, size=(bq, p, d // 2)).astype(np.uint8)
    got = ops.centroid_scores_rows(_t(qn), _t(rows))
    want = ref.centroid_scores_rows_ref(
        ops.pack_queries_even_odd(_t(qn)), _t(rows))
    _eq(got, want)
    _eq(got, jops.centroid_scores_rows(jnp.asarray(qn), jnp.asarray(rows)))


# -- convergence and GQA (the reference's oracle on numpy inputs) -----------

def _decode_attention(q, k, v, lengths):
    return np.asarray(jattention.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths, jnp.int32)), np.float32)


def test_convergence_to_dense_as_topk_grows():
    tc, _, k, v = make_cache(paged=True)
    q = make_q()
    L = np.full((B,), T, np.int32)
    want = _decode_attention(q, k, v, L)
    errs = []
    for top_k in (4, 16, T):
        got = sparse_kv.sparse_decode_attention(_t(q), tc, _t(L), top_k,
                                                npages=T // 8)
        errs.append(float(np.abs(got.numpy() - want).max()))
    assert errs[-1] < 0.05
    assert errs[0] >= errs[-1]


def test_gqa_group_max_selection():
    b, t, kh, hd, h = 1, 64, 1, 16, 2
    rng = np.random.default_rng(5)
    k = (rng.normal(size=(b, t, kh, hd)) * 0.1).astype(np.float32)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k[0, 37, 0] = q[0, 0, 1] * 2.0          # aligns with head 1 only
    v = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    L = np.full((b,), t, np.int32)
    cache = sparse_kv.build_quant_cache(_t(k), _t(v))
    got = sparse_kv.sparse_decode_attention(_t(q), cache, _t(L), 8).numpy()
    want = _decode_attention(q, k, v, L)
    assert float(np.abs(got[:, :, 1] - want[:, :, 1]).max()) < 0.25
    q0 = q.copy()
    q0[:, :, 1] = q[:, :, 0]
    got0 = sparse_kv.sparse_decode_attention(_t(q0), cache, _t(L),
                                             8).numpy()
    assert not np.allclose(got0[:, :, 1], want[:, :, 1], atol=0.25)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def test_sparse_kv_matches_full_attention_when_k_covers_cache():
    b, t, kh, hd, h = 2, 32, 2, 16, 4
    k, v = _normal(0, (b, t, kh, hd), 0.5), _normal(1, (b, t, kh, hd))
    q = _normal(2, (b, 1, h, hd))
    L = np.full((b,), t, np.int32)
    cache = sparse_kv.build_quant_cache(_t(k), _t(v))
    got = sparse_kv.sparse_decode_attention(_t(q), cache, _t(L), top_k=t)
    np.testing.assert_allclose(got.numpy(), _decode_attention(q, k, v, L),
                               atol=0.05)


def test_sparse_kv_topk_approximation_quality():
    b, t, kh, hd, h = 1, 64, 1, 16, 1
    k = _normal(0, (b, t, kh, hd), 0.1)
    q = _normal(2, (b, 1, h, hd))
    k[0, 37, 0] = q[0, 0, 0] * 2.0
    v = _normal(1, (b, t, kh, hd))
    L = np.full((b,), t, np.int32)
    cache = sparse_kv.build_quant_cache(_t(k), _t(v))
    got = sparse_kv.sparse_decode_attention(_t(q), cache, _t(L), top_k=8)
    assert float(np.abs(got.numpy()
                        - _decode_attention(q, k, v, L)).max()) < 0.25


def test_sparse_kv_empty_cache_returns_zeros_not_nan():
    b, t, kh, hd, h = 2, 16, 2, 16, 4
    k, v = _normal(0, (b, t, kh, hd)), _normal(1, (b, t, kh, hd))
    q = _normal(2, (b, 1, h, hd))
    cache = sparse_kv.build_quant_cache(_t(k), _t(v))
    out = sparse_kv.sparse_decode_attention(
        _t(q), cache, torch.zeros(b, dtype=torch.int32), top_k=8)
    assert out.shape == q.shape
    _eq(out, np.zeros(q.shape, np.float32))


def test_sparse_kv_short_cache_matches_full_attention():
    b, t, kh, hd, h = 2, 32, 2, 16, 4
    k, v = _normal(0, (b, t, kh, hd), 0.5), _normal(1, (b, t, kh, hd))
    q = _normal(2, (b, 1, h, hd))
    L = np.asarray([3, 5], np.int32)
    cache = sparse_kv.build_quant_cache(_t(k), _t(v))
    got = sparse_kv.sparse_decode_attention(_t(q), cache, _t(L), top_k=16)
    assert not got.isnan().any()
    np.testing.assert_allclose(got.numpy(), _decode_attention(q, k, v, L),
                               atol=0.05)


def test_sparse_kv_traffic_model():
    dense = sparse_kv.dense_bytes_per_step(32768, 128)
    sparse = sparse_kv.sparse_bytes_per_step(32768, 128, top_k=256)
    assert sparse < dense / 4
    assert sparse == jsparse.sparse_bytes_per_step(32768, 128, top_k=256)
    assert dense == jsparse.dense_bytes_per_step(32768, 128)


# -- ledger and pricing -------------------------------------------------------

def _port_cfg(jcfg):
    return tengine.KVCascadeConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(jcfg) if f.name != "backend"})


def _plan_fields(plan):
    return (plan.kind, plan.batch, plan.rows_scanned, plan.candidates,
            plan.stage1_bytes, plan.stage1_bytes_vmapped, plan.stage2_bytes,
            tuple(dataclasses.astuple(s) for s in plan.stages),
            plan.stage1_bytes_sram)


@pytest.mark.parametrize("cfg", [
    dict(top_k=256), dict(top_k=256, npages=64, page_rows=16),
    dict(top_k=256, npages=64, page_rows=16, prescreen_c0=512),
    dict(top_k=4096, npages=8, page_rows=8, prescreen_c0=100),
    dict(top_k=16, npages=3, page_rows=7)])
def test_kv_plan_matches_the_reference(cfg):
    jcfg = jengine.KVCascadeConfig(**cfg)
    for kw in (dict(batch=4, kv_heads=8, q_heads=32, seq_len=32768,
                    head_dim=128, layers=16),
               dict(batch=8, kv_heads=2, q_heads=14, seq_len=32768,
                    head_dim=64, layers=24),
               dict(batch=1, kv_heads=1, q_heads=2, seq_len=100,
                    head_dim=32)):
        assert (_plan_fields(tengine.kv_plan(_port_cfg(jcfg), **kw))
                == _plan_fields(jengine.kv_plan(jcfg, **kw)))


def test_kv_plan_reconciles_with_sparse_bytes_per_step():
    t, hd, k, kh, qh, b, layers = 32768, 128, 256, 8, 32, 4, 16
    plan = sparse_kv.decode_plan(k, batch=b, kv_heads=kh, q_heads=qh,
                                 seq_len=t, head_dim=hd, layers=layers)
    assert plan.kind == "decode"
    per_lane = sum(s.bytes_hbm for s in plan.stages) / (b * kh * layers)
    assert per_lane == sparse_kv.sparse_bytes_per_step(t, hd, k)


def test_kv_plan_page_prune_cuts_scan_bytes():
    cfg = tengine.KVCascadeConfig(top_k=256, npages=64, page_rows=16,
                                  prescreen_c0=512)
    kw = dict(batch=4, kv_heads=8, q_heads=32, seq_len=32768, head_dim=128,
              layers=16)
    paged = tengine.kv_plan(cfg, **kw)
    flat = tengine.kv_plan(tengine.KVCascadeConfig(top_k=256), **kw)
    assert [s.name for s in paged.stages] == ["prune", "prescreen",
                                              "approx", "exact"]
    assert (sum(s.bytes_hbm for s in paged.stages)
            < sum(s.bytes_hbm for s in flat.stages) / 4)


def test_kv_plan_dense_ratios_at_32k():
    """The decode ledgers' byte cut against dense bf16 K + V at T = 32k,
    hd = 128, top_k = 256: 7.2x flat, 32.4x paged (npages 256 of 16-row
    pages, the bench's T // 16 // 8)."""
    t, hd, k = 32768, 128, 256
    kw = dict(batch=4, kv_heads=8, q_heads=32, seq_len=t, head_dim=hd,
              layers=16)
    lanes = 4 * 8 * 16
    dense = sparse_kv.dense_bytes_per_step(t, hd)
    ratios = []
    for cfg in (tengine.KVCascadeConfig(top_k=k),
                tengine.KVCascadeConfig(top_k=k, npages=t // 16 // 8,
                                        page_rows=16)):
        plan = tengine.kv_plan(cfg, **kw)
        ratios.append(dense / (sum(s.bytes_hbm for s in plan.stages)
                               / lanes))
    assert [round(r, 1) for r in ratios] == [7.2, 32.4]


def test_decode_cost_prices_like_retrieval():
    t, hd, k = 32768, 128, 256
    kw = dict(batch=4, kv_heads=8, q_heads=32, seq_len=t, head_dim=hd,
              layers=16)
    flat = tengine.kv_plan(tengine.KVCascadeConfig(top_k=k), **kw)
    paged = tengine.kv_plan(tengine.KVCascadeConfig(
        top_k=k, npages=64, page_rows=16), **kw)
    from repro_torch.core import energy
    c_flat = energy.cost_cascade(flat.stages, hd, batch=flat.batch)
    c_paged = energy.cost_cascade(paged.stages, hd, batch=paged.batch)
    assert 0 < c_paged.total_uj < c_flat.total_uj
    jflat = jengine.kv_plan(jengine.KVCascadeConfig(top_k=k), **kw)
    want = jenergy.cost_cascade(jflat.stages, hd, batch=jflat.batch)
    assert dataclasses.asdict(c_flat) == pytest.approx(
        dataclasses.asdict(want), rel=1e-12)


def test_runtime_account_decode_ledger_and_registry():
    idx = MultiTenantIndex(64, 32, RetrievalConfig(), device="cpu")
    reg = MetricsRegistry()
    rt = ServingRuntime(idx, RuntimeConfig(), registry=reg)
    plan = tengine.kv_plan(tengine.KVCascadeConfig(top_k=16), batch=2,
                           kv_heads=2, q_heads=4, seq_len=64, head_dim=32,
                           layers=2)
    cost = rt.account_decode(plan, dim=32, tokens=10)
    assert cost.total_uj > 0
    assert rt.decode_steps == 10
    assert rt.decode_bytes_hbm == 10 * sum(s.bytes_hbm for s in plan.stages)
    assert rt.last_decode_plan == plan
    hist = reg.snapshot()["histograms"]
    assert hist["energy_uj_per_token"]["count"] == 10
    counters = reg.snapshot()["counters"]
    assert counters["stage_bytes_hbm{stage=approx}"] > 0
    rplan = tengine.plan(RetrievalConfig(), num_docs=64, dim=32, batch=2,
                         kind="plain")
    with pytest.raises(ValueError):
        rt.account_decode(rplan, dim=32)


def test_config_and_policy_checks():
    with pytest.raises(ValueError, match="top_k"):
        tengine.KVCascadeConfig(top_k=0)
    with pytest.raises(ValueError, match="npages"):
        tengine.KVCascadeConfig(top_k=4, prescreen_c0=8)
    tc, _, _, _ = make_cache()
    q = _t(make_q())
    L = torch.full((B,), T, dtype=torch.int32)
    with pytest.raises(ValueError, match="centroids"):
        sparse_kv.sparse_decode_attention(q, tc, L, 8, npages=2)
    with pytest.raises(ValueError, match="multiple"):
        tc_p = sparse_kv.build_page_centroids(tc, L, 8)
        sparse_kv.sparse_decode_attention(q, tc_p, L, 8, npages=2,
                                          page_rows=7)
    pol = sparse_kv.kv_policy(tc, L)
    bad = dataclasses.replace(pol, length=pol.length.to("meta"))
    with pytest.raises(ValueError, match="length"):
        tengine.kv_decode_batched(q, bad, tengine.KVCascadeConfig(top_k=4))
