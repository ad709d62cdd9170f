"""The port's primitives against the JAX reference on the same numpy inputs:
quantization, nibble/sign/bit planes, exact integer products, the
non-division comparator, the stable top-k, and the synthetic corpus."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import bitplanar as jbp
from repro.core import quantization as jqz
from repro.core import similarity as jsim
from repro.data import retrieval_corpus as j_corpus
from repro_torch import convert, resolve_device
from repro_torch.core import bitplanar as tbp
from repro_torch.core import quantization as tqz
from repro_torch.core import similarity as tsim
from repro_torch.core.engine import MASKED_SCORE
from repro_torch.data import retrieval_corpus as t_corpus


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _codes(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, size=(n, d)).astype(np.int8)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def test_round_half_to_even_pinned():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    want = np.array([0, 2, 2, -0, -2, -2, 4], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(x))), want)
    # amax 127 -> scale exactly 1, so the codes are round(x) themselves
    y = np.array([[0.5, 1.5, 2.5, -2.5, 127.0]], np.float32)
    codes, _ = tqz.quantize_int8(torch.from_numpy(y))
    assert codes.tolist() == [[0, 2, 2, -2, 127]]
    _eq(codes, jqz.quantize_int8(jnp.asarray(y))[0])


@pytest.mark.parametrize("per_vector", [False, True])
def test_quantize_int8_matches_reference(per_vector):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 48)).astype(np.float32)
    x[3, 5] = 0.0
    codes, scale = tqz.quantize_int8(torch.from_numpy(x),
                                     per_vector=per_vector)
    jc, js = jqz.quantize_int8(jnp.asarray(x), per_vector=per_vector)
    _eq(codes, jc)
    _eq(scale, js)


def test_quantize_fixed_and_nibbles_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 64)).astype(np.float32) * 0.2
    scale = tqz.unit_norm_scale(64)
    assert scale == jqz.unit_norm_scale(64)
    _eq(tqz.quantize_int8_fixed(torch.from_numpy(x), scale),
        jqz.quantize_int8_fixed(jnp.asarray(x), scale))
    every = np.arange(-128, 128, dtype=np.int8)
    t = torch.from_numpy(every)
    _eq(tqz.msb_nibble(t), jqz.msb_nibble(jnp.asarray(every)))
    _eq(tqz.lsb_nibble(t), jqz.lsb_nibble(jnp.asarray(every)))
    _eq((tqz.msb_nibble(t).to(torch.int16) * 16
         + tqz.lsb_nibble(t)).to(torch.int8), every)


@pytest.mark.parametrize("per_vector", [False, True])
def test_int4_and_dequantize_match_reference(per_vector):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(40, 24)).astype(np.float32)
    x[2, 3] = 0.0
    codes, scale = tqz.quantize_int4(torch.from_numpy(x),
                                     per_vector=per_vector)
    jc, js = jqz.quantize_int4(jnp.asarray(x), per_vector=per_vector)
    _eq(codes, jc)
    _eq(scale, js)
    assert int(codes.min()) >= -8 and int(codes.max()) <= 7
    _eq(tqz.dequantize(codes, scale), jqz.dequantize(jc, js))
    for d in (8, 64, 384, 512):
        assert tqz.unit_norm_scale(d) == jqz.unit_norm_scale(d)


def test_reconstruct_int_dot_and_topk_mips_match_reference():
    every = np.arange(-128, 128, dtype=np.int8)
    t = torch.from_numpy(every)
    _eq(tqz.reconstruct_from_nibbles(tqz.msb_nibble(t), tqz.lsb_nibble(t)),
        jqz.reconstruct_from_nibbles(jqz.msb_nibble(jnp.asarray(every)),
                                     jqz.lsb_nibble(jnp.asarray(every))))
    a, b = _codes(7, 512, 8), _codes(7, 512, 9)
    _eq(tsim.int_dot(torch.from_numpy(a), torch.from_numpy(b)),
        jsim.int_dot(jnp.asarray(a), jnp.asarray(b)))
    scores = np.random.default_rng(10).integers(-5, 5, 300).astype(np.int32)
    for k in (1, 7, 300):
        got = tsim.topk_mips(torch.from_numpy(scores), k)
        want = jsim.topk_mips(jnp.asarray(scores), k)
        _eq(got[0], want[0])
        _eq(got[1], want[1])


@pytest.mark.parametrize("per_vector", [False, True])
def test_build_database_matches_reference(per_vector):
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(100, 64)).astype(np.float32)
    db = tqz.build_database(emb, per_vector=per_vector, device="cpu")
    jdb = jqz.build_database(jnp.asarray(emb), per_vector=per_vector)
    _eq(db.values, jdb.values)
    _eq(db.norms_sq, jdb.norms_sq)
    # The scale equals the reference's quantize_int8 bit for bit (tested
    # above); the jitted build_database lets XLA rewrite the per-vector
    # division, which moves a few scales by one ulp.
    ulp = np.abs(db.scale.numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jdb.scale).view(np.int32))
    assert db.scale.shape == jdb.scale.shape and ulp.max() <= 1
    assert db.norms_sq.dtype == torch.int32
    assert (db.num_docs, db.dim) == (100, 64)


# ---------------------------------------------------------------------------
# Planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(1, 8), (37, 64), (256, 256)])
def test_nibble_planes_match_reference(n, d):
    codes = _codes(n, d, seed=n + d)
    codes[0, :8] = [-128, 127, 0, -1, 1, -8, 7, 16][:8]
    t, j = torch.from_numpy(codes), jnp.asarray(codes)

    @jax.jit
    def reference(j):
        jm, jl = jbp.pack_nibble_planes(j)
        return (jm, jl, *jbp.split_nibbles_signed(jm),
                jbp.unpack_nibble_plane_signed(jm),
                jbp.unpack_nibble_plane_unsigned(jl))
    msb, lsb = tbp.pack_nibble_planes(t)
    got = (msb, lsb, *tbp.split_nibbles_signed(msb),
           tbp.unpack_nibble_plane_signed(msb),
           tbp.unpack_nibble_plane_unsigned(lsb))
    for g, w in zip(got, reference(j)):
        _eq(g, w)
    _eq(tbp.reconstruct_int8(msb, lsb), codes)


@pytest.mark.parametrize("n,d", [(5, 8), (40, 64), (128, 256)])
def test_sign_and_bit_planes_match_reference(n, d):
    codes = _codes(n, d, seed=7 * n + d)
    codes[0, 0] = 0
    t, j = torch.from_numpy(codes), jnp.asarray(codes)

    @jax.jit
    def reference(j):
        planes = jbp.pack_bitplanes(j)
        return (jbp.pack_sign_plane(j),
                jbp.unpack_sign_pm1(jbp.pack_sign_plane(j)), jbp.sign_pm1(j),
                planes, jbp.unpack_bitplanes(planes, num_planes=4),
                jbp.unpack_bitplanes(planes, num_planes=8))
    want = reference(j)
    sp = tbp.pack_sign_plane(t)
    msb, _ = tbp.pack_nibble_planes(t)
    _eq(tbp.sign_plane_from_msb(msb), sp)
    planes = tbp.pack_bitplanes(t)
    got = (sp, tbp.unpack_sign_pm1(sp), tbp.sign_pm1(t), planes,
           tbp.unpack_bitplanes(planes, num_planes=4),
           tbp.unpack_bitplanes(planes, num_planes=8))
    for g, w in zip(got, want):
        _eq(g, w)


def test_block_rows_and_gather_match_reference():
    rng = np.random.default_rng(8)
    plane = rng.integers(0, 256, size=(70, 16)).astype(np.uint8)
    ids = np.array([[0, 4], [3, 1], [4, 4]], np.int32)       # block 4 ragged
    _eq(tbp.expand_block_rows(torch.from_numpy(ids), 16),
        jbp.expand_block_rows(jnp.asarray(ids), 16))
    g, rows = tbp.gather_blocks(torch.from_numpy(plane), torch.from_numpy(ids),
                                16)
    jg, jrows = jbp.gather_blocks(jnp.asarray(plane), jnp.asarray(ids), 16)
    _eq(g, jg)
    _eq(rows, jrows)


def test_bitplanar_db_from_quantized_matches_reference():
    rng = np.random.default_rng(9)
    emb = rng.normal(size=(50, 64)).astype(np.float32)
    db = tbp.BitPlanarDB.from_quantized(tqz.build_database(emb,
                                                           device="cpu"))
    jdb = jbp.BitPlanarDB.from_quantized(jqz.build_database(jnp.asarray(emb)))
    for field in ("msb_plane", "lsb_plane", "norms_sq", "scale",
                  "sign_plane"):
        _eq(getattr(db, field), getattr(jdb, field))
    assert (db.num_docs, db.dim) == (jdb.num_docs, jdb.dim)


def test_convert_carries_reference_state():
    rng = np.random.default_rng(10)
    emb = rng.normal(size=(30, 64)).astype(np.float32)
    jq = jqz.build_database(jnp.asarray(emb))
    jdb = jbp.BitPlanarDB.from_quantized(jq)
    db = convert.bitplanar_db(*(np.asarray(x) for x in (
        jdb.msb_plane, jdb.lsb_plane, jdb.norms_sq, jdb.scale,
        jdb.sign_plane)), device="cpu")
    want = tbp.BitPlanarDB.from_quantized(tqz.build_database(emb,
                                                             device="cpu"))
    for field in ("msb_plane", "lsb_plane", "norms_sq", "scale",
                  "sign_plane"):
        assert torch.equal(getattr(db, field), getattr(want, field)), field
    qdb = convert.quantized_db(np.asarray(jq.values), np.asarray(jq.scale),
                               np.asarray(jq.norms_sq), device="cpu")
    assert torch.equal(qdb.values, torch.from_numpy(np.array(jq.values)))
    codes = convert.query_codes(np.array(jq.values[:3]), device="cpu")
    assert codes.dtype == torch.int8 and codes.shape == (3, 64)
    with pytest.raises(TypeError):
        convert.query_codes(np.zeros((2, 8), np.int32), device="cpu")
    with pytest.raises(TypeError):
        convert.bitplanar_db(np.asarray(jdb.msb_plane), np.asarray(
            jdb.lsb_plane), np.asarray(jdb.norms_sq).astype(np.int64),
            np.asarray(jdb.scale), device="cpu")


def test_entry_points_need_cuda_or_an_explicit_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tqz.build_database(np.zeros((4, 8), np.float32))
    with pytest.raises(RuntimeError):
        convert.query_codes(np.zeros((1, 8), np.int8))


# ---------------------------------------------------------------------------
# Exact integer products and the comparator
# ---------------------------------------------------------------------------

def test_integer_products_match_reference():
    a = _codes(40, 96, seed=11)
    q = _codes(6, 96, seed=12)
    rows = _codes(6 * 9, 96, seed=13).reshape(6, 9, 96)
    _eq(tsim.int_matmul(torch.from_numpy(a), torch.from_numpy(q)),
        jsim.int_matmul(jnp.asarray(a), jnp.asarray(q)))
    _eq(tsim.int_bmm(torch.from_numpy(rows), torch.from_numpy(q)),
        jsim.int_bmm(jnp.asarray(rows), jnp.asarray(q)))
    _eq(tsim.int_matvec(torch.from_numpy(a), torch.from_numpy(q[0])),
        jsim.int_matvec(jnp.asarray(a), jnp.asarray(q[0])))
    # extremes: the most negative code everywhere, D = 1024
    lo = np.full((2, 1024), -128, np.int8)
    _eq(tsim.int_matmul(torch.from_numpy(lo), torch.from_numpy(lo)),
        np.full((2, 2), 128 * 128 * 1024, np.int32))


def _fraction_cases():
    rng = np.random.default_rng(14)
    s = rng.integers(-60000, 60000, size=400).astype(np.int32)
    n = rng.integers(0, 200000, size=400).astype(np.int32)
    edge_s = np.array([MASKED_SCORE, 2 ** 31 - 1, -(2 ** 31 - 1), 0, 1, -1,
                       123456, -123456, 2 ** 31 - 1, 5], np.int32)
    edge_n = np.array([1, 2 ** 31 - 1, 2 ** 31 - 1, 0, 0, 1, 1, 1, 1, 0],
                      np.int32)
    s = np.concatenate([s, edge_s])
    n = np.concatenate([n, edge_n])
    return s, n


def test_fraction_greater_matches_reference_all_pairs():
    s, n = _fraction_cases()
    ts, tn = torch.from_numpy(s), torch.from_numpy(n)
    got = tsim.fraction_greater(ts[:, None], tn[:, None], ts[None, :],
                                tn[None, :])
    want = jax.jit(lambda a, b: jsim.fraction_greater(
        a[:, None], b[:, None], a[None, :], b[None, :]))(jnp.asarray(s),
                                                         jnp.asarray(n))
    _eq(got, want)


def test_rerank_dense_comparator_matches_reference():
    rng = np.random.default_rng(15)
    s = rng.integers(-5000, 5000, size=(7, 50)).astype(np.int32)
    n = rng.integers(0, 50000, size=(7, 50)).astype(np.int32)
    s[0, :10] = 77                 # ties
    n[0, :10] = 900
    s[1, :5] = MASKED_SCORE
    n[1, :5] = 1
    idx, top = tsim.rerank_dense_comparator(torch.from_numpy(s),
                                            torch.from_numpy(n), 5)
    jidx, jtop = jax.jit(jax.vmap(
        lambda a, b: jsim.rerank_dense_comparator(a, b, 5)))(
        jnp.asarray(s), jnp.asarray(n))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _eq(top, jtop)


def test_cosine_key_within_two_ulp_of_reference():
    """Not bit-equal by design: rsqrt rounds differently (by 1 ulp), and
    the product with the score can widen that to 2 ulp."""
    rng = np.random.default_rng(16)
    s = rng.integers(-40000, 40000, size=5000).astype(np.int32)
    n = rng.integers(0, 2 ** 23, size=5000).astype(np.int32)
    got = tsim.cosine_key_f32(torch.from_numpy(s), torch.from_numpy(n))
    want = np.array(jsim.cosine_key_f32(jnp.asarray(s), jnp.asarray(n)))
    ulp = np.abs(tsim._ordered_i32(got).numpy().astype(np.int64)
                 - tsim._ordered_i32(torch.from_numpy(want)).numpy())
    assert ulp.max() <= 2
    assert got[n == 0].eq(0).all()


# ---------------------------------------------------------------------------
# Stable top-k
# ---------------------------------------------------------------------------

def test_stable_topk_measured_example():
    x = np.array([1, 3, 3, 2, 3, 1], np.int32)
    _, idx = tsim.stable_topk(torch.from_numpy(x), 4)
    assert idx.tolist() == [1, 2, 4, 3]
    assert np.asarray(jax.lax.top_k(jnp.asarray(x), 4)[1]).tolist() == \
        [1, 2, 4, 3]


@pytest.mark.parametrize("k", [1, 7, 40])
def test_stable_topk_int32_ties_match_lax(k):
    rng = np.random.default_rng(17 + k)
    x = rng.integers(-3, 4, size=(5, 40)).astype(np.int32)
    x[0, :] = 2 ** 31 - 1
    x[1, ::3] = -(2 ** 31)
    vals, idx = tsim.stable_topk(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    _eq(vals, jv)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_stable_topk_float_specials_match_lax():
    rng = np.random.default_rng(18)
    x = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, -np.inf, np.inf, 3e-41,
                             -3e-41], np.float32), size=(6, 64))
    x = x.astype(np.float32)
    vals, idx = tsim.stable_topk(torch.from_numpy(x), 64)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


def test_stable_topk_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tsim.stable_topk(torch.zeros(4, dtype=torch.float64), 2)


# ---------------------------------------------------------------------------
# Synthetic corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_docs=300, dim=64, num_queries=9, seed=3),
    dict(num_docs=4096, dim=256, num_queries=80, noise=0.1, seed=1234,
         cluster_size=64, cluster_spread=0.2),
])
def test_retrieval_corpus_matches_reference(kw):
    for got, want in zip(t_corpus(**kw), j_corpus(**kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_configs_are_frozen_dataclasses():
    from repro_torch.core.retrieval import RetrievalConfig
    cfg = RetrievalConfig()
    assert cfg.backend == "cuda"
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.k = 3
