"""The port's models (`repro_torch.models`, `repro_torch.configs`) against
the reference's (`repro.models`, `repro.configs`), on the CPU.

The reference's parameters (drawn with its own initializers, then the
norms' gains and the QKV biases perturbed in numpy so they matter) are
carried across by `repro_torch.convert`, and the same numpy tokens go
through both packages. Tolerances, all absolute:

  * attention (naive, chunked, decode), rmsnorm, RoPE, SwiGLU: ATOL 2e-5
    (f32 products summed in another order);
  * the embedder: 1e-5, and unit norm within 1e-5 (tests/test_models.py);
  * the dense model at f32 compute: LOGITS_ATOL 1e-4 for forward, prefill
    and decode, and decode equal to teacher forcing within 1e-4
    (tests/test_models.py:27); at bf16 compute BF16_ATOL 5e-2 (bf16 keeps
    8 mantissa bits, 2^-8 ~ 4e-3 of each activation);
  * the quantized-KV decode: the cache's INT8 planes bit-identical when
    built from the same K, logits within 1e-4 end to end, and top_k >= T
    within 0.1 of `decode_step` (tests/test_serve.py:180).

End to end the port's keys come out of its own f32 products, which can
differ from the reference's by an ulp, so an INT8 code of a key or a
centroid may round the other way. A differing code is exempted only where
the port's value before rounding lies within NEAR_HALF of a .5 boundary
(a centroid also when its page holds an exempted key), and the count is
printed (`-s`).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import dense as jdense
from repro.models import embedder as jembedder
from repro.models import common as jcommon
from repro.models.common import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import bitplanar
from repro_torch.models import attention, common, dense, embedder, get_model
from repro_torch.models.common import ModelConfig
from repro_torch.serve import sparse_kv

ATOL = 2e-5
LOGITS_ATOL = 1e-4
BF16_ATOL = 5e-2
NEAR_HALF = 1e-3
EXEMPTED = []

# tests/test_models.py:27's model
SMALL = dict(name="t", family="dense", num_layers=3, d_model=64, num_heads=4,
             num_kv_heads=2, d_ff=128, vocab_size=97, qkv_bias=True,
             attn_chunk=8, compute_dtype="float32")


@pytest.fixture(autouse=True)
def report_exemptions(request):
    EXEMPTED.clear()
    yield
    if any(EXEMPTED):
        print(f"{request.node.name}: {sum(EXEMPTED)} INT8 codes exempted "
              "as within NEAR_HALF of a rounding boundary")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, atol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


def ref_dense(seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params)."""
    fields = {**SMALL, **kw}
    jcfg, tcfg = JModelConfig(**fields), ModelConfig(**fields)
    p = jax.tree.map(np.asarray, jdense.init_params(jcfg,
                                                    jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    blocks = p["blocks"]
    for name in ("ln1", "ln2", "bq", "bk", "bv"):
        if name in blocks:
            blocks[name] = (blocks[name] + rng.normal(
                scale=0.1, size=blocks[name].shape)).astype(np.float32)
    p["final_norm"] = (p["final_norm"] + rng.normal(
        scale=0.1, size=p["final_norm"].shape)).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, p),
            convert.dense_params(p, device="cpu"))


def tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# -- attention, norms, rope, mlp ---------------------------------------------

def _qkv(b=2, s=64, t=64, h=4, kh=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, kh, hd), (b, t, kh, hd))]


@pytest.mark.parametrize("causal", [True, False])
def test_naive_attention_matches_reference(causal):
    q, k, v = _qkv(s=24, t=24)
    got = attention.naive_attention(_t(q), _t(k), _t(v), causal=causal)
    want = jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    _close(got, want, ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_attention_matches_reference(chunk, causal):
    q, k, v = _qkv()
    got = attention.chunked_attention(_t(q), _t(k), _t(v), chunk=chunk,
                                      causal=causal)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), chunk=chunk,
                                   causal=causal)
    _close(got, want, ATOL)
    # and the port's chunked path against its own naive one
    _close(got, attention.naive_attention(_t(q), _t(k), _t(v),
                                          causal=causal).numpy(), ATOL)


@pytest.mark.parametrize("length", [0, 3, 24, (0, 17)])
def test_decode_attention_matches_reference(length):
    q, k, v = _qkv(s=1, t=24)
    got = attention.decode_attention(_t(q), _t(k), _t(v),
                                     torch.tensor(length, dtype=torch.int32))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  jnp.asarray(length, jnp.int32))
    _close(got, want, ATOL)
    if length == 0:    # every score masked alike: the mean of V
        _close(got, v.mean(axis=1).reshape(2, 1, 2, 1, 16).repeat(
            2, axis=3).reshape(2, 1, 4, 16), ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    g = rng.normal(size=(64,)).astype(np.float32)
    got = common.rmsnorm(_t(x).to(getattr(torch, dtype)), _t(g), 1e-5)
    want = jcommon.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(g), 1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got, np.asarray(want, np.float32),
           ATOL if dtype == "float32" else 2 ** -7 * 8)


@pytest.mark.parametrize("positions", [np.arange(40),
                                       np.array([[7], [300]])])
def test_rope_tables_and_apply_rope_match_reference(positions):
    pos = positions.astype(np.int32)
    tc, ts = common.rope_tables(_t(pos), 16, 1e6)
    jc, js = jcommon.rope_tables(jnp.asarray(pos), 16, 1e6)
    _close(tc, jc, ATOL)
    _close(ts, js, ATOL)
    s = pos.shape[-1]
    x = np.random.default_rng(1).normal(size=(2, s, 3, 16)).astype(
        np.float32)
    got = common.apply_rope(_t(x), tc, ts)
    _close(got, jcommon.apply_rope(jnp.asarray(x), jc, js), ATOL)
    # rotate-half: dims i and i + 8 form a pair, not (2i, 2i + 1)
    c, sn = tc.numpy(), ts.numpy()
    c, sn = ((c[None, :, None], sn[None, :, None]) if c.ndim == 2
             else (c[:, :, None], sn[:, :, None]))
    want0 = x[..., 0] * c[..., 0] - x[..., 8] * sn[..., 0]
    _close(got[..., 0], want0, ATOL)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32)
    got = common.swiglu(*map(_t, (x, wg, wu, wd)))
    want = jcommon.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))
    _close(got, want, 1e-4)


# -- the embedder -------------------------------------------------------------

def test_embedder_matches_reference_normalized_and_mask_aware():
    """tests/test_models.py:168's widths, the reference's parameters."""
    jcfg = jembedder.MINILM_CFG.with_(num_layers=2, d_model=32, num_heads=4,
                                      num_kv_heads=4, d_ff=64, vocab_size=50,
                                      pooled_dim=16)
    tcfg = embedder.MINILM_CFG.with_(num_layers=2, d_model=32, num_heads=4,
                                     num_kv_heads=4, d_ff=64, vocab_size=50,
                                     pooled_dim=16)
    p = jax.tree.map(np.asarray, jembedder.init_params(
        jcfg, jax.random.PRNGKey(0)))
    tp = convert.embedder_params(p, device="cpu")
    toks = tokens((3, 10), 50)
    e = embedder.encode(tp, _t(toks), tcfg)
    _close(e, jembedder.encode(jax.tree.map(jnp.asarray, p),
                               jnp.asarray(toks), jcfg), 1e-5)
    _close(torch.linalg.vector_norm(e, dim=-1), np.ones(3), 1e-5)
    mask = np.ones((3, 10), bool)
    mask[:, 5:] = False
    e_m = embedder.encode(tp, _t(toks), tcfg, _t(mask))
    _close(e_m, jembedder.encode(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(toks), jcfg,
                                 jnp.asarray(mask)), 1e-5)
    _close(torch.linalg.vector_norm(e_m, dim=-1), np.ones(3), 1e-5)
    assert float((e - e_m).abs().max()) > 1e-4        # pooling mask matters


@pytest.mark.parametrize("which", ["embedder", "qwen2-0.5b"])
def test_init_matches_the_reference_layout(which):
    """init_params gives the reference's keys, shapes, dtypes and constant
    leaves, on the generator's device; the parameter count too."""
    if which == "embedder":
        jcfg, tcfg = jembedder.MINILM_CFG, embedder.MINILM_CFG
        want = jax.eval_shape(lambda: jembedder.init_params(
            jcfg, jax.random.PRNGKey(0)))
        got = embedder.init_params(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    else:
        jcfg, tcfg = jget_config(which, True), get_config(which, True)
        want = jax.eval_shape(lambda: jdense.init_params(
            jcfg, jax.random.PRNGKey(0)))
        got = dense.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_w = {jax.tree_util.keystr(k): v for k, v in flat_w.items()}
    flat_g = {}

    def walk(tree, prefix):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}['{name}']")
            else:
                flat_g[f"{prefix}['{name}']"] = leaf
    walk(got, "")
    assert sorted(flat_g) == sorted(flat_w)
    for key, leaf in flat_g.items():
        assert tuple(leaf.shape) == flat_w[key].shape, key
        assert leaf.dtype == torch.float32, key
    assert common.param_count(got) == sum(
        int(np.prod(v.shape)) for v in flat_w.values())
    for key in ("['final_norm']", "['blocks']['ln1']"):
        assert bool((flat_g[key] == 1).all())
    # the fan-in scale of the truncated normal
    wq = flat_g["['blocks']['wq']"]
    assert float(wq.abs().max()) <= 2 * tcfg.d_model ** -0.5 + 1e-6
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 0.88) < 0.1


# -- the dense model ----------------------------------------------------------

def test_dense_forward_prefill_decode_match_reference():
    """f32 compute: forward (chunked attention, S = 16 over 8-token
    chunks), prefill (naive, S = 10) and six decode steps, each within
    LOGITS_ATOL of the reference; decode equals teacher forcing."""
    jcfg, tcfg, jp, tp = ref_dense()
    toks = tokens((2, 16), 97)
    full = dense.forward(tp, _t(toks), tcfg)
    _close(full, jdense.forward(jp, jnp.asarray(toks), jcfg),
           LOGITS_ATOL, "forward")
    lg, cache = dense.prefill(tp, _t(toks[:, :10]), tcfg, max_len=16)
    jlg, jcache = jdense.prefill(jp, jnp.asarray(toks[:, :10]), jcfg,
                                 max_len=16)
    _close(lg, jlg, LOGITS_ATOL, "prefill")
    _close(cache.k, jcache.k, LOGITS_ATOL, "prefill K")
    assert cache.length.tolist() == [10, 10]
    outs = []
    for i in range(6):
        tok = toks[:, 10 + i:11 + i]
        lg, cache = dense.decode_step(tp, cache, _t(tok), tcfg)
        jlg, jcache = jdense.decode_step(jp, jcache, jnp.asarray(tok), jcfg)
        _close(lg, jlg, LOGITS_ATOL, f"decode step {i}")
        outs.append(lg)
    assert cache.length.tolist() == [16, 16]
    _close(torch.cat(outs, 1), full[:, 10:16].numpy(), LOGITS_ATOL,
           "decode against teacher forcing")
    _close(cache.v, jcache.v, LOGITS_ATOL, "V after decode")


def test_dense_bf16_matches_reference():
    """The compute dtype the full model serves at: bf16 products, f32
    weights cast per call, within BF16_ATOL."""
    jcfg, tcfg, jp, tp = ref_dense(compute_dtype="bfloat16")
    toks = tokens((2, 16), 97)
    full = dense.forward(tp, _t(toks), tcfg)
    assert full.dtype == torch.bfloat16
    _close(full, jdense.forward(jp, jnp.asarray(toks), jcfg), BF16_ATOL)
    lg, cache = dense.prefill(tp, _t(toks[:, :12]), tcfg, max_len=16)
    jlg, jcache = jdense.prefill(jp, jnp.asarray(toks[:, :12]), jcfg,
                                 max_len=16)
    _close(lg, jlg, BF16_ATOL)
    lg, _ = dense.decode_step(tp, cache, _t(toks[:, 12:13]), tcfg)
    jlg, _ = jdense.decode_step(jp, jcache, jnp.asarray(toks[:, 12:13]),
                                jcfg)
    _close(lg, jlg, BF16_ATOL)


def _bf16_ulps(got: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """|got - exact| in units of the bf16 spacing at `exact` (f64)."""
    _, e = torch.frexp(exact.abs().clamp_min(2.0 ** -126))
    return (got.double() - exact).abs() / torch.ldexp(
        torch.ones_like(exact), e - 8)


def test_bf16_prefill_keys_are_correctly_rounded():
    """Which package rounds the bf16 prefill right (ROADMAP C16), on
    tests/test_decode_cascade.py:268's generator. Each of the port's
    layers, fed its own input, writes to the cache the rotation of a K
    product that lies within one bf16 ulp of the same bf16 operands
    multiplied in f64, and the reference's K product of those operands
    does too. The keys part from layer 1 on because the layer-0 MLP parts:
    the port's bf16 SwiGLU gate silu(g) is within one ulp of silu in f64,
    the reference's `jax.nn.silu` on bf16 is not; its count is printed
    (`-s`)."""
    fields = dict(name="g", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=64,
                  compute_dtype="bfloat16")
    jcfg, tcfg = JModelConfig(**fields), ModelConfig(**fields)
    p = jax.tree.map(np.asarray, jdense.init_params(jcfg,
                                                    jax.random.PRNGKey(1)))
    tp = convert.dense_params(p, device="cpu")
    toks = tokens((2, 24), 64)
    _, cache = dense.prefill(tp, _t(toks), tcfg)
    cos, sin = common.rope_tables(torch.arange(24), tcfg.hd,
                                  tcfg.rope_theta)
    bf = torch.bfloat16

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    x = dense.embed_tokens(tp, _t(toks), tcfg)
    for layer in range(2):
        blk = {k: v[layer] for k, v in tp["blocks"].items()}
        jblk = {k: jnp.asarray(v[layer]) for k, v in p["blocks"].items()}
        hn = common.rmsnorm(x, blk["ln1"], tcfg.norm_eps)
        exact = hn.double() @ blk["wk"].to(bf).double()
        k = hn @ blk["wk"].to(bf)
        jk = _t(jdense._qkv(jblk, to_jax(hn), jcfg)[1].astype(jnp.float32))
        assert _bf16_ulps(k, exact).max() <= 1.0
        assert _bf16_ulps(jk.reshape(k.shape), exact).max() <= 1.0
        x_next, (kr, _) = dense.block_fwd(blk, x, cos, sin, tcfg)
        want = common.apply_rope(k.reshape(kr.shape), cos, sin)
        assert torch.equal(kr, want) and torch.equal(cache.k[layer], kr)
        x = x_next
    # the layer-0 MLP gate at the port's own post-attention residual
    blk = {k: v[0] for k, v in tp["blocks"].items()}
    x = dense.embed_tokens(tp, _t(toks), tcfg)
    q, k, v = dense._qkv(blk, common.rmsnorm(x, blk["ln1"], tcfg.norm_eps),
                         tcfg)
    o = attention.chunked_causal_attention(
        common.apply_rope(q, cos, sin), common.apply_rope(k, cos, sin), v,
        tcfg.attn_chunk)
    x = x + o.reshape(2, 24, -1) @ blk["wo"].to(bf)
    g = common.rmsnorm(x, blk["ln2"], tcfg.norm_eps) @ blk["w_gate"].to(bf)
    exact = torch.nn.functional.silu(g.double())
    silu = torch.nn.functional.silu(g)
    assert _bf16_ulps(silu, exact).max() <= 1.0
    ref = _t(jax.nn.silu(to_jax(g)).astype(jnp.float32)).double()
    rounded = exact.to(bf)
    print(f"bf16 silu of {g.numel()} gate values, not the f64 value rounded "
          f"once: port {int((silu != rounded).sum())}, reference "
          f"{int((ref != rounded.double()).sum())}; more than one ulp off: "
          f"reference {int((_bf16_ulps(ref, exact) > 1.0).sum())}")


def test_vlm_prefix_embeds_match_reference():
    jcfg, tcfg, jp, tp = ref_dense(family="vlm")
    toks = tokens((2, 6), 97)
    prefix = np.random.default_rng(5).normal(size=(2, 3, 64)).astype(
        np.float32)
    got = get_model(tcfg).prefill(tp, {"tokens": _t(toks),
                                       "prefix_embeds": _t(prefix)})[0]
    want = jdense.forward(jp, jnp.asarray(toks), jcfg,
                          prefix_embeds=jnp.asarray(prefix))
    assert tuple(got.shape) == (2, 9, 97)
    _close(got, want, LOGITS_ATOL)


def test_decode_past_the_cache_raises():
    """The reference drops a write past the cache; the port raises."""
    _, tcfg, _, tp = ref_dense()
    toks = _t(tokens((2, 8), 97))
    _, cache = dense.prefill(tp, toks, tcfg, max_len=9)
    _, cache = dense.decode_step(tp, cache, toks[:, :1], tcfg)
    with pytest.raises(IndexError, match="past the cache"):
        dense.decode_step(tp, cache, toks[:, :1], tcfg)
    q = dense.quantize_cache(dense.prefill(tp, toks, tcfg)[1])
    with pytest.raises(IndexError, match="past the cache"):
        dense.decode_step_quant(tp, q, toks[:, :1], tcfg, top_k=4)


# -- the quantized-KV decode --------------------------------------------------

def _codes(msb, lsb):
    """INT8 codes from nibble planes (either package's arrays)."""
    m, l_ = _t(np.asarray(msb)), _t(np.asarray(lsb))
    return bitplanar.reconstruct_int8(m.reshape(-1, m.shape[-1]),
                                      l_.reshape(-1, l_.shape[-1])).reshape(
        *m.shape[:-1], 2 * m.shape[-1]).numpy()


def _near_half(x: np.ndarray) -> np.ndarray:
    return np.abs(np.abs(x) - np.floor(np.abs(x)) - 0.5) < NEAR_HALF


def _centroid_values(k_msb, k_lsb, k_scale, length, page_rows):
    """The port's page means over its own codes, divided by its centroid
    scales' denominator: (pre-rounding codes, page means) per (L, B, P,
    KH), by `sparse_kv.build_page_centroids`' arithmetic."""
    out = []
    for i in range(k_msb.shape[0]):
        c = sparse_kv.QuantKVCache(k_msb=k_msb[i], k_lsb=k_lsb[i],
                                   k_scale=k_scale[i], v=k_scale[i])
        b, t, kh, hd2 = c.k_msb.shape
        p = t // page_rows
        pagev = sparse_kv._dequantized(c.k_msb, c.k_lsb, c.k_scale).reshape(
            b, p, page_rows, kh, 2 * hd2)
        pos = torch.arange(t).reshape(p, page_rows)
        live = pos[None] < length.reshape(-1, 1, 1)
        cnt = live.sum(dim=2).float()
        mean = (torch.where(live[..., None, None], pagev, 0.0).sum(dim=2)
                / torch.clamp(cnt, min=1.0)[..., None, None])
        scale = torch.clamp(mean.abs().amax(-1), min=1e-12) / 127.0
        out.append((mean / scale[..., None]).numpy())
    return np.stack(out)


def _check_quant_cache(tq, jq, k_port, what):
    """Planes equal but for codes within NEAR_HALF of a rounding boundary
    (counted); scales within 1e-5 relative; centroids likewise, a page's
    centroid also exempt where the page holds an exempted key."""
    tc, jc = _codes(tq.k_msb, tq.k_lsb), _codes(jq.k_msb, jq.k_lsb)
    scale = tq.k_scale.numpy()
    np.testing.assert_allclose(scale, np.asarray(jq.k_scale), rtol=1e-5,
                               err_msg=what)
    diff = tc != jc
    if diff.any():
        pre = k_port.float().numpy() / scale[..., None]
        bad = diff & ~_near_half(pre)
        assert not bad.any(), (what, np.argwhere(bad)[:4])
        assert np.abs(tc.astype(int) - jc.astype(int))[diff].max() == 1
        EXEMPTED.append(int(diff.sum()))
    _close(tq.v, jq.v, LOGITS_ATOL, what + " V")
    if tq.cent_msb is None:
        assert jq.cent_msb is None
        return
    np.testing.assert_allclose(tq.cent_scale.numpy(),
                               np.asarray(jq.cent_scale), rtol=1e-5,
                               err_msg=what)
    got = bitplanar.unpack_nibble_plane_signed(tq.cent_msb).numpy()
    want = bitplanar.unpack_nibble_plane_signed(
        _t(np.asarray(jq.cent_msb))).numpy()
    cdiff = got != want
    if cdiff.any():
        pre = _centroid_values(tq.k_msb, tq.k_lsb, tq.k_scale, tq.length,
                               tq.page_rows)
        l_, b, t = diff.shape[:3]
        page_hit = diff.reshape(l_, b, t // tq.page_rows, tq.page_rows,
                                *diff.shape[3:]).any(axis=(3, 5))
        # a MSB nibble flips only where the code crosses 16m - 0.5
        near = np.abs(pre + 0.5 - 16 * np.round((pre + 0.5) / 16)) < NEAR_HALF
        assert not (cdiff & ~(near | page_hit[..., None])).any(), what
        EXEMPTED.append(int(cdiff.sum()))


@pytest.mark.parametrize("paged", [None, 4])
def test_quantize_cache_planes_bit_identical_from_the_same_k(paged):
    """The reference's prefill K fed to both quantize_cache functions:
    planes, scales and centroids bit for bit (the reference vmaps over
    layers, the port flattens them)."""
    jcfg, _, jp, _ = ref_dense()
    toks = tokens((2, 10), 97)
    _, jcache = jdense.prefill(jp, jnp.asarray(toks), jcfg, max_len=16)
    tcache = dense.KVCache(k=_t(np.asarray(jcache.k)),
                           v=_t(np.asarray(jcache.v)),
                           length=_t(np.asarray(jcache.length)))
    tq = dense.quantize_cache(tcache, page_rows=paged)
    jq = jdense.quantize_cache(jcache, page_rows=paged)
    fields = ["k_msb", "k_lsb", "k_scale", "v", "length"]
    if paged:
        fields += ["cent_msb", "cent_scale"]
    else:
        assert tq.cent_msb is None and jq.cent_msb is None
    for name in fields:
        got, want = getattr(tq, name).numpy(), np.asarray(getattr(jq, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tq.page_rows == jq.page_rows
    # the QuantCache owns its V: decoding it leaves the KVCache intact
    assert tq.v.data_ptr() != tcache.v.data_ptr()


QUANT_SCHEDULES = {
    "flat": dict(top_k=8),
    "paged": dict(top_k=8, npages=2),
    "paged_prescreen": dict(top_k=6, npages=3, prescreen_c0=10),
}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("schedule", list(QUANT_SCHEDULES))
def test_decode_step_quant_matches_reference(schedule, backend,
                                             monkeypatch):
    """Prefill 12 tokens into a 16-position cache (4-row pages when paged),
    quantize it, then three decode steps through both packages: logits
    within LOGITS_ATOL, the planes and centroids equal but for the
    exempted codes after every step."""
    knobs = QUANT_SCHEDULES[schedule]
    page_rows = 4 if "npages" in knobs else None
    jcfg, tcfg, jp, tp = ref_dense(num_layers=2)
    toks = tokens((2, 15), 97, seed=3)
    _, tcache = dense.prefill(tp, _t(toks[:, :12]), tcfg, max_len=16)
    _, jcache = jdense.prefill(jp, jnp.asarray(toks[:, :12]), jcfg,
                               max_len=16)
    k_port = tcache.k.clone()
    tq = dense.quantize_cache(tcache, page_rows=page_rows)
    jq = jdense.quantize_cache(jcache, page_rows=page_rows)
    _check_quant_cache(tq, jq, k_port, "after quantize_cache")
    seen = []
    real = sparse_kv.quantize_keys

    def spy(k):
        seen.append(k.clone())
        return real(k)
    for step in range(3):
        tok = toks[:, 12 + step:13 + step]
        seen.clear()
        with monkeypatch.context() as m:
            m.setattr(sparse_kv, "quantize_keys", spy)
            tl, tq = dense.decode_step_quant(tp, tq, _t(tok), tcfg,
                                             backend=backend, **knobs)
        jl, jq = jdense.decode_step_quant(jp, jq, jnp.asarray(tok), jcfg,
                                          **knobs)
        _close(tl, jl, LOGITS_ATOL, f"{schedule} step {step}")
        assert len(seen) == tcfg.num_layers
        for i, k in enumerate(seen):
            k_port[i, :, 12 + step] = k[:, 0]
        assert tq.length.tolist() == [13 + step] * 2
        _check_quant_cache(tq, jq, k_port, f"{schedule} step {step}")


def test_quant_decode_matches_dense_decode_with_full_topk():
    """tests/test_serve.py:180: top_k >= T against the f32 decode_step,
    two steps, within 0.1."""
    _, tcfg, _, tp = ref_dense(num_layers=2, qkv_bias=False)
    toks = _t(tokens((2, 12), 97))
    _, cache = dense.prefill(tp, toks[:, :8], tcfg, max_len=12)
    qcache = dense.quantize_cache(cache)
    for i in (8, 9):
        lg_d, cache = dense.decode_step(tp, cache, toks[:, i:i + 1], tcfg)
        lg_q, qcache = dense.decode_step_quant(tp, qcache, toks[:, i:i + 1],
                                               tcfg, top_k=12)
        assert float((lg_d - lg_q).abs().max()) < 0.1


def test_paged_quant_cache_needs_pages():
    _, tcfg, _, tp = ref_dense(num_layers=1)
    q = dense.init_quant_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="paged cache"):
        dense.decode_step_quant(tp, q, _t(tokens((2, 1), 97)), tcfg,
                                top_k=4, npages=2)
    with pytest.raises(ValueError, match="multiple of page_rows"):
        dense.init_quant_cache(tcfg, 2, 18, page_rows=4, device="cpu")
    paged = dense.init_quant_cache(tcfg, 2, 16, page_rows=4, device="cpu")
    assert tuple(paged.cent_msb.shape) == (1, 2, 4, 2, 8)


# -- configs, registry, conversion, devices -----------------------------------

# fields of the reference's ModelConfig that no ported model reads
TRAINING_FIELDS = {"remat", "scan_layers", "seq_shard", "optimizer"}


def test_configs_equal_the_reference_and_refuse_unported_ids():
    """Every field the port keeps equals the reference's; every field it
    leaves out is training-only or at the reference's default, so the
    port drops no setting that these configs make. Unknown ids and
    families raise, as in the reference."""
    defaults = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    for arch in ARCH_IDS + ("minilm-embedder",):
        for smoke in (False, True):
            got, want = get_config(arch, smoke), jget_config(arch, smoke)
            kept = set(got.__dataclass_fields__)
            assert kept <= set(want.__dataclass_fields__)
            assert {f: getattr(got, f) for f in kept} \
                == {f: getattr(want, f) for f in kept}
            for f in set(want.__dataclass_fields__) - kept - TRAINING_FIELDS:
                assert getattr(want, f) == defaults[f], (arch, f)
    full = get_config("qwen2-0.5b")
    assert (full.num_layers, full.d_model, full.hd, full.vocab_size) == (
        24, 896, 64, 151936)
    assert full.cdtype == torch.bfloat16 and full.pdtype == torch.float32
    assert get_config("seamless-m4t-medium").family == "encdec"
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-5")
    for family in ("ssm", "hybrid", "encdec"):
        assert get_model(full.with_(family=family)).cfg.family == family
    # a decoder LM's cache takes and ignores the enc-dec's src_len
    cache = get_model(full).init_cache(1, 4, src_len=9, device="cpu")
    assert tuple(cache.k.shape) == (24, 1, 4, 2, 64)
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        get_model(full.with_(family="rnn"))


def test_model_api_serves_the_dense_model():
    _, tcfg, _, tp = ref_dense()
    api = get_model(tcfg)
    toks = _t(tokens((2, 8), 97))
    lg, cache = api.prefill(tp, {"tokens": toks}, max_len=10)
    lg2, cache = api.decode_step(tp, cache, toks[:, :1])
    assert tuple(lg2.shape) == (2, 1, 97) and cache.length.tolist() == [9, 9]
    assert tuple(api.init_cache(3, 5, device="cpu").k.shape) == (3, 3, 5, 2,
                                                                 16)
    assert set(api.init(torch.Generator().manual_seed(0),
                        device="cpu")) == {"embed", "blocks", "final_norm",
                                           "lm_head"}


def test_convert_refuses_malformed_parameters():
    p = jax.tree.map(np.asarray, jdense.init_params(
        JModelConfig(**SMALL), jax.random.PRNGKey(0)))
    tp = convert.dense_params(p, device="cpu")
    np.testing.assert_array_equal(tp["blocks"]["wq"].numpy(),
                                  p["blocks"]["wq"])
    bad = {**p, "blocks": {**p["blocks"],
                           "wq": p["blocks"]["wq"].astype(np.float64)}}
    with pytest.raises(TypeError, match="float32"):
        convert.dense_params(bad, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.dense_params({k: v for k, v in p.items() if k != "embed"},
                             device="cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.embedder_params(p, device="cpu")        # no "proj"


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: dense.init_params(cfg, gen),
                 lambda: embedder.init_params(embedder.MINILM_CFG, gen),
                 lambda: dense.init_cache(cfg, 1, 4),
                 lambda: dense.init_quant_cache(cfg, 1, 4),
                 lambda: get_model(cfg).init(gen),
                 lambda: get_model(get_config(
                     "llama4-scout-17b-a16e", smoke=True)).init(gen),
                 lambda: convert.dense_params({}),
                 lambda: convert.moe_params({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="generator is on"):
        dense.init_params(cfg, gen, device="meta")
