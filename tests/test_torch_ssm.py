"""The port's SSM and hybrid models (`repro_torch.models.mamba2`,
`repro_torch.models.zamba2`) against the reference's (`repro.models.
mamba2`, `repro.models.zamba2`), on the CPU.

The reference's parameters (its own initializers; the gains, biases, D
and dt_bias perturbed in numpy so they matter) are carried across by
`convert.ssm_params` / `convert.hybrid_params`, and the same numpy inputs
go through both packages. Everything is held at f32 compute (the
reference's bf16 silu is not correctly rounded: ROADMAP C16), with these
tolerances, absolute unless said:

  * `ssd_chunked` (the reference test's shapes, chunks 8 and 24, with and
    without an initial state; values up to about 15): y and the final
    state within SSD_ATOL 1e-4 of the reference's, of the other chunking
    and of the token-by-token recurrence (the reference's own bound);
    its grads within GRAD_RTOL of jax.grad's, none NaN;
  * `_causal_conv` within 1e-6, its result f32 on a bf16 input (the
    reference's promotion), bit for bit with the reference there;
  * a block (`block_fwd`, with and without `initial_state`/`conv_init`;
    lengths that `ssm_chunk` divides, does not divide (the one-chunk
    fallback) and shorter than the conv tail) and the models' logits
    within LOGITS_ATOL 1e-4; the SSM state within 1e-5;
  * `loss_fn` within a relative 1e-6 and its grads within GRAD_RTOL 1e-4
    of each leaf's largest |grad| (A_log's grad is a sum of terms about
    a thousand times its size, so it loses the most digits), with remat
    on and off, no grad NaN;
  * decode continues prefill (the reference's two cases) within 1e-4;
  * the converters: a bfloat16 SMOKE tree crosses bit for bit, A_log,
    dt_bias and D staying float32.
"""
import pytest

torch = pytest.importorskip("torch")

import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.models import mamba2 as jmamba2
from repro.models import zamba2 as jzamba2
from repro.models.common import ModelConfig as JModelConfig
from repro_torch import _tree, convert
from repro_torch.configs import get_config
from repro_torch.models import dense, get_model, mamba2, zamba2
from repro_torch.models.common import (ModelConfig, cross_entropy_loss,
                                       param_count)
from repro_torch.train.step import value_and_grad

SSD_ATOL = 1e-4
LOGITS_ATOL = 1e-4
STATE_ATOL = 1e-5
GRAD_RTOL = 1e-4
TO_PORT = {"ssm": convert.ssm_params, "hybrid": convert.hybrid_params}
ARCHS = {"ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b"}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


def _perturb(host, rng):
    """Gains, biases, D and dt_bias moved off their initial 1s and 0s."""
    def go(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = go(v)
            elif k in ("ln", "norm", "final_norm", "ln1", "ln2", "D"):
                out[k] = (v * (1 + 0.1 * rng.standard_normal(v.shape))
                          ).astype(v.dtype)
            elif k in ("conv_b", "dt_bias"):
                out[k] = (v + 0.1 * rng.standard_normal(v.shape)
                          ).astype(v.dtype)
            else:
                out[k] = v
        return out
    return go(host)


@functools.lru_cache(maxsize=None)
def _host(family):
    jcfg = jget_config(ARCHS[family], smoke=True)
    host = jax.tree.map(np.asarray,
                        jget_model(jcfg).init(jax.random.PRNGKey(0)))
    return _perturb(host, np.random.default_rng(7))


def both(family, **kw):
    """(reference cfg, port cfg, reference params, port params) of the
    family's SMOKE config at f32 compute with `kw` applied."""
    jcfg = jget_config(ARCHS[family], smoke=True).with_(
        compute_dtype="float32", **kw)
    tcfg = get_config(ARCHS[family], smoke=True).with_(
        compute_dtype="float32", **kw)
    host = _host(family)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, host),
            TO_PORT[family](host, device="cpu"))


def _ssd_inputs(seed=0, bs=2, l=24, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bs, l, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((bs, l, h))) * 0.5).astype(np.float32)
    b = rng.standard_normal((bs, l, n)).astype(np.float32)
    c = rng.standard_normal((bs, l, n)).astype(np.float32)
    s0 = rng.standard_normal((bs, h, p, n)).astype(np.float32)
    return x, a, b, c, s0


def _recurrence(x, a, b, c, s0=None):
    st = np.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]),
                  np.float64) if s0 is None else s0.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        st = st * np.exp(a[:, t])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t], b[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", st, c[:, t]))
    return np.stack(ys, 1), st


@pytest.mark.parametrize("chunk", [8, 24])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference_and_recurrence(chunk, with_state):
    x, a, b, c, s0 = _ssd_inputs()
    s0 = s0 if with_state else None
    y, f = mamba2.ssd_chunked(_t(x), _t(a), _t(b), _t(c), chunk,
                              None if s0 is None else _t(s0))
    jy, jf = jax.jit(jmamba2.ssd_chunked, static_argnums=4)(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
        chunk, None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SSD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=SSD_ATOL,
                               rtol=0)
    ry, rf = _recurrence(x, a, b, c, s0)
    np.testing.assert_allclose(y.numpy(), ry, atol=SSD_ATOL, rtol=0)
    np.testing.assert_allclose(f.numpy(), rf, atol=SSD_ATOL, rtol=0)
    y24, f24 = mamba2.ssd_chunked(_t(x), _t(a), _t(b), _t(c), 24,
                                  None if s0 is None else _t(s0))
    np.testing.assert_allclose(y.numpy(), y24.numpy(), atol=SSD_ATOL)
    np.testing.assert_allclose(f.numpy(), f24.numpy(), atol=SSD_ATOL)


def test_ssd_chunked_refuses_a_chunk_that_does_not_divide():
    x, a, b, c, _ = _ssd_inputs()
    with pytest.raises(ValueError, match="does not divide"):
        mamba2.ssd_chunked(_t(x), _t(a), _t(b), _t(c), 16)


@pytest.mark.parametrize("chunk", [8, 24])
def test_ssd_chunked_grads_match_jax_grad(chunk):
    """The segment sums are masked before exp: no inf reaches the grads."""
    x, a, b, c, s0 = _ssd_inputs(seed=1)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    wf = np.random.default_rng(3).standard_normal(s0.shape).astype(
        np.float32)

    def jloss(x, a, b, c, s0):
        y, f = jmamba2.ssd_chunked(x, a, b, c, chunk, s0)
        return jnp.sum(y * w) + jnp.sum(f * wf)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (x, a, b, c, s0)))
    ins = [_t(v).requires_grad_() for v in (x, a, b, c, s0)]
    y, f = mamba2.ssd_chunked(*ins[:4], chunk, ins[4])
    (torch.sum(y * _t(w)) + torch.sum(f * _t(wf))).backward()
    for t, g in zip(ins, want, strict=True):
        assert not bool(torch.isnan(t.grad).any())
        assert _rel(t.grad.numpy(), g) <= GRAD_RTOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(4)
    xbc = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(24) * 0.1).astype(np.float32)
    jx = jnp.asarray(xbc, getattr(jnp, dtype))
    want = jmamba2._causal_conv(jx, jnp.asarray(w), jnp.asarray(b))
    got = mamba2._causal_conv(_t(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)), _t(w), _t(b))
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("length", [32, 20, 2])
@pytest.mark.parametrize("carried", [False, True])
def test_block_fwd_matches_reference(length, carried):
    """SMOKE's ssm_chunk is 16: 32 is two chunks, 20 the one-chunk
    fallback, 2 shorter than the conv tail. `carried` passes an initial
    state and a conv prefix."""
    jcfg, tcfg, jp, tp = both("ssm")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, length, tcfg.d_model)).astype(np.float32)
    s0 = conv0 = None
    if carried:
        s0 = rng.standard_normal((2, tcfg.ssm_heads, tcfg.ssm_head_dim,
                                  tcfg.ssm_state)).astype(np.float32)
        conv0 = rng.standard_normal((2, tcfg.ssm_conv_width - 1,
                                     mamba2.conv_dim(tcfg))).astype(
            np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["blocks"])
    tlayer = {k: v[0] for k, v in tp["blocks"].items()}
    jout, (jst, jconv) = jax.jit(jmamba2.block_fwd, static_argnums=2)(
        jlayer, jnp.asarray(x), jcfg,
        None if s0 is None else jnp.asarray(s0),
        None if conv0 is None else jnp.asarray(conv0))
    out, (st, conv) = mamba2.block_fwd(
        tlayer, _t(x), tcfg, None if s0 is None else _t(s0),
        None if conv0 is None else _t(conv0))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=STATE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv),
                               atol=STATE_ATOL, rtol=0)


def _batch(cfg, s, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


@functools.lru_cache(maxsize=None)
def _reference_loss(family):
    """The reference's logits, loss and grads on `_batch(cfg, 32)` (its
    remat does not change them; the port's is held both ways)."""
    jcfg, _, jp, _ = both(family)
    jmod = {"ssm": jmamba2, "hybrid": jzamba2}[family]
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg, 32).items()}
    logits = jax.jit(jmod.forward, static_argnums=2)(jp, batch["tokens"],
                                                     jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmod.loss_fn(p, b, jcfg)))(jp, batch)
    return np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_forward_loss_and_grads_match_reference(family, remat):
    _, tcfg, _, tp = both(family, remat=remat)
    batch = {k: _t(v) for k, v in _batch(tcfg, 32).items()}
    tmod = {"ssm": mamba2, "hybrid": zamba2}[family]
    jlogits, jloss, jgrads = _reference_loss(family)
    with torch.no_grad():
        np.testing.assert_allclose(
            tmod.forward(tp, batch["tokens"], tcfg).numpy(), jlogits,
            atol=LOGITS_ATOL, rtol=0)
    loss, grads = value_and_grad(lambda p, b: tmod.loss_fn(p, b, tcfg), tp,
                                 batch)
    assert abs(float(loss) - jloss) <= 1e-6 * abs(jloss)
    for (name, g), w in zip(_tree.named_leaves(grads),
                            jax.tree.leaves(jgrads), strict=True):
        assert not bool(torch.isnan(g).any()), name
        assert _rel(g.numpy(), w) <= GRAD_RTOL, (family, name)


def test_remat_does_not_change_the_grads():
    for family in ("ssm", "hybrid"):
        _, tcfg, _, tp = both(family)
        batch = {k: _t(v) for k, v in _batch(tcfg, 32).items()}
        api_on = get_model(tcfg.with_(remat=True))
        api_off = get_model(tcfg.with_(remat=False))
        l1, g1 = value_and_grad(api_on.loss_fn, tp, batch)
        l2, g2 = value_and_grad(api_off.loss_fn, tp, batch)
        assert float(l1) == float(l2)
        for a, b in zip(_tree.leaves(g1), _tree.leaves(g2), strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_prefill_and_decode_match_reference(family):
    """Prefill 32 tokens (two chunks), then 8 decode steps, both packages
    from the same parameters: each step's logits, and the cache's SSM
    state, conv tail (and the hybrid's K/V) at the end."""
    jcfg, tcfg, jp, tp = both(family)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    toks = _batch(tcfg, 40)["tokens"]
    jlg, jc = jax.jit(japi.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :32])}, 40)
    jdecode = jax.jit(japi.decode_step)
    with torch.no_grad():
        lg, cache = tapi.prefill(tp, {"tokens": _t(toks[:, :32])},
                                 max_len=40)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=LOGITS_ATOL, rtol=0)
        for i in range(32, 40):
            jlg, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]))
            lg, cache = tapi.decode_step(tp, cache, _t(toks[:, i:i + 1]))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                       atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(cache.state.numpy(), np.asarray(jc.state),
                               atol=STATE_ATOL, rtol=0)
    np.testing.assert_allclose(cache.conv.numpy(), np.asarray(jc.conv),
                               atol=STATE_ATOL, rtol=0)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jc.length))
    if family == "hybrid":
        assert tuple(cache.k.shape) == tuple(jc.k.shape)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jc.k),
                                   atol=STATE_ATOL, rtol=0)
        np.testing.assert_allclose(cache.v.numpy(), np.asarray(jc.v),
                                   atol=STATE_ATOL, rtol=0)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_decode_writes_the_cache_in_place(family):
    _, tcfg, _, tp = both(family)
    tapi = get_model(tcfg)
    toks = _t(_batch(tcfg, 9)["tokens"])
    with torch.no_grad():
        _, cache = tapi.prefill(tp, {"tokens": toks[:, :8]}, max_len=9)
        before = cache.state.clone()
        _, after = tapi.decode_step(tp, cache, toks[:, 8:])
    assert after.state is cache.state and after.conv is cache.conv
    assert not torch.equal(before, cache.state)
    assert int(after.length[0]) == 9 and int(cache.length[0]) == 8


# the reference's tests/test_models.py cases, on the port
MAMBA = dict(name="m", family="ssm", num_layers=3, d_model=64, num_heads=1,
             num_kv_heads=1, d_ff=0, vocab_size=89, ssm_state=16,
             ssm_head_dim=16, ssm_chunk=8, compute_dtype="float32",
             remat=False)
ZAMBA = dict(name="z", family="hybrid", num_layers=4, d_model=64,
             num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=83,
             ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
             hybrid_attn_period=2, compute_dtype="float32", attn_chunk=8,
             remat=False)


@pytest.mark.parametrize("kw", [MAMBA, ZAMBA], ids=["mamba2", "zamba2"])
def test_decode_continues_prefill(kw):
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jmod = {"ssm": jmamba2, "hybrid": jzamba2}[kw["family"]]
    tmod = {"ssm": mamba2, "hybrid": zamba2}[kw["family"]]
    host = jax.tree.map(np.asarray, jmod.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    tp = TO_PORT[kw["family"]](host, device="cpu")
    toks = _t(np.random.default_rng(1).integers(
        0, kw["vocab_size"], (2, 24)).astype(np.int32))
    with torch.no_grad():
        full = tmod.forward(tp, toks, tcfg)
        lg, cache = tmod.prefill(tp, toks[:, :16], tcfg, max_len=24)
        np.testing.assert_allclose(lg.numpy(), full[:, :16].numpy(),
                                   atol=1e-4)
        outs = []
        for i in range(8):
            lg, cache = tmod.decode_step(tp, cache, toks[:, 16 + i:17 + i],
                                         tcfg)
            outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               full[:, 16:24].numpy(), atol=1e-4)


def test_zamba2_shared_block_is_shared():
    """One attention block's worth of parameters, not num_apps copies,
    and its grad is the sum over the applications."""
    cfg = ModelConfig(name="z", family="hybrid", num_layers=4, d_model=32,
                      num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=50,
                      ssm_state=8, ssm_head_dim=8, hybrid_attn_period=2,
                      compute_dtype="float32")
    params = zamba2.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    assert params["shared"]["wq"].ndim == 2
    one = dense.init_blocks(cfg.with_(num_layers=1),
                            torch.Generator().manual_seed(0))
    assert param_count(params["shared"]) == param_count(one)
    toks = torch.randint(0, 50, (2, 8), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    _, g = value_and_grad(lambda p, b: zamba2.loss_fn(p, b, cfg), params,
                          batch)
    # the same loss with each application given its own copy of the block
    copies = [{k: v.clone().requires_grad_() for k, v in
               params["shared"].items()} for _ in range(zamba2.num_apps(cfg))]
    x = dense.embed_tokens(params, toks, cfg)
    cos, sin = zamba2._rope(8, x.device, cfg)
    for i, shared in enumerate(copies):
        x = zamba2._superblock_out(dict(params, shared=shared), i, x, cos,
                                   sin, cfg)
    cross_entropy_loss(dense._logits(params, x, cfg), toks).backward()
    for k, total in g["shared"].items():
        torch.testing.assert_close(total, sum(c[k].grad for c in copies),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_bf16_tree_crosses_the_converter_bit_for_bit(family):
    jcfg = jget_config(ARCHS[family], smoke=True).with_(
        param_dtype="bfloat16")
    host = jax.tree.map(np.asarray,
                        jget_model(jcfg).init(jax.random.PRNGKey(3)))
    tp = TO_PORT[family](host, device="cpu")
    for (name, t), w in zip(_tree.named_leaves(tp), jax.tree.leaves(host),
                            strict=True):
        if name.rsplit("__", 1)[-1] in ("A_log", "dt_bias", "D"):
            assert t.dtype == torch.float32 and w.dtype == np.float32, name
            np.testing.assert_array_equal(t.numpy(), w)
        else:
            assert t.dtype == torch.bfloat16 and w.dtype.name == "bfloat16"
            np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                          w.view(np.uint16))
    # the port's own bf16 tree keeps the same three leaves f32
    api = get_model(get_config(ARCHS[family], smoke=True).with_(
        param_dtype="bfloat16"))
    own = api.init(torch.Generator().manual_seed(0), device="cpu")
    for name, t in _tree.named_leaves(own):
        f32 = name.rsplit("__", 1)[-1] in ("A_log", "dt_bias", "D")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_port_init_has_the_reference_keys_shapes_and_dtypes(family):
    jcfg = jget_config(ARCHS[family], smoke=True)
    want = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    got = get_model(get_config(ARCHS[family], smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = _tree.named_leaves(got)
    assert [n for n, _ in gl] == [
        "__".join(str(getattr(k, "key", k)) for k in p) for p, _ in wl]
    for (name, t), (_, w) in zip(gl, wl, strict=True):
        assert tuple(t.shape) == tuple(w.shape), name
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), name
