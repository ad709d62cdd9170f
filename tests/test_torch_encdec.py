"""The port's enc-dec model (`repro_torch.models.encdec`) against the
reference's (`repro.models.encdec`), on the CPU.

The reference's parameters (its own initializers; the norms' gains
perturbed in numpy so they matter) are carried across by
`convert.encdec_params`, and the same numpy frames and tokens go through
both packages at f32 compute, with these tolerances, absolute unless
said:

  * `encode` within LOGITS_ATOL 1e-4, at a source length that the
    chunk splits (the non-causal chunked path, two query and two key
    chunks) and at one it does not (the naive path);
  * `forward`'s logits within LOGITS_ATOL; `loss_fn` within a relative
    1e-6 and its grads within GRAD_RTOL 1e-5 of each leaf's largest
    |grad|, remat on and off;
  * `prefill`'s logits within LOGITS_ATOL and its cache's K/V within
    CACHE_ATOL 1e-5, its length exact; 8 decode steps' logits within
    LOGITS_ATOL;
  * decode continues prefill (the reference's tests/test_models.py case)
    within 1e-4;
  * a bfloat16 SMOKE tree crosses `convert.encdec_params` bit for bit,
    and a bf16-compute run has the right shapes and dtypes and no NaN.
"""
import pytest

torch = pytest.importorskip("torch")

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import encdec as jencdec
from repro.models import get_model as jget_model
from repro.models.common import ModelConfig as JModelConfig
from repro_torch import _tree, convert
from repro_torch.configs import get_config
from repro_torch.models import attention, encdec, get_model
from repro_torch.models.common import ModelConfig
from repro_torch.train.step import value_and_grad

ARCH = "seamless-m4t-medium"
LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5
GRAD_RTOL = 1e-5
B, S_SRC, S_TGT = 2, 128, 128      # SMOKE's attn_chunk is 64: two chunks


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


def _perturb(host, rng):
    """Every norm's gain moved off its initial 1s."""
    def go(tree):
        return {k: (go(v) if isinstance(v, dict) else
                    (v * (1 + 0.1 * rng.standard_normal(v.shape))).astype(
                        v.dtype) if k in ("ln1", "ln2", "lnx", "enc_norm",
                                          "final_norm") else v)
                for k, v in tree.items()}
    return go(host)


@functools.lru_cache(maxsize=None)
def _host():
    jcfg = jget_config(ARCH, smoke=True)
    host = jax.tree.map(np.asarray,
                        jget_model(jcfg).init(jax.random.PRNGKey(0)))
    return _perturb(host, np.random.default_rng(7))


def both(**kw):
    """(reference cfg, port cfg, reference params, port params) of the
    SMOKE config at f32 compute with `kw` applied."""
    jcfg = jget_config(ARCH, smoke=True).with_(compute_dtype="float32",
                                               **kw)
    tcfg = get_config(ARCH, smoke=True).with_(compute_dtype="float32", **kw)
    host = _host()
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, host),
            convert.encdec_params(host, device="cpu"))


def _inputs(s_src=S_SRC, s_tgt=S_TGT, seed=1, d=64, vocab=128):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, s_src, d)).astype(np.float32)
    toks = rng.integers(0, vocab, (B, s_tgt)).astype(np.int32)
    return frames, toks


@pytest.mark.parametrize("s_src,naive", [(128, False), (96, True)],
                         ids=["chunked", "naive"])
def test_encode_matches_reference(s_src, naive):
    """At chunk 64, 128 frames split into 2 x 2 chunks (non-causal); 96
    frames do not split, so the naive path runs."""
    jcfg, tcfg, jp, tp = both()
    frames, _ = _inputs(s_src=s_src)
    want = jax.jit(jencdec.encode, static_argnums=2)(jp, jnp.asarray(frames),
                                                     jcfg)
    with mock.patch.object(attention, "naive_attention",
                           wraps=attention.naive_attention) as spy:
        got = encdec.encode(tp, _t(frames), tcfg)
    assert spy.called == naive
    assert got.dtype == torch.float32 and tuple(got.shape) == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)


def _batch(s_src=S_SRC, s_tgt=S_TGT):
    frames, toks = _inputs(s_src, s_tgt)
    labels = toks.copy()
    labels[1, :5] = -1
    return {"frames": frames, "tokens": toks, "labels": labels}


@functools.lru_cache(maxsize=None)
def _reference_loss():
    jcfg, _, jp, _ = both()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    logits = jax.jit(jencdec.forward, static_argnums=3)(
        jp, batch["frames"], batch["tokens"], jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jencdec.loss_fn(p, b, jcfg)))(jp, batch)
    return np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_reference(remat):
    _, tcfg, _, tp = both(remat=remat)
    batch = {k: _t(v) for k, v in _batch().items()}
    jlogits, jloss, jgrads = _reference_loss()
    with torch.no_grad():
        np.testing.assert_allclose(
            encdec.forward(tp, batch["frames"], batch["tokens"],
                           tcfg).numpy(), jlogits, atol=LOGITS_ATOL, rtol=0)
    loss, grads = value_and_grad(lambda p, b: encdec.loss_fn(p, b, tcfg),
                                 tp, batch)
    assert abs(float(loss) - jloss) <= 1e-6 * abs(jloss)
    for (name, g), w in zip(_tree.named_leaves(grads),
                            jax.tree.leaves(jgrads), strict=True):
        assert not bool(torch.isnan(g).any()), name
        assert _rel(g.numpy(), w) <= GRAD_RTOL, name


def test_remat_does_not_change_the_grads():
    _, tcfg, _, tp = both()
    batch = {k: _t(v) for k, v in _batch(64, 32).items()}
    l1, g1 = value_and_grad(get_model(tcfg.with_(remat=True)).loss_fn, tp,
                            batch)
    l2, g2 = value_and_grad(get_model(tcfg.with_(remat=False)).loss_fn, tp,
                            batch)
    assert float(l1) == float(l2)
    for a, b in zip(_tree.leaves(g1), _tree.leaves(g2), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _assert_cache(cache, jc):
    for f in ("self_k", "self_v", "cross_k", "cross_v"):
        got, want = getattr(cache, f), np.asarray(getattr(jc, f))
        assert tuple(got.shape) == want.shape, f
        np.testing.assert_allclose(got.numpy(), want, atol=CACHE_ATOL,
                                   rtol=0, err_msg=f)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jc.length))


@pytest.mark.parametrize("lengths", [None, [7, 12]], ids=["full", "lengths"])
def test_prefill_cache_matches_reference(lengths):
    """A 12-token prompt over 96 frames into a cache of 20 positions; with
    `lengths` only the cache's `length` changes."""
    jcfg, tcfg, jp, tp = both()
    frames, toks = _inputs(96, 12)
    jlens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    jlg, jc = jax.jit(jencdec.prefill, static_argnums=(3, 4))(
        jp, jnp.asarray(frames), jnp.asarray(toks), jcfg, 20, jlens)
    with torch.no_grad():
        lg, cache = encdec.prefill(
            tp, _t(frames), _t(toks), tcfg, max_len=20,
            lengths=None if lengths is None else torch.tensor(
                lengths, dtype=torch.int32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                               atol=LOGITS_ATOL, rtol=0)
    _assert_cache(cache, jc)
    assert cache.length.dtype == torch.int32
    assert not bool(cache.self_k[:, :, 12:].any())


def test_prefill_and_decode_match_reference():
    """Through both registries: prefill 16 tokens over 128 frames, then 8
    decode steps, each step's logits and the whole cache at the end."""
    jcfg, tcfg, jp, tp = both()
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    frames, toks = _inputs(128, 24)
    jlg, jc = jax.jit(japi.prefill, static_argnums=2)(
        jp, {"frames": jnp.asarray(frames),
             "tokens": jnp.asarray(toks[:, :16])}, 24)
    jdecode = jax.jit(japi.decode_step)
    with torch.no_grad():
        lg, cache = tapi.prefill(tp, {"frames": _t(frames),
                                      "tokens": _t(toks[:, :16])},
                                 max_len=24)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=LOGITS_ATOL, rtol=0)
        for i in range(16, 24):
            jlg, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]))
            lg, cache = tapi.decode_step(tp, cache, _t(toks[:, i:i + 1]))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                       atol=LOGITS_ATOL, rtol=0)
    _assert_cache(cache, jc)


def test_decode_continues_prefill():
    """tests/test_models.py::test_encdec_decode_continues_prefill on the
    port, the reference's parameters carried across."""
    kw = dict(name="s", family="encdec", num_layers=3, encoder_layers=3,
              d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
              vocab_size=97, compute_dtype="float32", attn_chunk=8,
              remat=False)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    host = jax.tree.map(np.asarray, jencdec.init_params(
        jcfg, jax.random.PRNGKey(0)))
    tp = convert.encdec_params(host, device="cpu")
    frames, toks = _inputs(12, 20, seed=2, vocab=97)
    with torch.no_grad():
        full = encdec.forward(tp, _t(frames), _t(toks), tcfg)
        _, cache = encdec.prefill(tp, _t(frames), _t(toks[:, :12]), tcfg,
                                  max_len=20)
        outs = []
        for i in range(8):
            lg, cache = encdec.decode_step(tp, cache,
                                           _t(toks[:, 12 + i:13 + i]), tcfg)
            outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               full[:, 12:20].numpy(), atol=1e-4)


def test_decode_writes_in_place_and_raises_past_the_cache():
    _, tcfg, _, tp = both()
    frames, toks = _inputs(64, 10)
    with torch.no_grad():
        _, cache = encdec.prefill(tp, _t(frames), _t(toks[:, :8]), tcfg,
                                  max_len=9)
        cross = cache.cross_k.clone(), cache.cross_v.clone()
        before = cache.self_k.clone()
        _, after = encdec.decode_step(tp, cache, _t(toks[:, 8:9]), tcfg)
        assert after.self_k is cache.self_k and after.self_v is cache.self_v
        assert not torch.equal(before, cache.self_k)
        assert torch.equal(before[:, :, :8], cache.self_k[:, :, :8])
        assert torch.equal(cross[0], after.cross_k)
        assert torch.equal(cross[1], after.cross_v)
        assert int(after.length[0]) == 9 and int(cache.length[0]) == 8
        with pytest.raises(IndexError, match="decode past the cache"):
            encdec.decode_step(tp, after, _t(toks[:, 9:10]), tcfg)


@pytest.mark.parametrize("where,change", [
    ("dec_blocks", "drop"), ("dec_blocks", "add"), ("", "drop"),
    ("", "add")], ids=["dec_missing", "dec_extra", "top_missing",
                       "top_extra"])
def test_encdec_params_refuses_a_missing_or_extra_leaf(where, change):
    host = {k: dict(v) if isinstance(v, dict) else v
            for k, v in _host().items()}
    tree = host[where] if where else host
    if change == "drop":
        del tree["xwo" if where else "enc_norm"]
    else:
        tree["junk"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="missing" if change == "drop"
                       else "unexpected"):
        convert.encdec_params(host, device="cpu")


def test_bf16_tree_and_bf16_compute():
    """A bfloat16 SMOKE tree crosses bit for bit; at bf16 compute the
    encoder's output and the cross K/V are bf16, the shapes right, no
    NaN."""
    jcfg = jget_config(ARCH, smoke=True).with_(param_dtype="bfloat16")
    host = jax.tree.map(np.asarray,
                        jget_model(jcfg).init(jax.random.PRNGKey(1)))
    tp = convert.encdec_params(host, device="cpu")
    for (name, t), a in zip(_tree.named_leaves(tp), jax.tree.leaves(host),
                            strict=True):
        assert t.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    cfg = get_config(ARCH, smoke=True)
    api = get_model(cfg)
    frames, toks = _inputs(64, 16)
    batch = {"frames": _t(frames), "tokens": _t(toks), "labels": _t(toks)}
    with torch.no_grad():
        assert encdec.encode(tp, batch["frames"], cfg).dtype == torch.bfloat16
        lg, cache = api.prefill(tp, batch, max_len=20)
        lg2, cache = api.decode_step(tp, cache, _t(toks[:, -1:]))
    assert tuple(lg.shape) == (B, 16, cfg.vocab_size)
    assert tuple(lg2.shape) == (B, 1, cfg.vocab_size)
    assert cache.cross_k.dtype == cache.self_k.dtype == torch.bfloat16
    assert tuple(cache.cross_k.shape) == (cfg.num_layers, B, 64,
                                          cfg.num_kv_heads, cfg.hd)
    assert tuple(cache.self_k.shape) == (cfg.num_layers, B, 20,
                                         cfg.num_kv_heads, cfg.hd)
    assert not bool(torch.isnan(lg.float()).any())
    assert not bool(torch.isnan(lg2.float()).any())
    loss, grads = value_and_grad(api.loss_fn, tp, batch)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g.float()).all())
               for g in _tree.leaves(grads))


def test_init_params_has_the_reference_tree():
    """Keys, shapes and dtypes of a drawn tree equal the reference's, and
    the registry's cache takes `src_len` (else `max_len`)."""
    cfg = get_config(ARCH, smoke=True).with_(encoder_layers=3)
    api = get_model(cfg)
    tp = api.init(torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda: jencdec.init_params(
        jget_config(ARCH, smoke=True).with_(encoder_layers=3),
        jax.random.PRNGKey(0)))
    got = [(n, tuple(t.shape), str(t.dtype).split(".")[-1])
           for n, t in _tree.named_leaves(tp)]
    assert got == [(n, tuple(s.shape), str(s.dtype))
                   for n, s in _tree.named_leaves(want)]
    assert tuple(tp["enc_blocks"]["wq"].shape)[0] == 3
    c = api.init_cache(2, 10, device="cpu")
    assert tuple(c.cross_k.shape) == (2, 2, 10, 4, 16)
    c = api.init_cache(2, 10, src_len=6, device="cpu")
    assert tuple(c.cross_k.shape) == (2, 2, 6, 4, 16)
    assert tuple(c.self_k.shape) == (2, 2, 10, 4, 16)
