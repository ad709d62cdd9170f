"""The port's MoE model (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`), on the CPU.

The reference's parameters (its own initializers; the norms' gains
perturbed in numpy so they matter) are carried across by
`convert.moe_params`, and the same numpy inputs go through both packages.
Tolerances, all absolute unless said:

  * routing (each token's expert, whether it is kept, its buffer slot):
    equal, except where the router's top-2 probabilities lie within
    TIE_ULPS ulp of each other, where the two packages may round the
    other way: such a token is exempted, with every later token of its
    chunk routed to either of its two experts (their slots move with
    it); the count is printed (`-s`);
  * `moe_ffn` at f32: the router weight within 1e-6, the output within
    FFN_ATOL 2e-5 (f32 products summed in another order) on the tokens
    not exempted; a dropped token's routed output is exactly 0 in both;
  * `aux_load_balance_loss` within 1e-6;
  * the model at f32 compute: logits of `forward`, `prefill` and
    `decode_step` within LOGITS_ATOL 1e-4; `loss_fn` within a relative
    1e-6; its grads within GRAD_RTOL 1e-5 of each leaf's largest |grad|,
    with remat on and off (and on against off bit for bit);
  * the reference's own `test_moe_decode_equals_forward_when_no_drop`
    (bf16 compute, 1e-2) on the port;
  * `convert.moe_params`: a bfloat16 tree crosses bit for bit.

The shard-aligned dispatch (ROADMAP C25) is held against the reference
with its `_dp_shards` patched to 2 (a test-side patch): the port's ranks
each run their rows under `batch_block`, in the case where each rank's
rows are half of one microbatch and where each rank holds a whole
microbatch.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.common import ModelConfig as JModelConfig
from repro_torch import _tree, convert
from repro_torch.configs import get_config
from repro_torch.models import common, get_model, moe
from repro_torch.models.common import ModelConfig
from repro_torch.train.step import value_and_grad

FFN_ATOL = 2e-5
LOGITS_ATOL = 1e-4
GRAD_RTOL = 1e-5
TIE_ULPS = 2

SMALL = dict(name="mo", family="moe", num_layers=4, d_model=64, num_heads=4,
             num_kv_heads=2, d_ff=96, vocab_size=101, num_experts=8,
             shared_expert=True, capacity_factor=1.0, attn_chunk=8,
             compute_dtype="float32")
FFN = dict(name="x", family="moe", num_layers=1, d_model=32, num_heads=2,
           num_kv_heads=1, d_ff=48, vocab_size=11, num_experts=4,
           compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_moe(seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params)."""
    fields = {**SMALL, **kw}
    jcfg, tcfg = JModelConfig(**fields), ModelConfig(**fields)
    p = _np_tree(jmoe.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("ln1", "ln2"):
        p["blocks"][name] = (p["blocks"][name] + rng.normal(
            scale=0.1, size=p["blocks"][name].shape)).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, p),
            convert.moe_params(p, device="cpu"))


def ffn_case(seed=2, shape=(4, 8), **kw):
    """(reference cfg, port cfg, reference FFN params, port's, x)."""
    fields = {**FFN, **kw}
    jcfg, tcfg = JModelConfig(**fields), ModelConfig(**fields)
    p = _np_tree(jmoe.init_moe_ffn(jcfg, jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).normal(
        size=(*shape, fields["d_model"])).astype(np.float32)
    return jcfg, tcfg, p, {k: _t(v) for k, v in p.items()}, x


def ref_route(p, x, cfg, ns=1):
    """The reference's routing (moe.py:85-111) in numpy from its own
    router probabilities: (probs, eidx, keep, slot)."""
    nt = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x.reshape(nt, -1), jnp.float32)
    probs = np.asarray(jax.nn.softmax(jnp.einsum(
        "td,de->te", xt, jnp.asarray(p["router"], jnp.float32)), axis=-1))
    eidx = np.asarray(jnp.argmax(jnp.asarray(probs), axis=-1))
    if not (ns > 1 and nt % ns == 0):
        ns = 1
    chunk = nt // ns
    cap_l = jmoe._capacity(chunk, cfg)
    pos = np.zeros(nt, np.int64)
    for c in range(ns):
        seen = {}
        for t in range(c * chunk, (c + 1) * chunk):
            pos[t] = seen.get(eidx[t], 0)
            seen[eidx[t]] = pos[t] + 1
    keep = pos < cap_l
    slot = np.where(keep, np.arange(nt) // chunk * cap_l + pos, ns * cap_l)
    return probs, eidx, keep, slot


def exempt_near_ties(probs, got_e, want_e, chunk):
    """Tokens exempted from the routing check: those whose top-2 router
    probabilities lie within TIE_ULPS ulp, and every later token of their
    chunk routed to either of their two experts."""
    top2 = np.sort(probs, axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= TIE_ULPS * np.spacing(top2[:, 1])
    out = np.zeros(len(probs), bool)
    for t in np.flatnonzero(tie):
        experts = {int(got_e[t]), int(want_e[t]),
                   *np.argsort(probs[t])[-2:].tolist()}
        end = (t // chunk + 1) * chunk
        later = np.arange(t, end)
        out[later[np.isin(got_e[later], list(experts))
                  | np.isin(want_e[later], list(experts))]] = True
    return out


class FakeMesh:
    """The two attributes the MoE dispatch reads."""

    def __init__(self, data, model=1):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


# -- moe_ffn -----------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cf", [1.0, 16.0])
def test_moe_ffn_matches_reference(cf, shared, capsys):
    jcfg, tcfg, p, tp, x = ffn_case(capacity_factor=cf, shared_expert=shared)
    nt = x.shape[0] * x.shape[1]
    probs, want_e, want_keep, want_slot = ref_route(p, x, jcfg)
    eidx, gate, keep, slot, cap = moe.route(tp, _t(x).reshape(nt, -1), tcfg,
                                            nt)
    eidx, keep, slot = eidx.numpy(), keep.numpy(), slot.numpy()
    skip = exempt_near_ties(probs, eidx, want_e, nt)
    with capsys.disabled():
        print(f"\nmoe_ffn cf {cf} shared {shared}: {int(skip.sum())} of "
              f"{nt} tokens exempted as router near-ties")
    ok = ~skip
    np.testing.assert_array_equal(eidx[ok], want_e[ok])
    np.testing.assert_array_equal(keep[ok], want_keep[ok])
    np.testing.assert_array_equal(slot[ok], want_slot[ok])
    assert cap == jmoe._capacity(nt, jcfg)
    np.testing.assert_allclose(gate.numpy(), probs.max(-1), atol=1e-6,
                               rtol=0)
    if cf == 1.0:
        assert not keep.all()           # capacity 1.0 drops tokens here
    else:
        assert keep.all()
    got = moe.moe_ffn(tp, _t(x), tcfg).numpy().reshape(nt, -1)
    want = np.asarray(jax.jit(jmoe.moe_ffn, static_argnums=2)(
        p, jnp.asarray(x), jcfg)).reshape(nt, -1)
    np.testing.assert_allclose(got[ok], want[ok], atol=FFN_ATOL, rtol=0)
    if not shared:
        dropped = ~keep & ok
        assert (got[dropped] == 0).all() and (want[dropped] == 0).all()


def test_moe_ffn_bf16_is_held_to_the_reference():
    """At bf16 compute and bf16 banks (maverick's dtypes, so no cast): the
    output within 5e-2 (bf16 keeps 8 mantissa bits)."""
    jcfg, tcfg, p, _, x = ffn_case(shared_expert=True, capacity_factor=1.25,
                                   compute_dtype="bfloat16")
    p = _np_tree(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p))
    tp = {k: torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
          for k, v in p.items()}
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jmoe.moe_ffn(p, xb, jcfg), np.float32)
    got = moe.moe_ffn(tp, _t(np.asarray(xb, np.float32)).to(torch.bfloat16),
                      tcfg).float().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)


def test_dispatch_conserves_tokens_and_is_permutation_invariant():
    """tests/test_models.py's test_moe_dispatch_conserves_tokens on the
    port: with capacity 8x nothing is dropped."""
    _, tcfg, _, _, x = ffn_case(seed=3, shape=(2, 8), capacity_factor=8.0)
    tp = moe.init_moe_ffn(tcfg, torch.Generator().manual_seed(3),
                          device="cpu")
    y = moe.moe_ffn(tp, _t(x), tcfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    y2 = moe.moe_ffn(tp, _t(x[::-1]), tcfg)
    np.testing.assert_allclose(y2.numpy(), y.numpy()[::-1], atol=1e-5)


def test_aux_load_balance_loss_matches_reference():
    jcfg, tcfg, p, tp, x = ffn_case(capacity_factor=1.25)
    want = float(jmoe.aux_load_balance_loss(p, jnp.asarray(x), jcfg))
    got = float(moe.aux_load_balance_loss(tp, _t(x), tcfg))
    assert abs(got - want) <= 1e-6


# -- the shard-aligned dispatch ----------------------------------------------

def _ref_sharded(p, x, cfg, monkeypatch):
    monkeypatch.setattr(jmoe, "_dp_shards", lambda: 2)
    out = np.asarray(jmoe.moe_ffn(p, jnp.asarray(x), cfg))
    monkeypatch.undo()
    return out


def test_shard_aligned_dispatch_matches_reference(monkeypatch, capsys):
    """A (4, 8) microbatch on 2 batch shards: chunks of 16 tokens, each
    with its own capacity. Split: each rank runs its 2 rows of the
    microbatch. Aligned: each rank holds a whole (2, 8) microbatch (its 2
    chunks of 8 tokens)."""
    jcfg, tcfg, p, tp, x = ffn_case(shape=(4, 8), capacity_factor=1.0)
    want = _ref_sharded(p, x, jcfg, monkeypatch)
    unsharded = np.asarray(jmoe.moe_ffn(p, jnp.asarray(x), jcfg))
    assert np.abs(want - unsharded).max() > 1e-3   # the rule matters here
    probs, want_e, _, _ = ref_route(p, x, jcfg, ns=2)
    skip = exempt_near_ties(probs, want_e, want_e, 16)
    with capsys.disabled():
        print(f"\nshard-aligned dispatch: {int(skip.sum())} of 32 tokens "
              "exempted as router near-ties")
    ok = ~skip.reshape(4, 8)
    with common.set_mesh(FakeMesh(2, 2)):
        halves = []
        for start in (0, 2):
            with common.batch_block(4, start):
                halves.append(moe.moe_ffn(tp, _t(x[start:start + 2]),
                                          tcfg).numpy())
    np.testing.assert_allclose(np.concatenate(halves)[ok], want[ok],
                               atol=FFN_ATOL, rtol=0)
    # aligned: the (2, 8) microbatch 1 whole on one rank
    want_mb = _ref_sharded(p, x[2:], jcfg, monkeypatch)
    with common.set_mesh(FakeMesh(2, 2)), common.batch_block(2, 0):
        got_mb = moe.moe_ffn(tp, _t(x[2:]), tcfg).numpy()
    np.testing.assert_allclose(got_mb, want_mb, atol=FFN_ATOL, rtol=0)
    assert np.abs(want_mb - np.asarray(
        jmoe.moe_ffn(p, jnp.asarray(x[2:]), jcfg))).max() > 1e-3


def test_dispatch_chunks_and_their_refusals(monkeypatch):
    """Without a mesh, or where the tokens do not split into the shards,
    one global capacity (the reference's rule); a block that is not whole
    chunks raises."""
    jcfg, tcfg, p, tp, x = ffn_case(shape=(1, 7), capacity_factor=1.0)
    with common.set_mesh(FakeMesh(2)):
        assert moe.dispatch_chunk(7, 7) == 7
        got = moe.moe_ffn(tp, _t(x), tcfg).numpy()
        assert moe.dispatch_chunk(32, 8) == 16
        with common.batch_block(4, 2):
            assert moe.dispatch_chunk(16, 8) == 16
        with common.batch_block(4, 1), pytest.raises(ValueError,
                                                     match="whole chunks"):
            moe.dispatch_chunk(16, 8)
        with common.batch_block(3, 1), pytest.raises(ValueError,
                                                     match="run whole"):
            moe.dispatch_chunk(7, 7)
    assert moe.dispatch_chunk(32, 8) == 32
    np.testing.assert_allclose(got, _ref_sharded(p, x, jcfg, monkeypatch),
                               atol=FFN_ATOL, rtol=0)


# -- the model ---------------------------------------------------------------

def _near_ties(monkeypatch):
    """Record the port's router near-ties over a run (expected 0: with
    none, routing cannot differ from the reference's by rounding)."""
    seen = []
    route = moe.route

    def recording(p, xt, cfg, chunk):
        out = route(p, xt, cfg, chunk)
        probs = torch.softmax(xt.float() @ p["router"].float(), -1)
        top2 = torch.topk(probs, 2, dim=-1).values.detach().numpy()
        seen.append(int(((top2[:, 0] - top2[:, 1])
                         <= TIE_ULPS * np.spacing(top2[:, 0])).sum()))
        return out
    monkeypatch.setattr(moe, "route", recording)
    return seen


@pytest.mark.parametrize("period", [1, 2])
def test_forward_loss_and_grads_match_reference(period, monkeypatch, capsys):
    jcfg, tcfg, jp, tp = ref_moe(moe_layer_period=period)
    toks = np.random.default_rng(1).integers(0, 101, (2, 16)).astype(np.int32)
    labels = toks.copy()
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    ties = _near_ties(monkeypatch)
    got = moe.forward(tp, _t(toks), tcfg).numpy()
    want = np.asarray(jax.jit(jmoe.forward, static_argnums=2)(
        jp, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmoe.loss_fn),
                            static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    jgrads = convert.moe_params(_np_tree(jgrads), device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    runs = {}
    for remat in (True, False):
        cfg = tcfg.with_(remat=remat)
        runs[remat] = value_and_grad(lambda p, b: moe.loss_fn(p, b, cfg),
                                     tp, tb)
    with capsys.disabled():
        print(f"\nmoe period {period}: {sum(ties)} router near-ties over "
              f"{len(ties)} MoE calls")
    assert sum(ties) == 0
    for remat, (loss, grads) in runs.items():
        assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
        for (name, g), (_, w) in zip(_tree.named_leaves(grads),
                                     _tree.named_leaves(jgrads), strict=True):
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= GRAD_RTOL * scale, name
    assert all(torch.equal(a, b) for a, b in zip(
        _tree.leaves(runs[True][1]), _tree.leaves(runs[False][1])))


@pytest.mark.parametrize("period", [1, 2])
def test_prefill_and_decode_match_reference(period):
    """Prefill 10 tokens, then 4 decode steps, on both packages; the
    caches' K and V too (layers superblock-major)."""
    jcfg, tcfg, jp, tp = ref_moe(moe_layer_period=period,
                                 capacity_factor=1.25)
    toks = np.random.default_rng(4).integers(0, 101, (2, 14)).astype(np.int32)
    jlg, jcache = jmoe.prefill(jp, jnp.asarray(toks[:, :10]), jcfg,
                               max_len=16)
    lg, cache = moe.prefill(tp, _t(toks[:, :10]), tcfg, max_len=16)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                               atol=LOGITS_ATOL, rtol=0)
    jstep = jax.jit(jmoe.decode_step, static_argnums=3)
    for i in range(10, 14):
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i:i + 1]), jcfg)
        lg, cache = moe.decode_step(tp, cache, _t(toks[:, i:i + 1]), tcfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("period", [1, 2])
def test_moe_decode_equals_forward_when_no_drop(period):
    """tests/test_models.py's case on the port: its config (bf16 compute,
    capacity 16x), its tolerance."""
    cfg = ModelConfig(name="mo", family="moe", num_layers=4, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=101,
                      num_experts=8, moe_layer_period=period,
                      shared_expert=True, capacity_factor=16.0,
                      attn_chunk=8, remat=True)
    params = moe.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 101, (2, 16)).astype(np.int32))
    full = moe.forward(params, toks[:, :14], cfg)
    _, cache = moe.prefill(params, toks[:, :10], cfg, max_len=20)
    outs = []
    for i in range(4):
        lg, cache = moe.decode_step(params, cache, toks[:, 10 + i:11 + i],
                                    cfg)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).float().numpy(),
                               full[:, 10:14].float().numpy(), atol=1e-2)


def test_params_have_the_reference_keys_and_shapes():
    for arch in ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"):
        jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, True)
        want = jax.eval_shape(lambda k, c=jcfg: jmoe.init_params(c, k),
                              jax.random.PRNGKey(0))
        got = get_model(tcfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
        if tcfg.moe_layer_period == 1:
            assert got["dense_ffn"] == {}
        wflat = jax.tree_util.tree_flatten_with_path(want)[0]
        gflat = _tree.named_leaves(got)
        assert [n for n, _ in gflat] == [
            "__".join(str(getattr(e, "key", e)) for e in path)
            for path, _ in wflat]
        for (name, g), (_, w) in zip(gflat, wflat, strict=True):
            assert tuple(g.shape) == w.shape, name
            assert g.dtype == tcfg.pdtype, name


def test_moe_params_keeps_bfloat16_bit_for_bit():
    """maverick's SMOKE widths with its FULL param dtype (bfloat16) and
    scout's SMOKE (period 1, an empty dense_ffn)."""
    cfg = jget_config("llama4-maverick-400b-a17b", smoke=True).with_(
        param_dtype="bfloat16")
    host = _np_tree(jmoe.init_params(cfg, jax.random.PRNGKey(0)))
    got = convert.moe_params(host, device="cpu")
    n = 0
    for (name, t), want in zip(_tree.named_leaves(got),
                               jax.tree.leaves(host), strict=True):
        assert t.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(
            np.uint16), want.view(np.uint16))
        n += 1
    assert n == len(jax.tree.leaves(host))
    scout = _np_tree(jmoe.init_params(
        jget_config("llama4-scout-17b-a16e", smoke=True),
        jax.random.PRNGKey(0)))
    got = convert.moe_params(scout, device="cpu")
    assert got["dense_ffn"] == {} and "sh_gate" in got["moe"]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        convert.moe_params({**scout, "embed": scout["embed"].astype(
            np.float16)}, device="cpu")
