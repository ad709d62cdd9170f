"""The port's training half (`repro_torch.train`, the models' losses and
remat) against the reference's, on the CPU.

Both packages get the same numpy inputs; model parameters are carried
across with `repro_torch.convert.dense_params` / `embedder_params`, and
the model comparisons run at f32 compute. Tolerances, stated per test:
losses within a relative 1e-5 and grads within 1e-5 absolute (the two
packages' f32 sums run in different orders); the optimizers, fed the
same grads, within 1e-6 absolute on the parameters. The first six cases
are tests/test_train.py's, on the port alone.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.data import LMTaskConfig as JLMTaskConfig
from repro.data import lm_batches as jlm_batches
from repro.models import embedder as jembedder
from repro.models import get_model as jget_model
from repro.models.common import cross_entropy_loss as jcross_entropy_loss
from repro.train import adafactor as jadafactor
from repro.train import adamw as jadamw
from repro.train import make_train_step as jmake_train_step
from repro.train.optim import Optimizer as JOptimizer
from repro_torch import _tree, convert
from repro_torch.configs import get_config
from repro_torch.data import LMTaskConfig, lm_batches
from repro_torch.models import dense, embedder, get_model
from repro_torch.models.common import cross_entropy_loss
from repro_torch.train import adafactor, adamw, make_train_step
from repro_torch.train.optim import Optimizer
from repro_torch.train.step import value_and_grad

CPU = "cpu"
LOSS_RTOL, GRAD_ATOL, OPT_ATOL = 1e-5, 1e-5, 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _leaves_close(got, want, atol, rtol=0.0):
    """Every leaf of the port's tree against the reference's, leaf order
    and names included."""
    gn = _tree.named_leaves(got)
    wn = [("__".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path), leaf)
          for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [n for n, _ in gn] == [n for n, _ in wn]
    for (name, g), (_, w) in zip(gn, wn):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=atol, rtol=rtol, err_msg=name)


def f32_models():
    """(reference api, reference params, port api, port params): the
    qwen2-0.5b smoke model at f32 compute."""
    jcfg = jget_config("qwen2-0.5b", smoke=True).with_(
        compute_dtype="float32")
    japi = jget_model(jcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    api = get_model(get_config("qwen2-0.5b", smoke=True).with_(
        compute_dtype="float32"))
    return japi, jp, api, convert.dense_params(_np(jp), device=CPU)


def _tokens(seed, shape, vocab=128):
    toks = np.random.default_rng(seed).integers(0, vocab, shape)
    return toks.astype(np.int32)


# --- tests/test_train.py, on the port ---------------------------------------

def test_adamw_matches_numpy_reference():
    opt = adamw(lr=0.1, b1=0.9, b2=0.99, eps=1e-8)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.5, 0.5, -1.0])}
    state = opt.init(p)
    p1, state = opt.update(g, state, p)
    m = 0.1 * g["w"].numpy()
    v = 0.01 * g["w"].numpy() ** 2
    u = (m / 0.1) / (np.sqrt(v / 0.01) + 1e-8)
    want = p["w"].numpy() - 0.1 * u
    np.testing.assert_allclose(p1["w"].numpy(), want, atol=1e-6)
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32


def test_adamw_weight_decay():
    opt = adamw(lr=0.1, weight_decay=0.1)
    p = {"w": torch.tensor([1.0])}
    p1, _ = opt.update({"w": torch.tensor([0.0])}, opt.init(p), p)
    assert float(p1["w"][0]) < 1.0        # decays toward zero


def test_adafactor_reduces_loss_on_quadratic():
    opt = adafactor(lr=0.05)
    w = {"w": torch.ones((8, 8))}
    state = opt.init(w)

    def loss(p, _):
        return torch.mean(p["w"] ** 2)
    l0 = float(loss(w, None))
    for _ in range(50):
        _, g = value_and_grad(loss, w, None)
        w, state = opt.update(g, state, w)
    assert float(loss(w, None)) < 0.3 * l0


def test_adafactor_state_is_factored():
    s = adafactor().init({"w": torch.zeros((16, 32)),
                          "b": torch.zeros((32,))})
    assert s["v"]["w"]["vr"].shape == (16,)
    assert s["v"]["w"]["vc"].shape == (32,)
    assert s["v"]["b"]["v"].shape == (32,)


def test_grad_accum_equivalence():
    cfg = get_config("qwen2-0.5b", smoke=True)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device=CPU)
    opt = adamw(lr=1e-3)
    toks = torch.from_numpy(_tokens(1, (4, 16), cfg.vocab_size))
    batch = {"tokens": toks, "labels": toks}
    s1 = make_train_step(api.loss_fn, opt, grad_accum=1, clip_norm=None)
    s2 = make_train_step(api.loss_fn, opt, grad_accum=2, clip_norm=None)
    p1, _, m1 = s1(params, opt.init(params), batch)
    p2, _, m2 = s2(params, opt.init(params), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for a, b in zip(_tree.leaves(p1), _tree.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-3)


def test_loss_decreases_on_learnable_stream():
    cfg = get_config("qwen2-0.5b", smoke=True).with_(vocab_size=64)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device=CPU)
    opt = adamw(lr=3e-3)
    state = opt.init(params)
    step = make_train_step(api.loss_fn, opt)
    gen = lm_batches(LMTaskConfig(vocab_size=64, seq_len=32, batch_size=8))
    losses = []
    for _ in range(30):
        b = {k: torch.from_numpy(v) for k, v in next(gen).items()}
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


# --- against the reference ---------------------------------------------------

def test_training_knobs_match_the_reference_config():
    for smoke in (False, True):
        want, got = jget_config("qwen2-0.5b", smoke), get_config(
            "qwen2-0.5b", smoke)
        for knob in ("remat", "scan_layers", "seq_shard", "optimizer"):
            assert getattr(got, knob) == getattr(want, knob), knob
    assert embedder.MINILM_CFG.remat is jembedder.MINILM_CFG.remat is False


def test_loss_and_grads_match_reference():
    japi, jp, api, p = f32_models()
    toks = _tokens(2, (3, 24))
    labels = _tokens(3, (3, 24))
    labels[0, :5] = -1
    jl, jg = jax.jit(jax.value_and_grad(japi.loss_fn))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, grads = value_and_grad(api.loss_fn, p,
                                 {"tokens": _t(toks), "labels": _t(labels)})
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _leaves_close(grads, jg, atol=GRAD_ATOL)


def test_remat_on_and_off_give_equal_loss_and_grads(monkeypatch):
    _, _, api, p = f32_models()
    calls = []
    real = dense.checkpoint
    monkeypatch.setattr(dense, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    toks = _t(_tokens(4, (2, 16)))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for remat in (True, False):
        cfg = api.cfg.with_(remat=remat)
        calls.clear()
        out[remat] = value_and_grad(
            lambda q, b: dense.loss_fn(q, b, cfg), p, batch)
        assert len(calls) == (cfg.num_layers if remat else 0)
    with torch.no_grad():                 # remat only while autograd records
        calls.clear()
        dense.loss_fn(p, batch, api.cfg.with_(remat=True))
        assert not calls
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(_tree.leaves(out[True][1]), _tree.leaves(out[False][1])):
        assert torch.equal(a, b)


def _opt_tree(rng):
    return {"blocks": {"w": rng.normal(size=(2, 6, 5)).astype(np.float32),
                       "b": rng.normal(size=(2, 5)).astype(np.float32)},
            "embed": rng.normal(size=(7, 6)).astype(np.float32),
            "norm": rng.normal(size=(6,)).astype(np.float32)}


@pytest.mark.parametrize("name,steps", [("adamw", 1), ("adamw", 10),
                                        ("adafactor", 1),
                                        ("adafactor", 10)])
def test_optimizer_steps_match_reference(name, steps):
    rng = np.random.default_rng(5)
    p0 = _opt_tree(rng)
    make = {"adamw": (lambda: jadamw(lr=1e-2, weight_decay=0.1),
                      lambda: adamw(lr=1e-2, weight_decay=0.1)),
            "adafactor": (lambda: jadafactor(lr=1e-2),
                          lambda: adafactor(lr=1e-2))}[name]
    jopt, opt = make[0](), make[1]()
    jp, p = jax.tree.map(jnp.asarray, p0), _tree.tree_map(_t, p0)
    js, s = jopt.init(jp), opt.init(p)
    for _ in range(steps):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.1).astype(
            np.float32), p0)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        p, s = opt.update(_tree.tree_map(_t, g), s, p)
    _leaves_close(p, jp, atol=OPT_ATOL)
    _leaves_close(s, js, atol=OPT_ATOL, rtol=1e-5)
    assert int(s["step"]) == int(js["step"]) == steps


def _sgd(lr, tm):
    """Plain SGD in either package's tree map: the step's own machinery,
    without Adam's normalization magnifying last-bit differences."""
    def update(grads, state, params):
        return tm(lambda p, g: p - lr * g, params, grads), state
    return lambda: None, update


@pytest.mark.parametrize("kw", [dict(clip_norm=0.05), dict(grad_accum=2),
                                dict(grad_accum=3, clip_norm=None),
                                dict(transform=True)],
                         ids=["clip", "accum2", "accum3", "transform"])
def test_make_train_step_matches_reference(kw):
    japi, jp, api, p = f32_models()
    transform = kw.pop("transform", False)
    toks = _tokens(6, (6, 16))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    seen = {}

    def jhalf(g):
        return jax.tree.map(lambda x: 0.5 * x, g)

    def half(g):
        seen["grads"] = g
        return _tree.tree_map(lambda x: 0.5 * x, g)
    jinit, jupd = _sgd(0.1, jax.tree.map)
    init, upd = _sgd(0.1, _tree.tree_map)
    jstep = jax.jit(jmake_train_step(japi.loss_fn, JOptimizer(jinit, jupd),
                                     grad_transform=jhalf if transform
                                     else None, **kw))
    step = make_train_step(api.loss_fn, Optimizer(init, upd),
                           grad_transform=half if transform else None, **kw)
    jp1, _, jm = jstep(jp, None, jax.tree.map(jnp.asarray, batch))
    p1, _, m = step(p, None, {k: _t(v) for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=LOSS_RTOL, abs=1e-12)
    _leaves_close(p1, jp1, atol=OPT_ATOL)
    if transform:
        _, jg = jax.jit(jax.value_and_grad(japi.loss_fn))(
            jp, jax.tree.map(jnp.asarray, batch))
        _leaves_close(seen["grads"], jg, atol=GRAD_ATOL)


def test_info_nce_loss_matches_reference():
    widths = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
                  d_ff=64, vocab_size=128, pooled_dim=32)
    jcfg = jembedder.MINILM_CFG.with_(**widths)
    cfg = embedder.MINILM_CFG.with_(**widths)
    jp = jembedder.init_params(jcfg, jax.random.PRNGKey(7))
    p = convert.embedder_params(_np(jp), device=CPU)
    rng = np.random.default_rng(8)
    batch = {"query_tokens": _tokens(9, (5, 8)),
             "doc_tokens": _tokens(10, (5, 12)),
             "doc_mask": rng.random((5, 12)) < 0.8}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q, b: jembedder.info_nce_loss(q, b, jcfg)))(
            jp, jax.tree.map(jnp.asarray, batch))
    loss, grads = value_and_grad(
        lambda q, b: embedder.info_nce_loss(q, b, cfg), p,
        {k: _t(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    # 1/temperature = 20 scales these grads to |g| ~ 8, so f32 sums in
    # another order part by ~4e-5: held at 1e-4 absolute (5e-6 relative)
    _leaves_close(grads, jg, atol=1e-4)


def test_cross_entropy_loss_with_padding_labels():
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:] = -1
    labels[2, 0] = -5
    want = float(jcross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy_loss(_t(logits), _t(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    every = np.full_like(labels, -1)        # all padding: 0, not 0 / 0
    assert float(cross_entropy_loss(_t(logits), _t(every))) == 0.0 == float(
        jcross_entropy_loss(jnp.asarray(logits), jnp.asarray(every)))


def test_vlm_prefix_embeds_are_labelled_padding():
    japi, jp, api, p = f32_models()
    toks = _tokens(12, (2, 10))
    prefix = np.random.default_rng(13).normal(
        size=(2, 3, api.cfg.d_model)).astype(np.float32)
    jl = jax.jit(japi.loss_fn)(jp, {"tokens": jnp.asarray(toks),
                           "labels": jnp.asarray(toks),
                           "prefix_embeds": jnp.asarray(prefix)})
    batch = {"tokens": _t(toks), "labels": _t(toks),
             "prefix_embeds": _t(prefix)}
    loss = api.loss_fn(p, batch)
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    # the same loss by hand: the prefix positions' labels are -1
    logits = dense.forward(p, batch["tokens"], api.cfg, batch["prefix_embeds"])
    labels = torch.cat([torch.full((2, 3), -1, dtype=torch.int32),
                        batch["labels"]], 1)
    assert torch.equal(loss, cross_entropy_loss(logits, labels))


def test_optimizer_state_carried_across():
    japi, jp, _, _ = f32_models()
    for jopt in (jadamw(lr=1e-3), jadafactor(lr=1e-3)):
        js = jopt.init(jp)
        jg = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), jp)
        _, js = jax.jit(jopt.update)(jg, js, jp)
        s = convert.optimizer_state(_np(js), device=CPU)
        _leaves_close(s, js, atol=0.0)
        assert s["step"].dtype == torch.int32 and int(s["step"]) == 1
    with pytest.raises(ValueError, match="AdamW"):
        convert.optimizer_state({"step": np.int32(0)}, device=CPU)


def test_lm_batches_stream_trains_in_both_packages():
    """The reference's LM stream, fed to both packages' AdamW train steps
    for 3 steps: losses within LOSS_RTOL-scaled drift (Adam's normalized
    update turns last-bit grad differences into lr-sized moves, so the
    bound widens to 1e-4 after the first step)."""
    japi, jp, api, p = f32_models()
    jopt, opt = jadamw(lr=2e-3), adamw(lr=2e-3)
    jstep = jax.jit(jmake_train_step(japi.loss_fn, jopt))
    step = make_train_step(api.loss_fn, opt)
    js, s = jopt.init(jp), opt.init(p)
    jgen = jlm_batches(JLMTaskConfig(vocab_size=128, seq_len=16,
                                     batch_size=4))
    gen = lm_batches(LMTaskConfig(vocab_size=128, seq_len=16, batch_size=4))
    for i in range(3):
        jb, b = next(jgen), next(gen)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, jb))
        p, s, m = step(p, s, {k: _t(v) for k, v in b.items()})
        assert float(m["loss"]) == pytest.approx(
            float(jm["loss"]), rel=LOSS_RTOL if i == 0 else 1e-4)
