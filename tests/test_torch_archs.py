"""tests/test_archs_smoke.py over the port's architectures
(`repro_torch.configs.ARCH_IDS`, the reference's ten: the dense, vlm,
MoE, SSM, hybrid and enc-dec families), on the CPU.

Each SMOKE config's reference parameters (`repro.models.get_model(cfg)
.init`) cross by the family's converter (`TO_PORT`), and the
same numpy batch goes through both packages (a vlm's with patch
embeddings, an enc-dec's with frames). Held at f32 compute: the loss within a relative 1e-6, every
grad within GRAD_RTOL 1e-5 of its leaf's largest |grad|; prefill's and
one decode step's logits within LOGITS_ATOL 1e-4. At the configs' own
compute dtype (bf16) the reference's smoke checks: finite loss, a
nonzero finite grad norm, logits of the right shape with no NaN. Then
the FULL configs' dimensions (`test_full_configs_match_assignment`) and
both launchers with each new `--arch` (the serving launcher refuses the
enc-dec one with the reference's message).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro_torch import _tree, convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.train.step import value_and_grad

B, S = 2, 16
LOGITS_ATOL = 1e-4
GRAD_RTOL = 1e-5
NEW_IDS = [a for a in ARCH_IDS if a != "qwen2-0.5b"]
DECODER_IDS = [a for a in NEW_IDS if get_config(a).family != "encdec"]
TO_PORT = {"dense": convert.dense_params, "vlm": convert.dense_params,
           "moe": convert.moe_params, "ssm": convert.ssm_params,
           "hybrid": convert.hybrid_params, "encdec": convert.encdec_params}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def make_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


def both(arch, **kw):
    """(reference api, port api, reference params, port params) of the
    SMOKE config with `kw` applied to both."""
    jcfg = jget_config(arch, smoke=True).with_(**kw)
    tcfg = get_config(arch, smoke=True).with_(**kw)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    host = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0)))
    return japi, tapi, jax.tree.map(jnp.asarray, host), TO_PORT[
        tcfg.family](host, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_grad_match_reference(arch):
    japi, tapi, jp, tp = both(arch, compute_dtype="float32")
    batch = make_batch(tapi.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(tapi.loss_fn, tp,
                                 {k: _t(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    for (name, g), w in zip(_tree.named_leaves(grads),
                            jax.tree.leaves(jgrads), strict=True):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_RTOL * max(
            float(np.abs(w).max()), 1e-30), (arch, name)
    # the reference's own smoke check at the config's compute dtype
    _, tapi, _, tp = both(arch)
    loss, grads = value_and_grad(tapi.loss_fn, tp,
                                 {k: _t(v) for k, v in batch.items()})
    assert np.isfinite(float(loss)), arch
    gn = sum(float(g.float().abs().sum()) for g in _tree.leaves(grads))
    assert np.isfinite(gn) and gn > 0, arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode_match_reference(arch):
    japi, tapi, jp, tp = both(arch, compute_dtype="float32")
    cfg = tapi.cfg
    batch = make_batch(cfg)
    batch.pop("labels")
    prefix = cfg.num_prefix_embeds if cfg.family == "vlm" else 0
    max_len = S + 4 + prefix
    jlg, jcache = japi.prefill(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, max_len=max_len)
    lg, cache = tapi.prefill(tp, {k: _t(v) for k, v in batch.items()},
                             max_len=max_len)
    assert tuple(lg.shape) == (B, S + prefix, cfg.vocab_size)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                               atol=LOGITS_ATOL, rtol=0)
    tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    jlg2, _ = japi.decode_step(jp, jcache, jnp.asarray(tok.numpy()))
    lg2, _ = tapi.decode_step(tp, cache, tok)
    assert tuple(lg2.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(lg2.numpy(), np.asarray(jlg2),
                               atol=LOGITS_ATOL, rtol=0)
    # at the config's own compute dtype: shapes and no NaN
    _, tapi, _, tp = both(arch)
    lg, cache = tapi.prefill(tp, {k: _t(v) for k, v in batch.items()},
                             max_len=max_len)
    lg2, _ = tapi.decode_step(tp, cache, torch.argmax(
        lg[:, -1:], dim=-1).to(torch.int32))
    assert not bool(torch.isnan(lg.float()).any()), arch
    assert not bool(torch.isnan(lg2.float()).any()), arch


def test_full_configs_match_assignment():
    """The reference's test's rows, every id's."""
    assert ARCH_IDS == JARCH_IDS
    c = get_config("qwen2-0.5b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (24, 896, 14, 2, 4864, 151936)
    assert c.qkv_bias
    c = get_config("minitron-4b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (32, 3072, 24, 8, 9216, 256000)
    c = get_config("deepseek-coder-33b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (62, 7168, 56, 8, 19200, 32256)
    c = get_config("deepseek-67b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (95, 8192, 64, 8, 22016, 102400)
    c = get_config("mamba2-2.7b")
    assert (c.num_layers, c.d_model, c.vocab_size, c.ssm_state) == \
        (64, 2560, 50280, 128)
    assert (c.d_inner, c.ssm_heads, c.ssm_chunk, c.tie_embeddings) == (
        5120, 80, 256, True)
    c = get_config("llama4-maverick-400b-a17b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size, c.num_experts) == (48, 5120, 40, 8, 8192, 202048,
                                             128)
    assert (c.param_dtype, c.optimizer, c.moe_layer_period) == (
        "bfloat16", "adafactor", 2)
    assert c.pdtype == torch.bfloat16
    c = get_config("llama4-scout-17b-a16e")
    assert (c.num_experts, c.moe_top_k, c.moe_layer_period) == (16, 1, 1)
    c = get_config("zamba2-2.7b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size, c.ssm_state) == (54, 2560, 32, 32, 10240, 32000,
                                           64)
    assert (c.hd, c.hybrid_attn_period, c.ssm_heads) == (80, 6, 80)
    c = get_config("internvl2-26b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (48, 6144, 48, 8, 16384, 92553)
    assert (c.num_prefix_embeds, c.frontend_dim) == (1024, 6144)
    c = get_config("seamless-m4t-medium")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (12, 1024, 16, 16, 4096, 256206)
    assert (c.family, c.encoder_layers, c.frontend_dim, c.rope_theta) == (
        "encdec", 12, 1024, 1e4)
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(
            "seamless-m4t-medium", smoke)) == dataclasses.asdict(
                jget_config("seamless-m4t-medium", smoke))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", NEW_IDS)
def test_train_launcher_trains_each_new_arch(arch, tmp_path, capsys):
    """Two steps at SMOKE (the vlm batch carries its zero patches)."""
    assert launch_train.main(["--device", "cpu", "--smoke", "--arch", arch,
                              "--steps", "2", "--batch", "2", "--seq", "8",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert re.search(rf"^{re.escape(arch)}: 2 steps in [0-9.]+s; loss "
                     r"[0-9.]+ -> [0-9.]+; restarts 0$", out, re.M), out


@pytest.mark.parametrize("arch", DECODER_IDS)
def test_serve_launcher_serves_each_new_arch(arch, capsys):
    assert launch_serve.main(["--device", "cpu", "--arch", arch,
                              "--requests", "2", "--num-docs", "16",
                              "--max-new", "2"]) == 0
    assert "top-1 hit 2/2" in capsys.readouterr().out


def test_serve_launcher_refuses_the_encdec_arch():
    """As the reference's launcher: RAG serving drives decoder LMs."""
    with pytest.raises(SystemExit, match="seamless decodes from frames, "
                       "not augmented text"):
        launch_serve.main(["--device", "cpu", "--arch",
                           "seamless-m4t-medium"])
