"""The port's step analysis (`repro_torch.launch.hlo_analysis`) against the
reference's HLO analysis (`repro.launch.hlo_analysis.analyze` of the
compiled step), on the reference's toys and on the train, prefill and
decode steps of the first five smoke configs on one device (the other
five in `test_torch_hlo_analysis_archs.py`).

The port counts the aten ops a step dispatches; the reference parses the
compiled HLO. Dot FLOPs agree exactly, with one difference by design,
asserted as a formula: the reference writes the SSD scan's three
multi-operand einsums (`models/mamba2.py:111-131`), so its backward
contracts their decay operands as dots, 2·B·L·H·(2P + Q) FLOPs per mamba2
layer of a train step (B rows, L tokens, H heads, P head dim, Q chunk);
the port multiplies the decays elementwise and reduces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.launch.hlo_analysis import analyze as janalyze
from repro.models import get_model as jget_model
from repro.train import get_optimizer as jget_optimizer
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import shapes as shp

B, S = 2, 32


def _jcompiled(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax.jit(f).lower(*args).compile()


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _flops(fn, *args):
    return hlo_analysis.analyze(fn, *args)[1]["dot_flops"]


# -- the reference's toys ----------------------------------------------------

def test_loop_flops_per_trip():
    def f(x, w):
        for _ in range(10):
            x = x @ w
        return x

    def jf(x, w):
        def body(c, _):
            return c @ w, None
        return jax.lax.scan(body, x, None, length=10)[0]
    got = _flops(f, _meta(128, 128), _meta(128, 128))
    assert got == 10 * 2 * 128 ** 3
    assert got == janalyze(_jcompiled(jf, (128, 128),
                                      (128, 128)).as_text())["dot_flops"]


def test_nested_loop_flops():
    def g(x, w):
        for _ in range(4):
            for _ in range(3):
                x = x @ w
        return x

    def jg(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=4)[0]
    got = _flops(g, _meta(64, 64), _meta(64, 64))
    assert got == 12 * 2 * 64 ** 3
    assert got == janalyze(_jcompiled(jg, (64, 64),
                                      (64, 64)).as_text())["dot_flops"]


def test_plain_dot_flops():
    got = _flops(lambda a, b: a @ b, _meta(32, 64), _meta(64, 16))
    assert got == 2 * 32 * 64 * 16
    assert got == janalyze(_jcompiled(lambda a, b: a @ b, (32, 64),
                                      (64, 16)).as_text())["dot_flops"]


def test_flops_by_dtype_and_matmul_forms():
    a16 = torch.empty((4, 8, 16), dtype=torch.bfloat16, device="meta")
    b16 = torch.empty((4, 16, 32), dtype=torch.bfloat16, device="meta")
    v = _meta(16)
    _, rec = hlo_analysis.analyze(
        lambda a, b, m, v: (a @ b, torch.einsum("bij,bjk->bik", a, b),
                            m @ v, v @ v, torch.nn.functional.linear(m, m)),
        a16, b16, _meta(16, 16), v)
    bmm = 2 * 4 * 8 * 16 * 32
    assert rec["dot_flops_by_dtype"] == {
        "bf16": 2.0 * bmm, "f32": 2.0 * 16 * 16 + 2 * 16 + 2 * 16 ** 3}
    assert rec["dot_flops"] == sum(rec["dot_flops_by_dtype"].values())


def test_linear_backward_counts_its_two_products():
    x = _meta(8, 32).requires_grad_(True)
    w = _meta(32, 16).requires_grad_(True)
    y = x @ w

    def backward(y):
        y.sum().backward()
    assert _flops(backward, y) == 2 * (2 * 8 * 32 * 16)


def test_conv_counts_nothing():
    x = _meta(2, 8, 64)
    w = _meta(8, 1, 4)
    _, rec = hlo_analysis.analyze(
        lambda x, w: torch.nn.functional.conv1d(x, w, groups=8, padding=3),
        x, w)
    assert rec["dot_flops"] == 0 and rec["ops"] >= 1


def test_peak_counts_live_storages_and_what_autograd_saves():
    mb = 1000 * 1000 * 4
    x = _meta(1000, 1000).requires_grad_(True)

    def step(x):
        a = x * 2.0              # new; sin saves it for its backward
        b = torch.sin(a)         # new
        v = b.view(-1)           # a view: no new storage
        del a                    # still held by autograd
        c = v.sum()              # 4 bytes
        del b, v                 # b's storage dies here
        return c
    c, rec = hlo_analysis.analyze(step, x)
    assert rec["argument_bytes"] == mb
    assert rec["peak_bytes"] == 3 * mb + 4       # x, a, b and c at once
    assert rec["end_bytes"] == 2 * mb + 4        # x, a (saved), c
    assert rec["output_bytes"] == 4
    assert c.grad_fn is not None


def test_held_bytes_and_meta_answers():
    """A tensor held at a rank's bytes counts those bytes; an op given the
    same input shapes again on meta is answered from the first answer
    with the same shapes, strides and dtypes."""
    x = _meta(64, 64)
    t = _meta(100, 10)

    def f(x, t):
        y = [torch.exp(x) for _ in range(3)]
        return y[0].t().contiguous(), y[2].stride(), t.sum(0)
    (a, stride, s), rec = hlo_analysis.analyze(f, x, t,
                                               hold_bytes={id(t): 40})
    assert rec["argument_bytes"] == 64 * 64 * 4 + 40
    assert a.shape == (64, 64) and a.stride() == (64, 1)
    assert stride == (64, 1) and s.shape == (10,)
    assert rec["tensor_devices"] == ["meta"]


# -- the ten smoke configs, one device -----------------------------------------

def _ssd_extra(cfg, kind, b, s) -> int:
    """The reference's extra backward dots of the SSD einsums (docstring)."""
    if kind != "train" or cfg.family not in ("ssm", "hybrid"):
        return 0
    h, p, q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk
    return cfg.num_layers * 2 * b * s * h * (2 * p + q)


def _jstep_flops(arch, kind, b, s) -> float:
    cfg = jget_config(arch, smoke=True)
    api = jget_model(cfg)
    aparams = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    if kind == "decode":
        kw = {"src_len": s} if cfg.family == "encdec" else {}
        cache = jax.eval_shape(lambda: api.init_cache(b, s, **kw))
        lowered = jax.jit(api.decode_step).lower(
            aparams, cache, sds((b, 1), jnp.int32))
    else:
        batch = {k: sds(tuple(v.shape), {torch.int32: jnp.int32,
                                         torch.bfloat16: jnp.bfloat16}[v.dtype])
                 for k, v in shp.abstract_batch(
                     get_config(arch, smoke=True),
                     shp.ShapeCase("x", kind, s, b)).items()}
        if kind == "train":
            opt = jget_optimizer(cfg.optimizer)
            lowered = jax.jit(jmake_train_step(api.loss_fn, opt)).lower(
                aparams, jax.eval_shape(opt.init, aparams), batch)
        else:
            batch.pop("labels")
            lowered = jax.jit(lambda p, bt: api.prefill(p, bt, max_len=s)
                              ).lower(aparams, batch)
    return janalyze(lowered.compile().as_text())["dot_flops"]


def check_smoke_steps(arch):
    """The train, prefill and decode steps of `arch`'s smoke config at
    (B, S) on one device: the port's dot FLOPs against the reference's."""
    cfg = get_config(arch, smoke=True)
    for kind in ("train", "prefill", "decode"):
        step = dryrun.build_step(cfg, shp.ShapeCase("x", kind, S, B))
        got = dryrun.analyze_step(step)
        want = _jstep_flops(arch, kind, B, S)
        assert got["dot_flops"] == want - _ssd_extra(cfg, kind, B, S), kind
        assert got["tensor_devices"] == ["meta"], kind
        assert got["dot_flops"] == sum(got["dot_flops_by_dtype"].values())


@pytest.mark.parametrize("arch", ARCH_IDS[:5])
def test_smoke_steps_dot_flops_equal_the_reference(arch):
    check_smoke_steps(arch)


def test_ssd_formula_holds_off_the_smoke_widths():
    """Q != P != N and more rows, so each term of the formula shows."""
    over = {"ssm_chunk": 8, "ssm_state": 32, "ssm_head_dim": 8}
    b, s = 3, 64
    cfg = get_config("mamba2-2.7b", smoke=True).with_(**over)
    jcfg = jget_config("mamba2-2.7b", smoke=True).with_(**over)
    japi = jget_model(jcfg)
    ap = jax.eval_shape(japi.init, jax.random.PRNGKey(0))
    opt = jget_optimizer(jcfg.optimizer)
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32)
             for k in ("tokens", "labels")}
    want = janalyze(jax.jit(jmake_train_step(japi.loss_fn, opt)).lower(
        ap, jax.eval_shape(opt.init, ap), batch).compile().as_text()
    )["dot_flops"]
    got = dryrun.analyze_step(dryrun.build_step(
        cfg, shp.ShapeCase("x", "train", s, b)))["dot_flops"]
    assert want - got == _ssd_extra(cfg, "train", b, s) > 0
    np.testing.assert_equal(cfg.ssm_heads, 128 // 8)
