"""The port's INT8 error-feedback gradient compression
(`repro_torch.distributed.compression`) against
`repro.distributed.compression`, on the CPU: the single-device cases of
tests/test_compression.py on the port, and codes, scales, outputs and
residuals bit-identical to the reference's on the same numpy inputs
(the scale divides by a tensor, so the division is correctly rounded in
both). The two-level all-reduce runs over spawned ranks, in
tests/test_torch_sharded_elastic.py."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis; "
                    "see requirements.txt")

import jax
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.distributed import compression as jcomp
from repro_torch import _tree
from repro_torch.distributed import compression as comp


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_roundtrip_error_bound():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 5
    q, scale = comp.quantize_int8_tensor(x)
    err = torch.max(torch.abs(comp.dequantize_int8_tensor(q, scale) - x))
    assert float(err) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_is_unbiased_over_time():
    """With error feedback, the SUM of decompressed gradients converges to
    the sum of true gradients (residual stays bounded)."""
    gen = torch.Generator().manual_seed(1)
    err = torch.zeros(256)
    total_true = torch.zeros(256)
    total_sent = torch.zeros(256)
    for i in range(50):
        g = torch.randn(256, generator=gen) * (1.0 + i % 3)
        total_true += g
        sent, err = comp.compress_decompress(g, err)
        total_sent += sent
    np.testing.assert_allclose((total_sent + err).numpy(),
                               total_true.numpy(), rtol=1e-4, atol=1e-3)
    assert float(torch.max(torch.abs(err))) < 1.0


def test_apply_error_feedback_tree():
    g = {"a": torch.ones(8), "b": {"c": torch.full((4,), -2.0)}}
    e = comp.init_error_state(g)
    out, e2 = comp.apply_error_feedback(g, e)
    assert [n for n, _ in _tree.named_leaves(out)] == ["a", "b__c"]
    assert [n for n, _ in _tree.named_leaves(e2)] == ["a", "b__c"]
    np.testing.assert_allclose(out["a"].numpy(), np.ones(8), atol=0.02)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_compress_preserves_large_values(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=64).astype(np.float32) * 100)
    q, s = comp.quantize_int8_tensor(x)
    deq = comp.dequantize_int8_tensor(q, s)
    assert float(torch.max(torch.abs(deq - x))) <= float(s) * 0.5 + 1e-4


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_codes_scales_outputs_residuals_bit_identical(scale):
    """Ten error-feedback rounds over a tree, fed the same numpy grads:
    every code, scale, output and residual equals the reference's."""
    rng = np.random.default_rng(int(scale * 1000))
    shapes = {"w": (33, 7), "b": (7,), "deep": {"k": (2, 5, 3)}}

    def draw():
        return jax.tree.map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))
    g0 = draw()
    je = jcomp.init_error_state(jax.tree.map(jnp.asarray, g0))
    e = comp.init_error_state(_tree.tree_map(torch.from_numpy, g0))
    for _ in range(10):
        g = draw()
        for name, leaf in _tree.named_leaves(g):
            jq, js = jcomp.quantize_int8_tensor(jnp.asarray(leaf))
            q, s = comp.quantize_int8_tensor(torch.from_numpy(leaf))
            _same(q, jq)
            _same(s, js)
            _same(comp.dequantize_int8_tensor(q, s),
                  jcomp.dequantize_int8_tensor(jq, js))
        jout, je = jcomp.apply_error_feedback(jax.tree.map(jnp.asarray, g),
                                              je)
        out, e = comp.apply_error_feedback(
            _tree.tree_map(torch.from_numpy, g), e)
        for (_, a), b in zip(_tree.named_leaves(out), jax.tree.leaves(jout)):
            _same(a, b)
        for (_, a), b in zip(_tree.named_leaves(e), jax.tree.leaves(je)):
            _same(a, b)
