"""The three ported kernels' plain versions against the reference Pallas
kernels (run with interpret=True on the CPU, as tests/test_kernels.py
does), bit-exact at small ragged shapes; the wrappers' output contract;
and the build helper. The kernels themselves run in test_torch_cuda.py."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.stage1_int4 import (stage1_int4_batched_pallas,
                                       stage1_int4_rows_pallas)
from repro.kernels.stage2_int8 import stage2_int8_batched_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.stage1_int4 import (stage1_int4_batched,
                                             stage1_int4_rows)
from repro_torch.kernels.stage2_int8 import stage2_int8_batched


def _rand(shape, lo, hi, dtype, seed):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        dtype)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("b,n,d,block", [(1, 200, 256, 64), (3, 1000, 128, 128),
                                         (8, 333, 512, 64)])
def test_plane_plain_matches_pallas(b, n, d, block):
    q_msb = _rand((b, d), -8, 8, np.int8, seed=b + n)
    plane = _rand((n, d // 2), 0, 256, np.uint8, seed=n + d)
    want = np.asarray(jops.stage1_scores_batched(
        jnp.asarray(q_msb), jnp.asarray(plane), block_n=block))
    assert want.shape == (b, n)
    got = ops.stage1_scores_batched(_t(q_msb), _t(plane))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # the Pallas kernel itself on a block multiple, against the plain
    # version on the same panel
    nb = (n // block) * block
    panel = np.asarray(jops.pack_query_panel(jnp.asarray(q_msb)))
    direct = np.asarray(stage1_int4_batched_pallas(
        jnp.asarray(panel), jnp.asarray(plane[:nb]), block_n=block,
        interpret=True))
    np.testing.assert_array_equal(
        ref.stage1_scores_batched_ref(_t(panel), _t(plane[:nb])).numpy(),
        direct)
    np.testing.assert_array_equal(
        ops.pack_query_panel(_t(q_msb)).numpy(), panel)


@pytest.mark.parametrize("b,w,d,block", [(1, 100, 256, 64), (3, 333, 128, 64),
                                         (8, 130, 512, 128)])
def test_rows_plain_matches_pallas(b, w, d, block):
    q_msb = _rand((b, d), -8, 8, np.int8, seed=b + w)
    rows = _rand((b, w, d // 2), 0, 256, np.uint8, seed=w + d)
    want = np.asarray(jops.stage1_scores_rows(
        jnp.asarray(q_msb), jnp.asarray(rows), block_w=block))
    got = ops.stage1_scores_rows(_t(q_msb), _t(rows))
    assert got.dtype == torch.int32 and got.shape == (b, w)
    np.testing.assert_array_equal(got.numpy(), want)
    wb = (w // block) * block
    q_eo = np.asarray(jops.pack_queries_even_odd(jnp.asarray(q_msb)))
    direct = np.asarray(stage1_int4_rows_pallas(
        jnp.asarray(q_eo), jnp.asarray(rows[:, :wb]), block_w=block,
        interpret=True))
    np.testing.assert_array_equal(
        ref.stage1_rows_batched_ref(_t(q_eo), _t(rows[:, :wb])).numpy(),
        direct)
    np.testing.assert_array_equal(
        ops.pack_queries_even_odd(_t(q_msb)).numpy(), q_eo)


@pytest.mark.parametrize("b,d", [(1, 256), (3, 512), (8, 128)])
def test_exact_plain_matches_pallas(b, d):
    c = 50
    q = _rand((b, d), -128, 128, np.int8, seed=b + d)
    msb = _rand((b, c, d // 2), 0, 256, np.uint8, seed=d)
    lsb = _rand((b, c, d // 2), 0, 256, np.uint8, seed=d + 1)
    want = np.asarray(jops.stage2_scores_batched(
        jnp.asarray(q), jnp.asarray(msb), jnp.asarray(lsb), block_c=16))
    got = ops.stage2_scores_batched(_t(q), _t(msb), _t(lsb))
    assert got.dtype == torch.int32 and got.shape == (b, c)
    np.testing.assert_array_equal(got.numpy(), want)
    q_eo8 = np.asarray(jops.pack_queries_even_odd(jnp.asarray(q)))
    direct = np.asarray(stage2_int8_batched_pallas(
        jnp.asarray(q_eo8), jnp.asarray(msb[:, :48]), jnp.asarray(lsb[:, :48]),
        block_c=16, interpret=True))
    np.testing.assert_array_equal(
        ref.stage2_scores_batched_ref(_t(q_eo8), _t(msb[:, :48]),
                                      _t(lsb[:, :48])).numpy(), direct)
    # and the JAX oracle on the unpadded shapes
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.stage2_scores_batched_ref(
            jnp.asarray(q_eo8), jnp.asarray(msb), jnp.asarray(lsb))))


def test_exact_plain_is_the_int8_dot_product():
    rng = np.random.default_rng(5)
    codes = rng.integers(-128, 128, size=(4, 50, 512)).astype(np.int8)
    q = rng.integers(-128, 128, size=(4, 512)).astype(np.int8)
    from repro_torch.core.bitplanar import pack_nibble_planes
    msb, lsb = pack_nibble_planes(_t(codes.reshape(200, 512)))
    got = ops.stage2_scores_batched(_t(q), msb.reshape(4, 50, 256),
                                    lsb.reshape(4, 50, 256))
    want = np.einsum("bcd,bd->bc", codes.astype(np.int64), q.astype(np.int64))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_wrappers_trim_to_the_callers_shape_and_take_empty_inputs():
    """No padding leaks out: (B, N), (B, W) and (B, C) exactly, including
    sizes that are no block multiple and empty ones."""
    q = torch.zeros((3, 64), dtype=torch.int8)
    for n in (0, 1, 7, 257):
        plane = torch.zeros((n, 32), dtype=torch.uint8)
        assert ops.stage1_scores_batched(q, plane).shape == (3, n)
        rows = torch.zeros((3, n, 32), dtype=torch.uint8)
        assert ops.stage1_scores_rows(q, rows).shape == (3, n)
        assert ops.stage2_scores_batched(q, rows, rows).shape == (3, n)


def test_wrappers_raise_for_devices_without_a_kernel():
    plane = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    panel = torch.zeros((2, 1, 32), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stage1_int4_batched(panel, plane)
    with pytest.raises(ValueError, match="no kernel"):
        stage1_int4_rows(panel.reshape(1, 2, 32), plane[None])
    with pytest.raises(ValueError, match="no kernel"):
        stage2_int8_batched(panel.reshape(1, 2, 32), plane[None], plane[None])


def test_build_is_keyed_by_source_and_raises_without_nvcc(monkeypatch,
                                                         tmp_path):
    path = _build.library_path("stage1_int4")
    assert path == _build.library_path("stage1_int4")
    assert path != _build.library_path("stage2_int8")
    import repro_torch
    package = Path(repro_torch.__file__).resolve().parent
    assert path.suffix == ".so" and path.parent == package / "build"
    monkeypatch.setattr(_build, "_BUILD", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_launch_counters_reset_and_do_not_count_the_plain_path():
    ops.reset_launch_counts()
    q = torch.zeros((2, 64), dtype=torch.int8)
    ops.stage1_scores_batched(q, torch.zeros((9, 32), dtype=torch.uint8))
    assert ops.launch_counts() == {"stage1_plane": 0, "stage1_rows": 0,
                                   "stage2_exact": 0}
