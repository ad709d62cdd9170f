"""The ported kernels' plain versions against the reference Pallas kernels
(run with interpret=True on the CPU, as tests/test_kernels.py does),
bit-exact at small ragged shapes; the wrappers' output contract and width
limits; and the build helper. The kernels themselves run in
test_torch_cuda.py."""
import ctypes
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import BitPlanarDB as JBitPlanarDB
from repro.core import bitplanar as jbitplanar
from repro.core import build_database as j_build
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.stage0_sign import stage0_sign_gather_pallas
from repro.kernels.stage1_gather import stage1_int4_gather_pallas
from repro.kernels.stage1_int4 import (stage1_int4_batched_pallas,
                                       stage1_int4_rows_pallas)
from repro.kernels.stage2_int8 import stage2_int8_batched_pallas
from repro_torch.kernels import (_build, fused_topk, ops, ref, stage0_sign,
                                 stage1_gather, stage1_int4, stage2_int8)
from repro_torch.kernels.stage0_sign import stage0_sign_gather
from repro_torch.kernels.stage1_gather import stage1_int4_gather
from repro_torch.kernels.stage1_int4 import (SMEM_BYTES,
                                             stage1_int4_batched,
                                             stage1_int4_rows,
                                             stage1_int4_single)
from repro_torch.kernels.stage2_int8 import (stage2_int8_batched,
                                             stage2_int8_by_id)


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


@pytest.mark.parametrize("b,c,n,d", [(1, 16, 40, 250), (3, 32, 77, 6),
                                     (4, 48, 300, 512), (2, 16, 9, 36)])
def test_exact_by_id_plain_matches_pallas(b, c, n, d):
    """The by-id exact rescore's plain version against the Pallas kernel
    on the reference's own gather: holes (-1) read row 0, as the reference
    engine's `jnp.maximum(cand, 0)` makes them, and ids at or past N read
    row N - 1, as JAX's indexing (`x[ids]`) clamps them; the reference
    engine's `jnp.take` would fill them instead, but the engine never
    passes an id >= N. D/2 is odd at D = 250 and 6."""
    rng = np.random.default_rng(b * 1000 + n + d)
    q = rng.integers(-128, 128, (b, d)).astype(np.int8)
    msb = rng.integers(0, 256, (n, d // 2)).astype(np.uint8)
    lsb = rng.integers(0, 256, (n, d // 2)).astype(np.uint8)
    ids = rng.integers(-3, n + 3, (b, c)).astype(np.int32)
    ids[:, :4] = [-1, n - 1, n, n + 5]
    safe = jnp.maximum(jnp.asarray(ids), 0)
    q_eo8 = jops.pack_queries_even_odd(jnp.asarray(q))
    want = np.asarray(stage2_int8_batched_pallas(
        q_eo8, jnp.asarray(msb)[safe], jnp.asarray(lsb)[safe], block_c=16,
        interpret=True))
    got = ops.stage2_scores_by_id(_t(q), _t(msb), _t(lsb), _t(ids))
    assert got.dtype == torch.int32 and got.shape == (b, c)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        stage2_int8_by_id(_t(np.asarray(q_eo8)), _t(msb), _t(lsb),
                          _t(ids)).numpy(), want)


def test_plane_scan_routes_on_the_launchers_answer(monkeypatch):
    """The batched plane scan asks the tensor-core launcher for its lane
    tile (`_mma_lanes`) and launches that kernel when the answer is not 0,
    else dp4a; the single-query form and a forced dp4a never ask. Asking
    for the tensor-core kernel at a shape it does not take, or for a route
    that does not exist, raises naming it."""
    calls = _capture_launches(monkeypatch)
    asked, answer = [], [0]

    def lanes(b, d2, rows):
        asked.append((b, d2, rows))
        return answer[0]
    monkeypatch.setattr(stage1_int4, "_mma_lanes", lanes)
    q = torch.zeros((2, 4, 32), dtype=torch.int8)
    plane = torch.zeros((5, 32), dtype=torch.uint8)
    assert stage1_int4_batched(q, plane, rows=512).shape == (4, 5)
    answer[0] = 16
    assert stage1_int4_batched(q, plane, rows=512).shape == (4, 5)
    assert stage1_int4._plane(q, plane, 256, route="dp4a").shape == (4, 5)
    assert stage1_int4_single(q[:, 0].contiguous(), plane).shape == (5,)
    assert asked == [(4, 32, 512), (4, 32, 512)]
    assert [c for c, _ in calls] == ["stage1_plane", "stage1_plane_mma",
                                     "stage1_plane", "stage1_single"]
    assert [args[-1] for _, args in calls] == [512, 512, 256, 256]
    answer[0] = 0
    with pytest.raises(ValueError, match="does not take B = 4, D/2 = 32"):
        stage1_int4._plane(q, plane, 256, route="mma")
    with pytest.raises(ValueError, match="route must be one of"):
        stage1_int4._plane(q, plane, 256, route="wgmma")
    assert len(calls) == 4


def test_fused_topk_routes_on_the_launchers_answer(monkeypatch):
    """The batched fused top-k asks the tensor-core launcher for its lane
    tile (`_fused_mma_lanes`, with B, D/2, block_n and k) and launches that
    kernel (counted `fused_topk_mma`, mma flag 1) when the answer is not 0,
    else dp4a (flag 0); the single-query form and a forced dp4a never ask,
    and only the dp4a route meets the dp4a kernel's shared-memory limit.
    Asking for the tensor-core kernel at a shape it does not take, or for a
    route that does not exist, raises naming it."""
    calls = _capture_launches(monkeypatch)
    asked, answer = [], [0]

    def lanes(b, d2, block_n, k):
        asked.append((b, d2, block_n, k))
        return answer[0]
    monkeypatch.setattr(fused_topk, "_fused_mma_lanes", lanes)
    q = torch.zeros((4, 2, 32), dtype=torch.int8)
    plane = torch.zeros((600, 32), dtype=torch.uint8)
    owner = torch.zeros((600,), dtype=torch.int32)
    tids = torch.zeros((4,), dtype=torch.int32)
    s, i = fused_topk.fused_topk_batched(q, plane, k=3, block_n=512)
    assert s.shape == i.shape == (4, 2, 3)
    answer[0] = 8
    s, i = fused_topk.fused_topk_batched(q, plane, owner, tids, k=5,
                                         block_n=256)
    assert s.shape == i.shape == (4, 3, 5)
    assert fused_topk._fused(q, plane, None, None, 3, 512,
                             route="dp4a")[0].shape == (4, 2, 3)
    s, i = fused_topk.fused_topk_single(q[0], plane, k=2, block_n=128)
    assert s.shape == i.shape == (5, 2)
    assert asked == [(4, 32, 512, 3), (4, 32, 256, 5)]
    assert [c for c, _ in calls] == ["fused_topk", "fused_topk_mma",
                                     "fused_topk", "fused_topk_single"]
    assert [args[-1] for _, args in calls] == [0, 1, 0, 0]
    assert [args[-3:-1] for _, args in calls] == [(512, 3), (256, 5),
                                                  (512, 3), (128, 2)]
    too_big = SMEM_BYTES // 4
    assert fused_topk._fused(q, plane, None, None, 1, too_big,
                             route="mma")[0].shape == (4, 1, 1)
    with pytest.raises(ValueError, match="above what one thread block"):
        fused_topk._fused(q, plane, None, None, 1, too_big, route="dp4a")
    answer[0] = 0
    with pytest.raises(ValueError, match="does not take B = 4, D/2 = 32, "
                                         "block_n = 512, k = 3"):
        fused_topk._fused(q, plane, None, None, 3, 512, route="mma")
    with pytest.raises(ValueError, match="route must be one of"):
        fused_topk._fused(q, plane, None, None, 3, 512, route="wgmma")
    assert len(calls) == 5


def test_sign_plane_routes_on_the_launchers_answer(monkeypatch):
    """The dense sign scan asks the tensor-core launcher for its lane tile
    (`_mma_lanes`, with B, N, D/8 and rows) and launches that kernel
    (counted `stage0_sign_plane_mma`) when the answer is not 0, else the
    popcount kernel, both with the same C arguments (D, not D/8); a forced
    popcount route never asks. Asking for the tensor-core kernel at a
    shape it does not take, or for a route that does not exist, raises
    naming it."""
    calls = _capture_launches(monkeypatch)
    asked, answer = [], [0]

    def lanes(b, n, d8, rows):
        asked.append((b, n, d8, rows))
        return answer[0]
    monkeypatch.setattr(stage0_sign, "_mma_lanes", lanes)
    q = torch.ones((4, 256), dtype=torch.int8)
    plane = torch.zeros((5, 32), dtype=torch.uint8)
    assert stage0_sign.stage0_sign_batched(q, plane, rows=512).shape == (4, 5)
    answer[0] = 8
    assert ops.stage0_sign_scores_batched(q, plane,
                                          block_n=1024).shape == (4, 5)
    assert stage0_sign._sign_plane(q, plane, 256,
                                   route="popc").shape == (4, 5)
    assert stage0_sign._sign_plane(q, plane[:0], 256,
                                   route="mma").shape == (4, 0)
    assert asked == [(4, 5, 32, 512), (4, 5, 32, 1024), (4, 0, 32, 256)]
    assert [c for c, _ in calls] == ["stage0_sign_plane",
                                     "stage0_sign_plane_mma",
                                     "stage0_sign_plane"]
    assert [args[-3:] for _, args in calls] == [(5, 256, 512),
                                                (5, 256, 1024), (5, 256, 256)]
    answer[0] = 0
    with pytest.raises(ValueError, match="does not take B = 4, N = 5, "
                                         "D = 256 at 256 rows per tile"):
        stage0_sign._sign_plane(q, plane, 256, route="mma")
    with pytest.raises(ValueError, match="route must be one of"):
        stage0_sign._sign_plane(q, plane, 256, route="dp4a")
    with pytest.raises(ValueError, match="rows per thread block"):
        stage0_sign.stage0_sign_batched(q, plane, rows=2048)
    assert len(calls) == 3


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
        if n:
            ids = torch.zeros((3, 2), dtype=torch.int32)
            assert ops.stage1_scores_gather(
                q, plane, ids, block_rows=5).shape == (3, 10)
            assert ops.stage0_sign_scores_gather(
                ops.pack_query_signs(q), plane[:, :8], ids,
                block_rows=5).shape == (3, 10)


def test_wrappers_raise_for_devices_without_a_kernel():
    plane = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    panel = torch.zeros((2, 1, 32), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stage1_int4_batched(panel, plane)
    with pytest.raises(ValueError, match="no kernel"):
        stage1_int4_rows(panel.reshape(1, 2, 32), plane[None])
    with pytest.raises(ValueError, match="no kernel"):
        stage2_int8_batched(panel.reshape(1, 2, 32), plane[None], plane[None])
    with pytest.raises(ValueError, match="no kernel"):
        stage2_int8_by_id(panel.reshape(1, 2, 32), plane, plane,
                          torch.zeros((1, 2), dtype=torch.int32,
                                      device="meta"))
    ids = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stage1_int4_gather(panel.reshape(1, 2, 32), plane, ids, block_rows=2)
    with pytest.raises(ValueError, match="no kernel"):
        stage0_sign_gather(panel.reshape(1, 64), plane[:, :8], ids,
                           block_rows=2)


def _tma_rule(n: int, d2: int, block_rows: int) -> bool:
    """The TMA gather launcher's rule (stage1_gather_tma_takes)."""
    return d2 % 16 == 0 and block_rows % 64 == 0 and 0 < n < 2 ** 31


def _bulk_rule(ptr: int, n: int, d8: int, block_rows: int,
               group: int) -> int:
    """The bulk sign gather launcher's rule (stage0_sign_bulk_takes): rows
    of 4, 8, 16 bytes with block_rows % 4 == 0 or of 32, 64, 128 bytes,
    whole 16-byte units per block and per straddling block, an aligned
    plane, 0 < N < 2^31, and a ring of four stages (of 8 KiB, or one
    block) beside the group's packed signs within one block's shared
    memory; 2 (the route's choice) for rows of at most 16 bytes, 1 for
    wider ones, 0 for a shape it does not take."""
    if not (d8 in (4, 8, 16) and block_rows % 4 == 0 or d8 in (32, 64, 128)):
        return 0
    block = block_rows * d8
    stage = max(1, 8192 // block) * block
    words = -(-(-(-d8 // 4)) // 4) * 4
    smem = 128 + 4 * stage + 64 + group * words * 4 + group * 4
    takes = (block % 16 == 0 and n % block_rows * d8 % 16 == 0
             and ptr % 16 == 0 and 0 < n < 2 ** 31 and smem <= SMEM_BYTES)
    return (2 if d8 <= 16 else 1) if takes else 0


def _capture_launches(monkeypatch, mma_lanes: int = 0,
                      fused_lanes: int = 0, gather_tma=_tma_rule,
                      sign_lanes: int = 0, sign_bulk=_bulk_rule) -> list:
    """Runs the wrappers' CUDA branch on CPU tensors up to the launch: every
    check a CUDA tensor meets runs, and each launch is recorded (counter,
    C arguments) instead of reaching a kernel. The tensor-core plane
    launcher answers `mma_lanes` for every shape it is asked about, the
    tensor-core fused launcher `fused_lanes`, the TMA gather launcher
    `gather_tma(n, d2, block_rows)`, the tensor-core sign launcher
    `sign_lanes`, the bulk sign gather launcher
    `sign_bulk(ptr, n, d8, block_rows, group)`."""
    calls = []
    for mod in (stage1_int4, stage1_gather, stage2_int8, stage0_sign,
                fused_topk):
        monkeypatch.setattr(mod, "_on_cpu", lambda t: False)
    monkeypatch.setattr(_build, "function", lambda *a: None)
    monkeypatch.setattr(stage1_int4, "_mma_lanes",
                        lambda b, d2, rows: mma_lanes)
    monkeypatch.setattr(fused_topk, "_fused_mma_lanes",
                        lambda b, d2, block_n, k: fused_lanes)
    monkeypatch.setattr(stage1_gather, "_tma_takes", gather_tma)
    monkeypatch.setattr(stage0_sign, "_mma_lanes",
                        lambda b, n, d8, rows: sign_lanes)
    monkeypatch.setattr(stage0_sign, "_bulk_takes", sign_bulk)
    monkeypatch.setattr(_build, "launch",
                        lambda counter, fn, *args, device: calls.append(
                            (counter, args)))
    return calls


@pytest.mark.parametrize("d", [36, 250, 262144, 512, 32, 800])
def test_width_limits_name_themselves(monkeypatch, d):
    """The widths the JAX Pallas backend serves reach the kernels: D % 8 !=
    0 with D even (rows of D/2 bytes that are not whole words) and D whose
    query panels exceed one block's shared memory (262,144: 2 x 128 KiB of
    panels). Every nibble wrapper launches with D/2 bytes per row; the
    batched plane scan takes the tensor-core kernel where its launcher
    takes the shape (answered here as the launcher answers: at D = 512
    only, where D/2 % 16 == 0 and the panels fit); the block gather takes
    the TMA kernel where its launcher's rule holds (D/2 % 16 == 0,
    block_rows % 64 == 0, 0 < N < 2^31; counted `stage1_gather`), else
    dp4a (`stage1_gather_dp4a`), and only the dp4a route is held to the
    dp4a grid's limits; the sign kernels take D % 8 == 0, and their one
    limit (a lane's packed signs in one block) raises with a message that
    names it."""
    calls = _capture_launches(monkeypatch, mma_lanes=8 if d == 512 else 0)
    d2 = d // 2
    q = torch.zeros((3, d), dtype=torch.int8)
    plane = torch.zeros((5, d2), dtype=torch.uint8)
    rows = torch.zeros((3, 4, d2), dtype=torch.uint8)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    assert ops.stage1_scores_batched(q, plane).shape == (3, 5)
    assert ops.stage1_scores(q[0], plane).shape == (5,)
    assert ops.stage1_scores_rows(q, rows).shape == (3, 4)
    assert ops.stage1_scores_gather(q, plane, ids,
                                    block_rows=4).shape == (3, 8)
    assert ops.stage1_scores_gather(q, plane, ids,
                                    block_rows=64).shape == (3, 128)
    assert ops.stage2_scores_batched(q, rows, rows).shape == (3, 4)
    assert ops.stage2_scores(q[0], plane, plane).shape == (5,)
    assert ops.stage2_scores_by_id(q, plane, plane, ids).shape == (3, 2)
    s, i = fused_topk.fused_topk_batched(ops.pack_queries_even_odd(q), plane,
                                         k=2, block_n=4)
    assert s.shape == i.shape == (3, 2, 2)
    tma = d2 % 16 == 0
    assert [c for c, _ in calls] == [
        "stage1_plane_mma" if d == 512 else "stage1_plane", "stage1_single",
        "stage1_rows", "stage1_gather_dp4a",
        "stage1_gather" if tma else "stage1_gather_dp4a", "stage2_exact",
        "stage2_single", "stage2_by_id", "fused_topk"]
    assert all(d2 in args for _, args in calls)
    q_eo = ops.pack_queries_even_odd(q)
    with pytest.raises(ValueError, match="route must be one of"):
        stage1_gather._gather(q_eo, plane, ids, 64, route="mma")
    if not tma:
        with pytest.raises(ValueError, match=f"does not take N = 5, "
                           f"D/2 = {d2}, block_rows = 64"):
            stage1_gather._gather(q_eo, plane, ids, 64, route="tma")
    # the dp4a grid's limits (B <= 65535 lanes, ceil(J * BR / 256) < 2^31
    # blocks), on tensors that hold no memory; the TMA launcher's int
    # arguments take B = 65536 and J = 2^31 - 1, not J = 2^31
    meta = {"dtype": torch.int8, "device": "meta"}
    wide_q = torch.empty((65536, 2, d2), **meta)
    meta_plane = torch.empty((5, d2), dtype=torch.uint8, device="meta")

    def meta_ids(b, j):
        return torch.empty((b, j), dtype=torch.int32, device="meta")

    for args in ((wide_q, meta_plane, meta_ids(65536, 1)),
                 (wide_q[:1], meta_plane, meta_ids(1, 2 ** 33))):
        with pytest.raises(ValueError, match="exceed.* the kernel's grid"):
            stage1_gather._gather(*args, 64, route="dp4a")
    if tma:
        for args in ((wide_q, meta_plane, meta_ids(65536, 1)),
                     (wide_q[:1], meta_plane, meta_ids(1, 2 ** 31 - 1))):
            del calls[:]
            assert stage1_gather._gather(*args, 64).shape == (
                args[0].shape[0], args[2].shape[1] * 64)
            assert [c for c, _ in calls] == ["stage1_gather"]
        with pytest.raises(ValueError, match="launcher's int arguments"):
            stage1_gather._gather(wide_q[:1], meta_plane, meta_ids(1, 2 ** 31),
                                  64)
    with pytest.raises(ValueError, match="empty plane"):
        ops.stage2_scores_by_id(q, plane[:0], plane[:0], ids)
    with pytest.raises(TypeError, match="ids must be torch.int32"):
        ops.stage2_scores_by_id(q, plane, plane, ids.long())
    if d % 8 == 0:
        signs = torch.ones((3, d), dtype=torch.int8)
        sign_plane = torch.zeros((5, d // 8), dtype=torch.uint8)
        assert ops.stage0_sign_scores_batched(signs, sign_plane).shape == (
            3, 5)
        assert ops.stage0_sign_scores_gather(signs, sign_plane, ids,
                                             block_rows=4).shape == (3, 8)
    too_wide = 32 * (SMEM_BYTES // 4 + 1)
    with pytest.raises(ValueError, match="above what one thread block"):
        ops.stage0_sign_scores_batched(
            torch.ones((1, too_wide), dtype=torch.int8),
            torch.zeros((1, too_wide // 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="above what one thread block"):
        fused_topk.fused_topk_batched(ops.pack_queries_even_odd(q), plane,
                                      k=2, block_n=SMEM_BYTES // 4)


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
    plane = torch.zeros((9, 32), dtype=torch.uint8)
    ops.stage1_scores_batched(q, plane)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    ops.stage2_scores_by_id(q, plane, plane, ids)
    ops.exact_rerank_by_id(q, plane, plane, ids,
                           torch.zeros(9, dtype=torch.int32), k=2,
                           metric="cosine")
    ops.rerank(ids, ids, ids, k=2, metric="mips")
    assert ops.launch_counts() == {
        "stage1_plane": 0, "stage1_rows": 0, "stage2_exact": 0,
        "stage1_gather": 0, "stage0_sign_gather": 0, "stage1_single": 0,
        "stage2_single": 0, "stage0_sign_plane": 0, "fused_topk": 0,
        "fused_topk_single": 0, "stage1_plane_mma": 0, "stage2_by_id": 0,
        "fused_topk_mma": 0, "stage1_gather_dp4a": 0,
        "stage0_sign_plane_mma": 0, "stage1_gather_resident": 0,
        "stage0_sign_gather_resident": 0, "stage2_rerank_by_id": 0,
        "stage2_rerank": 0}


# ---------------------------------------------------------------------------
# The two new kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# (B, BR, D, N): N is never a block multiple, so the last block reads past
# N; D = 8 and 40 are not multiples of 32 (sign rows of 1 and 5 bytes).
GATHER_SHAPES = [(1, 8, 8, 61), (3, 32, 40, 250), (8, 64, 256, 300),
                 (3, 8, 256, 77)]


def _gather_case(b, br, d, n, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    q = rng.integers(-128, 128, (b, d)).astype(np.int8)
    q[:, 0] = 0                         # a zero code reads as +1
    nb = -(-n // br)
    ids = rng.integers(0, nb, (b, 5)).astype(np.int32)
    ids[:, -1] = nb - 1                 # every lane reaches the last block
    return codes, q, ids


@pytest.mark.parametrize("b,br,d,n", GATHER_SHAPES)
def test_gather_plain_matches_pallas(b, br, d, n):
    codes, q, ids = _gather_case(b, br, d, n, seed=b * d + n)
    jdb = JBitPlanarDB.from_quantized(j_build(jnp.asarray(
        codes.astype(np.float32))))
    msb = np.asarray(jdb.msb_plane)
    q_msb = np.asarray(jnp.asarray(q) >> 4)
    # the Pallas kernel on the zero-padded plane (what the reference
    # wrapper hands it), against the port on the unpadded one
    padded = np.concatenate([msb, np.zeros((-n % br, d // 2), np.uint8)])
    q_eo = np.asarray(jops.pack_queries_even_odd(jnp.asarray(q_msb)))
    want = np.asarray(stage1_int4_gather_pallas(
        jnp.asarray(q_eo), jnp.asarray(padded), jnp.asarray(ids),
        block_rows=br, interpret=True))
    got = ops.stage1_scores_gather(_t(q_msb), _t(msb), _t(ids),
                                   block_rows=br)
    assert got.dtype == torch.int32 and got.shape == (b, 5 * br)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        stage1_int4_gather(_t(q_eo), _t(msb), _t(ids),
                           block_rows=br).numpy(), want)
    np.testing.assert_array_equal(
        ref.stage1_gather_batched_ref(_t(q_eo), _t(msb), _t(ids),
                                      br).numpy(),
        np.asarray(jref.stage1_gather_batched_ref(
            jnp.asarray(q_eo), jnp.asarray(msb), jnp.asarray(ids), br)))


# (B, BR, D, N, J) at the TMA gather's shapes (D/2 % 16 == 0, BR a
# multiple of 64): one block (J = 1), 128- and 256-row blocks whose last
# block holds whole 64-row pieces past N, a partial last 128-byte slab
# (D = 800), 33 lanes.
TMA_GATHER_SHAPES = [(1, 64, 512, 1000, 1), (3, 128, 512, 777, 5),
                     (33, 256, 64, 700, 3), (5, 64, 800, 300, 4)]


@pytest.mark.parametrize("b,br,d,n,j", TMA_GATHER_SHAPES)
def test_gather_plain_matches_pallas_at_the_tma_shapes(b, br, d, n, j):
    """The port's plain gather against the Pallas kernel in interpret mode
    at the TMA kernel's shapes, with tables in which lanes share blocks
    (every other lane repeats lane 0's) and every lane reaches the final,
    partial block. The Pallas kernel reads the plane zero-padded to a
    block multiple (its wrapper's contract); the port reads it unpadded."""
    rng = np.random.default_rng(b * br + d + n)
    msb = rng.integers(0, 256, (n, d // 2)).astype(np.uint8)
    q_eo = rng.integers(-8, 8, (b, 2, d // 2)).astype(np.int8)
    nb = -(-n // br)
    ids = rng.integers(0, nb, (b, j)).astype(np.int32)
    ids[::2] = ids[0]
    ids[:, -1] = nb - 1
    padded = np.concatenate([msb, np.zeros((-n % br, d // 2), np.uint8)])
    want = np.asarray(stage1_int4_gather_pallas(
        jnp.asarray(q_eo), jnp.asarray(padded), jnp.asarray(ids),
        block_rows=br, interpret=True))
    got = stage1_int4_gather(_t(q_eo), _t(msb), _t(ids), block_rows=br)
    assert got.dtype == torch.int32 and got.shape == (b, j * br)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, -br:][:, n % br:] == 0).all()


@pytest.mark.parametrize("b,br,d,n", GATHER_SHAPES)
def test_sign_gather_plain_matches_pallas(b, br, d, n):
    codes, q, ids = _gather_case(b, br, d, n, seed=b * d + n + 1)
    sign = np.asarray(jbitplanar.pack_sign_plane(jnp.asarray(codes)))
    q_sign = np.asarray(jops.pack_query_signs(jnp.asarray(q)))
    np.testing.assert_array_equal(ops.pack_query_signs(_t(q)).numpy(),
                                  q_sign)
    padded = np.concatenate([sign, np.zeros((-n % br, d // 8), np.uint8)])
    want = np.asarray(stage0_sign_gather_pallas(
        jnp.asarray(q_sign), jnp.asarray(padded), jnp.asarray(ids),
        block_rows=br, interpret=True))
    got = ops.stage0_sign_scores_gather(_t(q_sign), _t(sign), _t(ids),
                                        block_rows=br)
    assert got.dtype == torch.int32 and got.shape == (b, 5 * br)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        stage0_sign_gather(_t(q_sign), _t(sign), _t(ids),
                           block_rows=br).numpy(), want)
    # rows past N score sum(q_sign); every score is the +-1 dot, which is
    # what the kernel's D - 2 * popc(qbits ^ dbits) computes
    rows = ids[:, :, None] * br + np.arange(br)
    past = (rows >= n).reshape(b, -1)
    assert past.any()
    np.testing.assert_array_equal(
        got.numpy()[past],
        np.broadcast_to(q_sign.sum(1, dtype=np.int64)[:, None],
                        past.shape)[past])
    sq = np.where(q < 0, -1, 1).astype(np.int64)
    sd = np.where(codes < 0, -1, 1).astype(np.int64)
    live = rows.reshape(b, -1)
    for i in range(b):
        ok = live[i] < n
        np.testing.assert_array_equal(got.numpy()[i][ok],
                                      sd[live[i][ok]] @ sq[i])


# (lanes, group, BR, D, N): D = 64 and 512 (the decode and cluster rows'
# 8 and 64 bytes), 40 (rows of 5 bytes); N never a block multiple.
GROUPED_SIGN_SHAPES = [(14, 7, 16, 64, 16 * 12 + 3),
                       (14, 1, 16, 64, 16 * 12 + 3),
                       (7, 7, 8, 512, 77), (3, 1, 32, 512, 250),
                       (14, 7, 8, 40, 61), (2, 1, 16, 40, 100)]


@pytest.mark.parametrize("b,group,br,d,n", GROUPED_SIGN_SHAPES)
def test_grouped_sign_gather_matches_pallas(b, group, br, d, n):
    """The sign gather with one block-table row per `group` lanes (the
    decode prescreen's query heads of one KV head): the plain version and
    the wrapper equal the Pallas kernel in interpret mode on the table
    repeated to one row per lane, bit for bit, including the lanes' rows
    past N and a block wholly past it."""
    rng = np.random.default_rng(b * d + n + group)
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    q = rng.integers(-128, 128, (b, d)).astype(np.int8)
    sign = np.asarray(jbitplanar.pack_sign_plane(jnp.asarray(codes)))
    q_sign = np.asarray(jops.pack_query_signs(jnp.asarray(q)))
    nb = -(-n // br)
    ids = rng.integers(0, nb, (b // group, 6)).astype(np.int32)
    ids[:, -1] = nb - 1
    ids[0, 0] = nb
    lane_ids = np.repeat(ids, group, axis=0)
    padded = np.concatenate([sign, np.zeros((-n % br + br, d // 8),
                                            np.uint8)])
    want = np.asarray(stage0_sign_gather_pallas(
        jnp.asarray(q_sign), jnp.asarray(padded), jnp.asarray(lane_ids),
        block_rows=br, interpret=True))
    assert want.shape == (b, 6 * br)
    for got in (ref.stage0_sign_gather_ref(_t(q_sign), _t(sign), _t(ids), br,
                                           group=group),
                ops.stage0_sign_scores_gather(_t(q_sign), _t(sign), _t(ids),
                                              block_rows=br, group=group),
                stage0_sign_gather(_t(q_sign), _t(sign), _t(ids),
                                   block_rows=br, group=group),
                ops.stage0_sign_scores_gather(_t(q_sign), _t(sign),
                                              _t(lane_ids), block_rows=br)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:group, :br], np.broadcast_to(
        q_sign[:group].sum(1, dtype=np.int64)[:, None], (group, br)))


def test_sign_gather_group_must_divide_the_lanes(monkeypatch):
    """A group that does not divide B, or a table without one row per
    group, raises ValueError on the plain path and on the CUDA path
    before any launch."""
    q = torch.ones((6, 64), dtype=torch.int8)
    plane = torch.zeros((64, 8), dtype=torch.uint8)
    for group, rows, match in ((4, 2, "group 4 does not divide the 6"),
                               (0, 2, "group 0 does not divide the 6"),
                               (2, 2, "block_ids has 2 rows; 6 lanes in "
                                      "groups of 2 need 3"),
                               (1, 3, "block_ids has 3 rows")):
        ids = torch.zeros((rows, 3), dtype=torch.int32)
        with pytest.raises(ValueError, match=match):
            ref.stage0_sign_gather_ref(q, plane, ids, 16, group=group)
        with pytest.raises(ValueError, match=match):
            ops.stage0_sign_scores_gather(q, plane, ids, block_rows=16,
                                          group=group)
    calls = _capture_launches(monkeypatch)
    for group, rows in ((4, 2), (2, 2)):
        with pytest.raises(ValueError, match="does not divide|need 3"):
            stage0_sign_gather(q, plane, torch.zeros((rows, 3),
                                                     dtype=torch.int32),
                               block_rows=16, group=group)
    assert calls == []


def test_sign_gather_routes_on_the_launchers_answer(monkeypatch):
    """The sign gather asks the bulk launcher (`_bulk_takes`, with the
    plane's address, N, D/8, block_rows and group) and launches the bulk
    kernel when it answers 2, else the popcount kernel; "bulk" runs it on
    an answer of 1 too. Both count under the caller's key with the same C
    arguments (D and group last); a forced popcount route never asks.
    Asking for the bulk kernel at a shape it does not take, or for a route
    that does not exist, raises naming it."""
    asked, answer = [], [2]

    def takes(ptr, n, d8, br, group):
        asked.append((ptr % 16, n, d8, br, group))
        return answer[0]
    calls = _capture_launches(monkeypatch, sign_bulk=takes)
    functions = []
    monkeypatch.setattr(_build, "function",
                        lambda name, symbol, args: functions.append(symbol))
    q = torch.ones((14, 64), dtype=torch.int8)
    plane = torch.zeros((100, 8), dtype=torch.uint8)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    assert stage0_sign_gather(q, plane, ids, block_rows=16,
                              group=7).shape == (14, 48)
    assert ops.stage0_sign_scores_gather_resident(
        q[:2], plane[:96], ids, block_rows=16).shape == (2, 48)
    answer[0] = 0
    assert ops.stage0_sign_scores_gather(q, plane, ids, block_rows=16,
                                         group=7).shape == (14, 48)
    answer[0] = 1
    assert stage0_sign_gather(q, plane, ids, block_rows=16,
                              group=7).shape == (14, 48)
    assert stage0_sign_gather(q, plane, ids, block_rows=16, group=7,
                              route="bulk").shape == (14, 48)
    answer[0] = 2
    assert stage0_sign_gather(q, plane, ids, block_rows=16, group=7,
                              route="popc").shape == (14, 48)
    assert asked == [(0, 100, 8, 16, 7), (0, 96, 8, 16, 1)] + [
        (0, 100, 8, 16, 7)] * 3
    assert functions == ["stage0_sign_bulk_launch", "stage0_sign_bulk_launch",
                         "stage0_sign_gather_launch",
                         "stage0_sign_gather_launch",
                         "stage0_sign_bulk_launch",
                         "stage0_sign_gather_launch"]
    assert [c for c, _ in calls] == ["stage0_sign_gather",
                                     "stage0_sign_gather_resident"] + [
        "stage0_sign_gather"] * 4
    assert [args[-6:] for _, args in calls] == [
        (14, 100, 3, 16, 64, 7), (2, 96, 3, 16, 64, 1)] + [
        (14, 100, 3, 16, 64, 7)] * 4
    answer[0] = 0
    with pytest.raises(ValueError, match="bulk sign gather does not take "
                                         "N = 100, D = 64, block_rows = 16, "
                                         "group = 7"):
        stage0_sign_gather(q, plane, ids, block_rows=16, group=7,
                           route="bulk")
    with pytest.raises(ValueError, match="route must be one of"):
        stage0_sign_gather(q, plane, ids, block_rows=16, route="tma")
    assert len(calls) == 6


def test_gather_wrappers_hand_the_tma_launcher_the_raw_query(monkeypatch):
    """`ops.stage1_scores_gather` and `ops.stage1_scores_gather_resident`
    hand the TMA launcher the (B, D) nibble query itself, packing nothing;
    on the dp4a route (a shape the TMA launcher refuses) they hand the dp4a
    launcher the packed (B, 2, D/2) panels, packed once per call.
    `stage1_int4_gather(q_eo, ...)` hands the dp4a launcher its panels as
    they are and the TMA launcher a (B, D) copy with the dims interleaved
    back, equal to the query they were packed from."""
    calls = _capture_launches(monkeypatch)
    symbols = []
    monkeypatch.setattr(_build, "function",
                        lambda name, symbol, args: symbols.append(
                            (name, symbol)))
    packed = []

    def pack(q):
        packed.append(ops.pack_queries_even_odd(q))
        return packed[-1]
    monkeypatch.setattr(stage1_gather, "pack_queries_even_odd", pack)
    q = torch.from_numpy(_rand((3, 64), -8, 8, np.int8, 7))
    plane = torch.zeros((128, 32), dtype=torch.uint8)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    for br in (64, 16):
        assert ops.stage1_scores_gather(q, plane, ids,
                                        block_rows=br).shape == (3, 2 * br)
        assert ops.stage1_scores_gather_resident(
            q, plane, ids, block_rows=br).shape == (3, 2 * br)
    q_eo = ops.pack_queries_even_odd(q)
    for br in (64, 16):
        assert stage1_int4_gather(q_eo, plane, ids,
                                  block_rows=br).shape == (3, 2 * br)
    tma = ("stage1_gather", "stage1_gather_tma_launch")
    dp4a = ("stage1_rows", "stage1_gather_launch")
    assert symbols == [tma] * 2 + [dp4a] * 2 + [tma, dp4a]
    assert [c for c, _ in calls] == [
        "stage1_gather", "stage1_gather_resident", "stage1_gather_dp4a",
        "stage1_gather_dp4a", "stage1_gather", "stage1_gather_dp4a"]
    assert len(packed) == 2
    for p in packed:
        assert torch.equal(p, q_eo)
    handed = calls[4][1][0]
    assert handed not in (q.data_ptr(), q_eo.data_ptr())
    assert [args[0] for _, args in calls] == [
        q.data_ptr(), q.data_ptr(), packed[0].data_ptr(),
        packed[1].data_ptr(), handed, q_eo.data_ptr()]
    assert all(args[-5:] == (3, 128, 2, br, 32)
               for (_, args), br in zip(calls, (64, 64, 16, 16, 64, 16)))


@pytest.mark.parametrize("route", ["tma", "dp4a"])
@pytest.mark.parametrize("d", [64, 40])
def test_gather_takes_a_query_at_any_alignment(monkeypatch, route, d):
    """A row-offset view of the (B, D) query (`q[1:]`: D bytes past a
    16-byte boundary, so unaligned at D = 40) and a panel view off the
    16-byte grid go through every gather wrapper on both routes, as they
    did when every call packed a fresh query: the launcher gets a 16-byte
    aligned copy holding the same values (the (B, D) query on TMA, the
    panels on dp4a), and no check raises."""
    calls = _capture_launches(monkeypatch,
                              gather_tma=lambda n, d2, br: route == "tma")
    whole = torch.from_numpy(_rand((4, d), -8, 8, np.int8, d))
    q = whole[1:]
    plane = torch.zeros((128, d // 2), dtype=torch.uint8)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    flat = torch.zeros(3 * d + 4, dtype=torch.int8)
    q_eo = flat[4:].view(3, 2, d // 2)
    q_eo.copy_(ops.pack_queries_even_odd(q))
    assert q_eo.data_ptr() % 16
    handed = []

    def launch(counter, fn, *args, device):
        ptr = args[0]
        assert not ptr % 16, counter
        form = (3, d) if route == "tma" else (3, 2, d // 2)
        handed.append(torch.frombuffer(
            (ctypes.c_int8 * (3 * d)).from_address(ptr),
            dtype=torch.int8).reshape(form).clone())
    monkeypatch.setattr(_build, "launch", launch)
    want = q if route == "tma" else q_eo
    for call in (lambda: ops.stage1_scores_gather(q, plane, ids,
                                                  block_rows=64),
                 lambda: ops.stage1_scores_gather_resident(
                     q, plane, ids, block_rows=64),
                 lambda: stage1_int4_gather(q_eo, plane, ids,
                                            block_rows=64)):
        assert call().shape == (3, 128)
        assert torch.equal(handed[-1], want)
    assert len(handed) == 3 and calls == []


def test_routes_are_asked_once_per_shape(monkeypatch):
    """The TMA gather's route (`stage1_gather_tma_takes`) and the plane
    scan's lane tile (`stage1_mma_lanes`) are asked of their launchers
    once per shape, (N, D/2, block_rows) and (B, D/2, rows): repeated
    launches make no ctypes call to decide their kernel, and a new shape
    asks again."""
    for mod in (stage1_int4, stage1_gather):
        monkeypatch.setattr(mod, "_on_cpu", lambda t: False)
    monkeypatch.setattr(stage1_gather, "_TAKES", {})
    monkeypatch.setattr(stage1_int4, "_LANES", {})
    asked = []

    def function(name, symbol, args):
        if symbol == "stage1_gather_tma_takes":
            return lambda n, d2, br: asked.append((symbol, n, d2, br)) or 1
        if symbol == "stage1_mma_lanes":
            return lambda b, d2, rows: asked.append((symbol, b, d2,
                                                     rows)) or 8
        return None
    monkeypatch.setattr(_build, "function", function)
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda counter, fn, *args, device: launched.append(
                            counter))
    q = torch.zeros((3, 64), dtype=torch.int8)
    plane = torch.zeros((128, 32), dtype=torch.uint8)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    for _ in range(3):
        ops.stage1_scores_gather_resident(q, plane, ids, block_rows=64)
        ops.stage1_scores_gather(q, plane[:100], ids, block_rows=64)
        ops.stage1_scores_batched(q, plane, block_n=256)
        stage1_int4_batched(ops.pack_query_panel(q), plane, rows=512)
    assert asked == [("stage1_gather_tma_takes", 128, 32, 64),
                     ("stage1_gather_tma_takes", 100, 32, 64),
                     ("stage1_mma_lanes", 3, 32, 256),
                     ("stage1_mma_lanes", 3, 32, 512)]
    assert launched == ["stage1_gather_resident", "stage1_gather",
                        "stage1_plane_mma", "stage1_plane_mma"] * 3


def _byte_perm(x: np.ndarray, y: np.ndarray, selector: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, selector) on uint32 words: byte i of the
    result is byte (selector >> 4 i) & 7 of the eight bytes of x then y,
    each word little-endian."""
    both = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)] + [
        (y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= both[(selector >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


@pytest.mark.parametrize("d", range(32, 1025, 32))
def test_raw_query_split_equals_the_packed_panels(d):
    """The TMA gather kernel reads lane b's dims 8w ... 8w + 7 of the
    (B, D) query as one 8-byte unit {x, y} and makes even word w as
    __byte_perm(x, y, 0x6420) and odd word w as __byte_perm(x, y, 0x7531).
    Emulated on int8 queries at every D up to 1024 with D/2 % 16 == 0, the
    words equal `pack_queries_even_odd`'s (B, 2, D/2) panels read as 32-bit
    words, and so do the B-fragment registers a consumer thread t loads at k-step kk
    of slab s (words w0 = 32 s + 8 kk + t and w0 + 4, zero past D/2)."""
    b = 5
    q = _rand((b, d), -128, 128, np.int8, d)
    units = np.ascontiguousarray(q).view(np.uint32).reshape(b, -1, 2)
    x, y = units[..., 0], units[..., 1]
    even, odd = _byte_perm(x, y, 0x6420), _byte_perm(x, y, 0x7531)
    panels = ops.pack_queries_even_odd(torch.from_numpy(q)).numpy()
    words = np.ascontiguousarray(panels).view(np.uint32)   # (B, 2, D/8)
    np.testing.assert_array_equal(even, words[:, 0])
    np.testing.assert_array_equal(odd, words[:, 1])
    n_words = d // 8

    def fragment(w_even, w_odd, w0):
        get = (lambda a, w: a[:, w] if w < n_words else np.zeros(b, np.uint32))
        return [get(w_even, w0), get(w_even, w0 + 4), get(w_odd, w0),
                get(w_odd, w0 + 4)]
    for s in range(-(-n_words // 32)):
        for kk in range(4):
            for t in range(4):
                w0 = 32 * s + 8 * kk + t
                for got, want in zip(fragment(even, odd, w0),
                                     fragment(words[:, 0], words[:, 1], w0)):
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,d,b,j,br", [(256, 256, 4, 6, 32),
                                        (512, 128, 8, 4, 64),
                                        (128, 512, 2, 8, 32)])
def test_resident_gathers_over_two_regions_match_reference(n, d, b, j, br):
    """The resident wrappers over a combined [plane | slab] array whose
    slab blocks mirror plane blocks: scores equal the reference resident
    wrappers' and the plain-plane gather's (the layout of
    tests/test_kernels.py's two-region cases)."""
    rng = np.random.default_rng(n + b)
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    jdb = JBitPlanarDB.from_quantized(j_build(jnp.asarray(
        codes.astype(np.float32))))
    q = rng.integers(-128, 128, (b, d)).astype(np.int8)
    q_msb = np.asarray(jnp.asarray(q) >> 4)
    q_sign = np.asarray(jops.pack_query_signs(jnp.asarray(q)))
    ids = rng.integers(0, n // br, (b, j)).astype(np.int32)
    hot = np.unique(ids)[: max(1, len(np.unique(ids)) // 2)]
    remap = {int(pb): n // br + s for s, pb in enumerate(hot)}
    sids = np.vectorize(lambda x: remap.get(int(x), int(x)))(ids).astype(
        np.int32)
    src = (hot[:, None] * br + np.arange(br)).reshape(-1)
    for plane, stage, jstage, jplain, q_op in (
            (np.asarray(jdb.msb_plane), ops.stage1_scores_gather_resident,
             jops.stage1_scores_gather_resident, ops.stage1_scores_gather,
             q_msb),
            (np.asarray(jdb.sign_plane),
             ops.stage0_sign_scores_gather_resident,
             jops.stage0_sign_scores_gather_resident,
             ops.stage0_sign_scores_gather, q_sign)):
        slab = np.concatenate([plane, plane[src]])
        got = stage(_t(q_op), _t(slab), _t(sids), block_rows=br)
        want = jstage(jnp.asarray(q_op), jnp.asarray(slab),
                      jnp.asarray(sids), block_rows=br)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), jplain(_t(q_op), _t(plane), _t(ids),
                                block_rows=br).numpy())


def test_resident_wrappers_reject_a_partial_plane():
    ids = torch.zeros((2, 2), dtype=torch.int32)
    q = torch.zeros((2, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="block multiple"):
        ops.stage1_scores_gather_resident(
            q, torch.zeros((96, 64), dtype=torch.uint8), ids, block_rows=64)
    with pytest.raises(ValueError, match="block multiple"):
        ops.stage0_sign_scores_gather_resident(
            q, torch.zeros((96, 16), dtype=torch.uint8), ids, block_rows=64)
