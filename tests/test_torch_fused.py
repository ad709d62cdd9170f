"""The fused stage-1 top-k, the dense sign scan and the single-query forms
of stage 1 and stage 2: the port's plain versions and `ops` wrappers
against the reference Pallas kernels (interpret=True on the CPU, as
tests/test_kernels.py runs them) and `repro.kernels.ops`, bit-exact on the
same numpy inputs. The fixtures are tests/test_kernels.py's, plus a padding
lane, a fully masked block, k above the live rows, k above block_n, a
ragged N and D % 8 != 0. The kernels themselves run in
test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import BitPlanarDB as JBitPlanarDB
from repro.core import build_database as j_build
from repro.core import msb_nibble as j_msb
from repro.core import quantize_int8 as j_quantize
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_topk import (fused_topk_batched_pallas,
                                      fused_topk_pallas)
from repro.kernels.stage0_sign import stage0_sign_batched_pallas
from repro.kernels.stage1_int4 import stage1_int4_pallas
from repro.kernels.stage2_int8 import stage2_int8_pallas
from repro_torch.core.similarity import stable_topk
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_topk import (fused_topk_batched,
                                            fused_topk_single)
from repro_torch.kernels.stage0_sign import stage0_sign_batched
from repro_torch.kernels.stage1_int4 import stage1_int4_single
from repro_torch.kernels.stage2_int8 import stage2_int8_single

INT32_MIN = np.iinfo(np.int32).min


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _db(n, d, b, seed):
    """tests/test_kernels.py's make_batch: the JAX database of n random
    documents and b per-vector INT8 queries, as numpy arrays."""
    rng = np.random.default_rng(seed)
    db = j_build(jnp.asarray(rng.normal(size=(n, d)).astype(np.float32)))
    bp = JBitPlanarDB.from_quantized(db)
    q, _ = j_quantize(jnp.asarray(rng.normal(size=(b, d)).astype(np.float32)),
                      per_vector=True)
    return (np.asarray(db.values), np.asarray(bp.msb_plane),
            np.asarray(bp.lsb_plane), np.asarray(q))


def _pad(a, mult, value=0):
    pad = -a.shape[0] % mult
    return np.concatenate([a, np.full((pad,) + a.shape[1:], value, a.dtype)])


# ---------------------------------------------------------------------------
# Fused stage-1 score + per-block top-k
# ---------------------------------------------------------------------------

# tests/test_kernels.py:49 (D = 512), then a ragged N (the last block reads
# zero rows past N), k above block_n (the tail repeats the block base), and
# D = 36 (rows of 18 bytes, not whole words).
@pytest.mark.parametrize("n,d,block,k", [(512, 512, 128, 8), (1024, 512, 256, 4),
                                         (256, 512, 64, 16), (250, 512, 64, 8),
                                         (60, 64, 8, 12), (300, 36, 64, 5)])
def test_fused_topk_single_matches_pallas(n, d, block, k):
    _, msb, _, q = _db(n, d, 1, seed=n + k)
    q_eo = np.asarray(jops.pack_query_even_odd(j_msb(jnp.asarray(q[0]))))
    padded = _pad(msb, block)
    ws, wi = fused_topk_pallas(jnp.asarray(q_eo), jnp.asarray(padded), k=k,
                               block_n=block)
    gs, gi = fused_topk_single(_t(q_eo), _t(msb), k=k, block_n=block)
    assert gs.dtype == gi.dtype == torch.int32
    assert gs.shape == (-(-n // block), k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if k > block:   # the duplicate-id tail: (INT32_MIN, block base)
        tail_i = gi.numpy()[:, block:]
        np.testing.assert_array_equal(
            tail_i, np.broadcast_to((np.arange(len(tail_i)) * block)[:, None],
                                    tail_i.shape))
        assert (gs.numpy()[:, block:] == INT32_MIN).all()


def _owner_case(case, n, rng):
    """(owner, tids) for a masked fixture. "kernels_155": owner random in
    [-1, 3) with a padding lane tid = -2 (tests/test_kernels.py:155).
    "sparse": block 0 fully unowned (every lane's block is fully masked),
    tenant 1 owns only 3 rows (k above its live rows), and a padding lane
    tid = -1."""
    if case == "kernels_155":
        owner = rng.integers(-1, 3, n).astype(np.int32)
        return owner, np.array([0, 1, 2, -2], np.int32)
    owner = rng.integers(0, 3, n).astype(np.int32)
    owner[owner == 1] = 2
    owner[rng.choice(np.arange(64, n), 3, replace=False)] = 1
    owner[:32] = -1
    return owner, np.array([0, 1, 2, -1], np.int32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case,n,d,block,k", [
    ("kernels_155", 512, 256, 128, 8),
    ("sparse", 250, 64, 32, 20),        # ragged N, k > live rows for lane 1
    ("sparse", 200, 36, 8, 12)])        # k > block_n, D % 8 != 0
def test_fused_topk_batched_matches_pallas(masked, case, n, d, block, k):
    _, msb, _, q = _db(n, d, 4, seed=17 + n)
    q_eo = np.asarray(jops.pack_queries_even_odd(j_msb(jnp.asarray(q))))
    owner, tids = _owner_case(case, n, np.random.default_rng(3))
    padded = _pad(msb, block)
    if masked:
        ws, wi = fused_topk_batched_pallas(
            jnp.asarray(q_eo), jnp.asarray(padded),
            jnp.asarray(_pad(owner, block, -1)), jnp.asarray(tids), k=k,
            block_n=block)
        gs, gi = fused_topk_batched(_t(q_eo), _t(msb), _t(owner), _t(tids),
                                    k=k, block_n=block)
    else:
        ws, wi = fused_topk_batched_pallas(jnp.asarray(q_eo),
                                           jnp.asarray(padded), k=k,
                                           block_n=block)
        gs, gi = fused_topk_batched(_t(q_eo), _t(msb), k=k, block_n=block)
    assert gs.shape == gi.shape == (4, -(-n // block), k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if masked:
        # the padding lane and every fully masked block emit (INT32_MIN,
        # block base) in every slot: the same id repeats
        bases = np.arange(gi.shape[1]) * block
        assert (gs.numpy()[3] == INT32_MIN).all()
        np.testing.assert_array_equal(
            gi.numpy()[3], np.broadcast_to(bases[:, None], gi.shape[1:]))
        if case == "sparse":
            assert (gs.numpy()[:, 0] == INT32_MIN).all()
            assert (gi.numpy()[:, 0] == 0).all()
            live = int((owner == 1).sum())
            assert (gs.numpy()[1] > INT32_MIN).sum() == live < k


def test_blockwise_topk_closed_form_equals_iterative_argmax():
    """The closed form against the reference's iterative argmax on scores
    with ties, masked entries, and k above both the live entries and the
    block."""
    rng = np.random.default_rng(11)
    scores = rng.integers(-3, 3, (3, 48)).astype(np.int32)
    scores[0, :16] = INT32_MIN                 # a fully masked block
    scores[1, 16:30] = INT32_MIN               # 2 live entries in block 1
    for k in (1, 5, 16, 20):
        want_s, want_i = zip(*[jref._blockwise_topk(jnp.asarray(row), 16, k)
                               for row in scores])
        got_s, got_i = ref.blockwise_topk(_t(scores), 16, k)
        np.testing.assert_array_equal(got_s.numpy(), np.stack(want_s))
        np.testing.assert_array_equal(got_i.numpy(), np.stack(want_i))


def test_fused_candidates_matches_reference():
    """tests/test_kernels.py:60: with k_per_block >= c the candidates are
    the dense stage-1 top-c; here bit-identical to the reference wrapper,
    order included, at its default and at tuned-style blocks."""
    _, msb, _, q = _db(1000, 512, 1, seed=9)
    q_msb = np.asarray(j_msb(jnp.asarray(q[0])))
    dense = ref.stage1_scores_ref(ops.pack_query_even_odd(_t(q_msb)),
                                  _t(msb))
    _, true = stable_topk(dense, 50)
    for block, kpb in ((256, 50), (128, 8), (512, 50)):
        want = np.asarray(jops.fused_candidates(
            jnp.asarray(q_msb), jnp.asarray(msb), c=50, k_per_block=kpb,
            block_n=block))
        got = ops.fused_candidates(_t(q_msb), _t(msb), c=50,
                                   k_per_block=kpb, block_n=block)
        assert got.dtype == torch.int32 and got.shape == (50,)
        np.testing.assert_array_equal(got.numpy(), want)
        if kpb >= 50:
            np.testing.assert_array_equal(got.numpy(), true.numpy())


@pytest.mark.parametrize("tids", [[0, 1, 2], [0, -1, 2]])
def test_fused_candidates_batched_matches_reference(tids):
    """tests/test_kernels.py:177 (and a padding lane): bit-identical to the
    reference wrapper; each live lane equals the stable top-c of its
    masked dense stage-1 scores, lane for lane."""
    n, d, c = 512, 256, 20
    _, msb, _, q = _db(n, d, 3, seed=23)
    q_msb = np.asarray(j_msb(jnp.asarray(q)))
    owner = np.random.default_rng(5).integers(0, 3, n).astype(np.int32)
    tids = np.asarray(tids, np.int32)
    for block in (128, 100, 1024):
        want = np.asarray(jops.fused_candidates_batched(
            jnp.asarray(q_msb), jnp.asarray(msb), jnp.asarray(owner),
            jnp.asarray(tids), c=c, k_per_block=c, block_n=block))
        got = ops.fused_candidates_batched(_t(q_msb), _t(msb), _t(owner),
                                           _t(tids), c=c, k_per_block=c,
                                           block_n=block)
        assert got.dtype == torch.int32 and got.shape == (3, c)
        np.testing.assert_array_equal(got.numpy(), want)
    scores = ops.stage1_scores_batched(_t(q_msb), _t(msb))
    member = (_t(owner)[None] == _t(tids)[:, None]) & (_t(tids) >= 0)[:, None]
    _, dense = stable_topk(scores.masked_fill(~member, INT32_MIN), c)
    live = tids >= 0
    np.testing.assert_array_equal(got.numpy()[live], dense.numpy()[live])


# ---------------------------------------------------------------------------
# The dense sign scan
# ---------------------------------------------------------------------------

# tests/test_kernels.py:255, plus D = 40 (sign rows of 5 bytes).
@pytest.mark.parametrize("n,d,b,block", [(256, 512, 8, 64), (512, 256, 1, 256),
                                         (96, 128, 32, 32), (250, 512, 4, 64),
                                         (77, 40, 3, 16)])
def test_stage0_sign_batched_matches_pallas(n, d, b, block):
    codes, _, _, q = _db(n, d, b, seed=n + d + b)
    sign = np.asarray(
        JBitPlanarDB.from_quantized(j_build(jnp.asarray(
            codes.astype(np.float32)))).sign_plane)
    q_sign = np.asarray(jops.pack_query_signs(jnp.asarray(q)))
    want = np.asarray(jops.stage0_sign_scores_batched(
        jnp.asarray(q_sign), jnp.asarray(sign), block_n=block))
    got = ops.stage0_sign_scores_batched(_t(q_sign), _t(sign))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), want)
    direct = np.asarray(stage0_sign_batched_pallas(
        jnp.asarray(q_sign), jnp.asarray(_pad(sign, block)), block_n=block,
        interpret=True))[:, :n]
    np.testing.assert_array_equal(
        stage0_sign_batched(_t(q_sign), _t(sign)).numpy(), direct)
    np.testing.assert_array_equal(
        ref.stage0_sign_batched_ref(_t(q_sign), _t(sign)).numpy(),
        np.asarray(jref.stage0_sign_batched_ref(jnp.asarray(q_sign),
                                                jnp.asarray(sign))))
    sq = np.where(q < 0, -1, 1).astype(np.int64)
    sd = np.where(codes < 0, -1, 1).astype(np.int64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), sq @ sd.T)


# ---------------------------------------------------------------------------
# Single-query stage 1 and stage 2
# ---------------------------------------------------------------------------

# tests/test_kernels.py:22, the ragged N of :73, and D = 36.
@pytest.mark.parametrize("n,d,block", [(256, 512, 64), (512, 512, 256),
                                       (128, 256, 128), (1024, 128, 256),
                                       (96, 512, 32), (250, 512, 1024),
                                       (77, 36, 8)])
def test_stage1_single_matches_pallas(n, d, block):
    _, msb, _, q = _db(n, d, 1, seed=n + d)
    q_msb = np.asarray(j_msb(jnp.asarray(q[0])))
    want = np.asarray(jops.stage1_scores(jnp.asarray(q_msb),
                                         jnp.asarray(msb), block_n=block))
    got = ops.stage1_scores(_t(q_msb), _t(msb))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    q_eo = np.asarray(jops.pack_query_even_odd(jnp.asarray(q_msb)))
    np.testing.assert_array_equal(ops.pack_query_even_odd(_t(q_msb)).numpy(),
                                  q_eo)
    nb = n // 64 * 64
    direct = np.asarray(stage1_int4_pallas(
        jnp.asarray(q_eo), jnp.asarray(msb[:nb]), block_n=64,
        interpret=True))
    np.testing.assert_array_equal(
        stage1_int4_single(_t(q_eo), _t(msb[:nb])).numpy(), direct)


# tests/test_kernels.py:33, and D = 36.
@pytest.mark.parametrize("c,d,block", [(64, 512, 64), (50, 512, 64),
                                       (128, 256, 32), (16, 128, 8),
                                       (13, 36, 8)])
def test_stage2_single_matches_pallas(c, d, block):
    codes, msb, lsb, q = _db(max(c, 64), d, 1, seed=c + d)
    mr, lr, q8 = msb[:c], lsb[:c], q[0]
    want = np.asarray(jops.stage2_scores(jnp.asarray(q8), jnp.asarray(mr),
                                         jnp.asarray(lr), block_c=block))
    got = ops.stage2_scores(_t(q8), _t(mr), _t(lr))
    assert got.dtype == torch.int32 and got.shape == (c,)
    np.testing.assert_array_equal(got.numpy(), want)
    cb = c // 8 * 8
    q_eo8 = np.asarray(jops.pack_query_even_odd(jnp.asarray(q8)))
    direct = np.asarray(stage2_int8_pallas(
        jnp.asarray(q_eo8), jnp.asarray(mr[:cb]), jnp.asarray(lr[:cb]),
        block_c=8, interpret=True))
    np.testing.assert_array_equal(
        stage2_int8_single(_t(q_eo8), _t(mr[:cb]), _t(lr[:cb])).numpy(),
        direct)
    exact = codes[:c].astype(np.int64) @ q8.astype(np.int64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)


def test_single_stage2_takes_extreme_values():
    """tests/test_kernels.py:81: all -128 codes, the nibble edge case."""
    from repro_torch.core.bitplanar import pack_nibble_planes
    msb, lsb = pack_nibble_planes(torch.full((64, 512), -128,
                                             dtype=torch.int8))
    q = torch.full((512,), -128, dtype=torch.int8)
    got = ops.stage2_scores(q, msb, lsb)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.full(64, 512 * 128 * 128, np.int64))


def test_new_wrappers_raise_for_devices_without_a_kernel():
    plane = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    q_eo = torch.zeros((2, 32), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stage1_int4_single(q_eo, plane)
    with pytest.raises(ValueError, match="no kernel"):
        stage2_int8_single(q_eo, plane, plane)
    with pytest.raises(ValueError, match="no kernel"):
        stage0_sign_batched(q_eo[:, :8].reshape(2, 8), plane[:, :1])
    with pytest.raises(ValueError, match="no kernel"):
        fused_topk_batched(q_eo[None], plane)
    with pytest.raises(ValueError, match="no kernel"):
        fused_topk_single(q_eo, plane)
    with pytest.raises(ValueError, match="together"):
        fused_topk_batched(q_eo[None], plane,
                           owner=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows per thread block"):
        stage1_int4_single(q_eo, plane, rows=300)
