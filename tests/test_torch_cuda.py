"""The hand-written CUDA kernels and the kernel backend on a CUDA device.

Marked `gpu`; without a CUDA device every case skips. This file imports
no JAX (the GPU machine has none), so on a GPU it runs with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import numpy as np

from repro_torch.core import (BitPlanarDB, bitplanar, build_database,
                              clustering, quantization, quantize_int8)
from repro_torch.core.engine import (MaskedPolicy, PlainPolicy,
                                     RetrievalEngine, WindowedPolicy)
from repro_torch.core.retrieval import RetrievalConfig, cluster_pruned_retrieve
from repro_torch.data import retrieval_corpus
from repro_torch.kernels import autotune, fused_topk, ops, ref, stage0_sign
from repro_torch.kernels.fused_topk import (fused_topk_batched,
                                            fused_topk_single)
from repro_torch.kernels.stage0_sign import (stage0_sign_batched,
                                             stage0_sign_gather)
from repro_torch.kernels.stage1_gather import stage1_int4_gather
from repro_torch.kernels import stage1_gather, stage1_int4
from repro_torch.kernels.stage1_int4 import (DEFAULT_ROWS, ROWS_CHOICES,
                                             stage1_int4_batched,
                                             stage1_int4_rows,
                                             stage1_int4_single)
from repro_torch.kernels.stage2_int8 import (stage2_int8_batched,
                                             stage2_int8_by_id,
                                             stage2_int8_rerank_by_id,
                                             stage2_int8_single,
                                             stage2_rerank)
from repro_torch.configs import get_config
from repro_torch.models import dense, embedder, get_model
from repro_torch.serve import (MultiTenantRAGPipeline, RAGAgent, RAGPipeline,
                               RuntimeConfig, ServingRuntime, sparse_kv)
from repro_torch.tenancy import Arena, MultiTenantIndex

ZERO_COUNTS = {"stage1_plane": 0, "stage1_rows": 0, "stage2_exact": 0,
               "stage1_gather": 0, "stage0_sign_gather": 0,
               "stage1_single": 0, "stage2_single": 0,
               "stage0_sign_plane": 0, "fused_topk": 0,
               "fused_topk_single": 0, "stage1_plane_mma": 0,
               "stage2_by_id": 0, "fused_topk_mma": 0,
               "stage1_gather_dp4a": 0, "stage0_sign_plane_mma": 0,
               "stage1_gather_resident": 0,
               "stage0_sign_gather_resident": 0, "stage2_rerank_by_id": 0,
               "stage2_rerank": 0}
INT32_MIN = -(2 ** 31)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", [(1, 1000, 512), (3, 4099, 256),
                                   (33, 777, 512), (32, 70000, 512)])
def test_cuda_kernels_match_plain(cuda_device, b, n, d):
    gen = torch.Generator(device=cuda_device).manual_seed(b * n + d)

    def rand(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=cuda_device,
                             dtype=dtype)
    ops.reset_launch_counts()
    panel = rand((2, b, d // 2), -8, 8, torch.int8)
    plane = rand((n, d // 2), 0, 256, torch.uint8)
    assert torch.equal(stage1_int4_batched(panel, plane),
                       ref.stage1_scores_batched_ref(panel, plane))
    q_eo = rand((b, 2, d // 2), -8, 8, torch.int8)
    rows = rand((b, n // 4 + 1, d // 2), 0, 256, torch.uint8)
    assert torch.equal(stage1_int4_rows(q_eo, rows),
                       ref.stage1_rows_batched_ref(q_eo, rows))
    q8 = rand((b, 2, d // 2), -128, 128, torch.int8)
    m, lo = (rand((b, 50, d // 2), 0, 256, torch.uint8) for _ in range(2))
    assert torch.equal(stage2_int8_batched(q8, m, lo),
                       ref.stage2_scores_batched_ref(q8, m, lo))
    torch.cuda.synchronize()
    plane_key = ("stage1_plane_mma"
                 if stage1_int4._mma_lanes(b, d // 2, DEFAULT_ROWS)
                 else "stage1_plane")
    assert ops.launch_counts() == dict(ZERO_COUNTS, stage1_rows=1,
                                       stage2_exact=1, **{plane_key: 1})
    with pytest.raises(ValueError):
        stage1_int4_batched(panel, plane[:, : d // 2 - 16].contiguous())
    with pytest.raises(TypeError):
        stage1_int4_batched(panel, plane.to(torch.int8))
    with pytest.raises(ValueError):
        stage2_int8_batched(q8, m[:, ::2], lo[:, ::2])


@pytest.mark.gpu
def test_mma_lane_tile_by_shape(cuda_device):
    """The tensor-core launcher takes B >= 2 and D/2 % 16 == 0 with the
    smallest of 8, 16, 32 lanes that covers B (16 at most at 1024 rows per
    tile), shrunk until a block fits in shared memory, and answers 0 for
    every other shape (those go to dp4a); it refuses to launch a shape it
    answers 0 for."""
    lanes = stage1_int4._mma_lanes
    assert lanes(1, 256, 256) == 0
    assert lanes(2, 256, 256) == 8
    assert lanes(9, 256, 256) == 16
    assert lanes(33, 256, 256) == 32
    assert lanes(33, 256, 1024) == 16
    assert lanes(32, 18, 256) == 0
    assert lanes(40, 4096, 256) == 8
    assert lanes(32, 131072, 256) == 0
    assert lanes(32, 256, 64) == 0
    panel = torch.zeros((2, 4, 9), dtype=torch.int8, device=cuda_device)
    plane = torch.zeros((5, 9), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="does not take B = 4, D/2 = 9"):
        stage1_int4._plane(panel, plane, 256, route="mma")


MMA_BATCHES = (2, 7, 8, 9, 31, 32, 33, 65)
# N: below, at and past one m16 tile, a row count that is no multiple of
# any tile (4099, 20001: ragged boxes, N % 4 != 0 for the 16-byte stores).
MMA_ROWS = (1, 15, 16, 17, 4099, 20001)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ROWS_CHOICES)
@pytest.mark.parametrize("d", [32, 64, 512, 1536])
def test_mma_plane_kernel_matches_plain(cuda_device, rows, d):
    """The tensor-core plane kernel, bit-exact against the plain version at
    every lane tile (B up to 65: two and three tiles), ragged N, widths
    with a partial 128-byte slab (D = 32, 64: one box narrower than the
    swizzle span) and several slabs (1536), at every rows-per-tile
    instance."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(rows + d),
                 cuda_device)
    for n in MMA_ROWS:
        plane = rand((n, d // 2), 0, 256, torch.uint8)
        for b in MMA_BATCHES:
            panel = rand((2, b, d // 2), -8, 8, torch.int8)
            ops.reset_launch_counts()
            got = stage1_int4._plane(panel, plane, rows, route="mma")
            torch.cuda.synchronize()
            assert ops.launch_counts()["stage1_plane_mma"] == 1
            assert torch.equal(got, ref.stage1_scores_batched_ref(panel,
                                                                  plane)), \
                (b, n, d, rows)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ROWS_CHOICES)
@pytest.mark.parametrize("d", [512, 1536])
def test_mma_plane_kernel_at_the_extremes_of_the_range(cuda_device, rows, d):
    """All-(-8) nibbles (16 * sext4 = -128, the s8 operand's floor) against
    all-(-8) and all-7 query panels, and the dp4a kernel's bits."""
    plane = torch.full((3001, d // 2), 0x88, dtype=torch.uint8,
                       device=cuda_device)
    for fill in (-8, 7):
        panel = torch.full((2, 33, d // 2), fill, dtype=torch.int8,
                           device=cuda_device)
        got = stage1_int4._plane(panel, plane, rows, route="mma")
        want = ref.stage1_scores_batched_ref(panel, plane)
        assert int(want[0, 0]) == 2 * (d // 2) * (-8) * fill
        assert torch.equal(got, want)
        assert torch.equal(got, stage1_int4._plane(panel, plane, rows,
                                                   route="dp4a"))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 36, 250, 512])
def test_exact_by_id_matches_gathered_and_plain(cuda_device, d):
    """The exact kernel reading rows in place at their ids equals the
    gathered form on the rows the ids name (holes and ids past N clamped
    to [0, N - 1]) and its plain version; ids include -1, N - 1 and N."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(d),
                 cuda_device)
    n = 1001
    msb = rand((n, d // 2), 0, 256, torch.uint8)
    lsb = rand((n, d // 2), 0, 256, torch.uint8)
    for b, c in ((1, 50), (3, 7), (32, 50)):
        q8 = rand((b, 2, d // 2), -128, 128, torch.int8)
        ids = rand((b, c), -2, n + 2, torch.int32)
        ids[:, 0] = -1
        ids[:, -1] = n - 1
        if c > 2:
            ids[:, 1] = n
        ops.reset_launch_counts()
        got = stage2_int8_by_id(q8, msb, lsb, ids)
        safe = ids.clamp(0, n - 1).long()
        assert torch.equal(got, stage2_int8_batched(q8, msb[safe], lsb[safe]))
        assert torch.equal(got, ref.stage2_scores_by_id_ref(q8, msb, lsb,
                                                            ids))
        torch.cuda.synchronize()
        assert ops.launch_counts() == dict(ZERO_COUNTS, stage2_by_id=1,
                                           stage2_exact=1)


RERANK_C = (1, 5, 50, 257, 2048)
RERANK_D = (8, 36, 250, 512, 1024)
MASKED_SCORE = -(2 ** 31 - 1)


def _ks(c: int) -> list[int]:
    return sorted({k for k in (1, 5, c) if k <= c})


@pytest.mark.gpu
@pytest.mark.parametrize("d", RERANK_D)
@pytest.mark.parametrize("c", RERANK_C)
def test_exact_rerank_kernel_matches_plain(cuda_device, c, d):
    """The whole exact stage in one launch equals its plain version (the
    by-id scores, norms, pins and rerank composed in plain PyTorch) bit for
    bit: cosine and MIPS, with and without a mask (lane 0 all false), at k
    in {1, 5, C}; ids at -1 and past N, repeated rows (ties) and zero
    norms. One launch per call, counted `stage2_rerank_by_id`."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(c * d),
                 cuda_device)
    b, n = 3, 4 * c + 7
    msb = rand((n, d // 2), 0, 256, torch.uint8)
    lsb = rand((n, d // 2), 0, 256, torch.uint8)
    q = rand((b, d), -128, 128, torch.int8)
    ids = rand((b, c), 0, n, torch.int32)
    ids[:, 0] = -1
    if c > 2:
        ids[:, 1] = n + 1
        ids[:, 2] = ids[:, c // 2]
    norms = rand((n,), 0, 1 << 22, torch.int32)
    norms[: n // 5] = 0
    member = rand((b, c), 0, 3, torch.int32) > 0
    member[0] = False
    for metric in ("cosine", "mips"):
        for mask in (None, member):
            for k in _ks(c):
                ops.reset_launch_counts()
                got = stage2_int8_rerank_by_id(q, msb, lsb, ids, norms, mask,
                                               k=k, metric=metric)
                want = ref.exact_rerank_by_id_ref(q, msb, lsb, ids, norms,
                                                  mask, k=k, metric=metric)
                torch.cuda.synchronize()
                for g, w in zip(got, want, strict=True):
                    assert torch.equal(g, w), (metric, mask is None, k)
                assert ops.launch_counts() == dict(ZERO_COUNTS,
                                                   stage2_rerank_by_id=1)


@pytest.mark.gpu
@pytest.mark.parametrize("c", RERANK_C)
def test_rerank_kernel_matches_plain(cuda_device, c):
    """The ranking half on scores and norms already formed equals its plain
    version for any int32: INT32_MIN (the sharded pad pin), MASKED_SCORE,
    INT32_MAX, ties, zero and negative norms; k in {1, 5, C}."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(c + 11),
                 cuda_device)
    b = 4
    scores = rand((b, c), INT32_MIN, 2 ** 31 - 1, torch.int32)
    scores[0] = rand((c,), -3, 4, torch.int32)            # ties
    scores[1, ::3] = INT32_MIN
    scores[1, 1::3] = MASKED_SCORE
    scores[2, ::2] = 2 ** 31 - 1
    norms = rand((b, c), -3, 2 ** 31 - 1, torch.int32)
    norms[:, ::4] = 0
    norms[3] = 1
    ids = rand((b, c), -1, 1 << 20, torch.int32)
    for metric in ("cosine", "mips"):
        for k in _ks(c):
            ops.reset_launch_counts()
            got = stage2_rerank(scores, norms, ids, k=k, metric=metric)
            want = ref.rerank_ref(scores, norms, ids, k=k, metric=metric)
            torch.cuda.synchronize()
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g, w), (metric, k)
            assert ops.launch_counts() == dict(ZERO_COUNTS, stage2_rerank=1)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["cosine", "mips"])
def test_kernel_backend_equals_plain_backend(cuda_device, metric):
    docs, queries, gold = retrieval_corpus(4096, 256, num_queries=24,
                                           seed=7, cluster_size=64)
    db = BitPlanarDB.from_quantized(build_database(docs, device=cuda_device))
    q, _ = quantize_int8(torch.from_numpy(queries).to(cuda_device),
                         per_vector=True)
    owner = (torch.arange(4096, device=cuda_device) // 1024).to(torch.int32)
    tids = torch.from_numpy(gold // 1024).to(cuda_device, torch.int32)
    policies = [PlainPolicy(), MaskedPolicy(owner, tids),
                WindowedPolicy(owner, tids, tids * 1024, 1024)]
    ops.reset_launch_counts()
    for policy in policies:
        got = RetrievalEngine(RetrievalConfig(metric=metric),
                              cuda_device).retrieve(q, db, policy)
        want = RetrievalEngine(RetrievalConfig(metric=metric, backend="torch"),
                               cuda_device).retrieve(q, db, policy)
        for field in ("indices", "scores", "candidate_indices"):
            assert torch.equal(getattr(got, field), getattr(want, field))
    assert ops.launch_counts() == dict(ZERO_COUNTS, stage1_plane_mma=2,
                                       stage1_rows=1, stage2_rerank_by_id=3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d", [(3, 64), (33, 1536), (40, 8192), (5, 200),
                                 (2, 8), (3, 36), (4, 250), (2, 262144)])
def test_kernels_take_every_width(cuda_device, b, d):
    """The plane, rows and exact kernels at widths past the 64-byte chunk
    and the 48 KiB shared-memory default, at D % 8 != 0 (rows read byte by
    byte) and at a D whose panels are walked through shared memory
    (262,144), bit-exact against plain."""
    gen = torch.Generator(device=cuda_device).manual_seed(b + d)

    def rand(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=cuda_device,
                             dtype=dtype)
    panel = rand((2, b, d // 2), -8, 8, torch.int8)
    plane = rand((517, d // 2), 0, 256, torch.uint8)
    assert torch.equal(stage1_int4_batched(panel, plane),
                       ref.stage1_scores_batched_ref(panel, plane))
    q_eo = rand((b, 2, d // 2), -8, 8, torch.int8)
    rows = rand((b, 37, d // 2), 0, 256, torch.uint8)
    assert torch.equal(stage1_int4_rows(q_eo, rows),
                       ref.stage1_rows_batched_ref(q_eo, rows))
    q8 = rand((b, 2, d // 2), -128, 128, torch.int8)
    m, lo = (rand((b, 9, d // 2), 0, 256, torch.uint8) for _ in range(2))
    assert torch.equal(stage2_int8_batched(q8, m, lo),
                       ref.stage2_scores_batched_ref(q8, m, lo))
    q_eo_t = rand((b, 2, d // 2), -8, 8, torch.int8)
    ids = torch.zeros((b, 3), dtype=torch.int32, device=cuda_device)
    ids[:, 1] = 517 // 64
    assert torch.equal(
        stage1_int4_gather(q_eo_t, plane, ids, block_rows=64),
        ref.stage1_gather_batched_ref(q_eo_t, plane, ids, 64))
    got = fused_topk_batched(q_eo_t, plane, k=3, block_n=100)
    want = ref.fused_topk_batched_ref(q_eo_t, plane, 100, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,br,d,n", [(1, 64, 512, 1000), (3, 8, 200, 777),
                                      (33, 32, 64, 4099), (8, 64, 40, 300),
                                      (3, 128, 512, 777), (33, 256, 64, 4099),
                                      (32, 64, 512, 20000), (5, 64, 36, 700)])
def test_gather_kernels_match_plain(cuda_device, b, br, d, n):
    """Both gather kernels (the stage-1 gather on the route its launcher
    names for the shape: TMA at D/2 % 16 == 0 and block_rows % 64 == 0,
    else dp4a; and the sign gather) over a ragged plane whose last block
    reads past N, against their plain versions; the resident forms over a
    plane of whole blocks."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * n + d)
    codes = torch.randint(-128, 128, (n, d), generator=gen,
                          device=cuda_device, dtype=torch.int8)
    db = BitPlanarDB.from_quantized(build_database(codes.float(),
                                                   device=cuda_device))
    q = torch.randint(-128, 128, (b, d), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    nb = -(-n // br)
    ids = torch.randint(0, nb, (b, 7), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    ids[:, -1] = nb - 1
    ops.reset_launch_counts()
    q_eo = ops.pack_queries_even_odd(q >> 4)
    q_sign = ops.pack_query_signs(q)
    assert torch.equal(
        stage1_int4_gather(q_eo, db.msb_plane, ids, block_rows=br),
        ref.stage1_gather_batched_ref(q_eo, db.msb_plane, ids, br))
    if db.sign_plane is not None:
        assert torch.equal(
            stage0_sign_gather(q_sign, db.sign_plane, ids, block_rows=br),
            ref.stage0_sign_gather_ref(q_sign, db.sign_plane, ids, br))
    whole = (n // br) * br
    ids_w = torch.clamp(ids, max=n // br - 1)
    assert torch.equal(
        ops.stage1_scores_gather_resident(q >> 4, db.msb_plane[:whole],
                                          ids_w, block_rows=br),
        ref.stage1_gather_resident_ref(q_eo, db.msb_plane[:whole], ids_w, br))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    tma = stage1_gather._tma_takes(n, d // 2, br)
    assert (br % 64 == 0 and d % 32 == 0) == tma
    if tma:
        assert (counts["stage1_gather"], counts["stage1_gather_resident"],
                counts["stage1_gather_dp4a"]) == (1, 1, 0)
    else:
        assert (counts["stage1_gather"], counts["stage1_gather_resident"],
                counts["stage1_gather_dp4a"]) == (0, 0, 2)
    assert counts["stage0_sign_gather"] == (db.sign_plane is not None)
    assert counts["stage0_sign_gather_resident"] == 0


@pytest.mark.gpu
def test_gather_route_by_shape(cuda_device):
    """The TMA gather's launcher takes D/2 % 16 == 0, block_rows a
    multiple of 64 and 0 < N < 2^31, whatever B and J, and answers no for
    every other shape (those go to the dp4a gather_kernel); the wrapper
    launches the kernel it names, and refuses to force the TMA kernel on a
    shape it does not take."""
    takes = stage1_gather._tma_takes
    assert takes(1 << 20, 256, 64)
    assert takes(1, 16, 64) and takes(4099, 32, 256) and takes(77, 768, 512)
    assert takes((1 << 31) - 1, 256, 64)
    assert not takes(1 << 31, 256, 64)
    assert not takes(0, 256, 64)
    for d2 in (4, 18, 20, 100, 125, 8):
        assert not takes(1000, d2, 64)
    for br in (1, 8, 32, 96, 100):
        assert not takes(1000, 256, br)
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(11),
                 cuda_device)
    for n, d2, br, b in ((1000, 256, 64, 32), (1000, 256, 32, 3),
                         (1000, 100, 64, 3), (300, 16, 128, 1),
                         (1000, 18, 64, 33)):
        plane = rand((n, d2), 0, 256, torch.uint8)
        q_eo = rand((b, 2, d2), -8, 8, torch.int8)
        ids = rand((b, 4), 0, -(-n // br), torch.int32)
        ops.reset_launch_counts()
        got = stage1_int4_gather(q_eo, plane, ids, block_rows=br)
        torch.cuda.synchronize()
        key = "stage1_gather" if takes(n, d2, br) else "stage1_gather_dp4a"
        assert ops.launch_counts() == dict(ZERO_COUNTS, **{key: 1})
        assert torch.equal(got, ref.stage1_gather_batched_ref(q_eo, plane,
                                                              ids, br))
    q_eo = torch.zeros((2, 2, 18), dtype=torch.int8, device=cuda_device)
    plane = torch.zeros((100, 18), dtype=torch.uint8, device=cuda_device)
    ids = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="does not take N = 100, D/2 = 18"):
        stage1_gather._gather(q_eo, plane, ids, 64, route="tma")


def _shared_ids(rand, b: int, j: int, nb: int) -> torch.Tensor:
    """(b, j) block ids over nb blocks in which lanes share blocks: lane i
    takes lane i // 2's table rotated by one slot (the same blocks at other
    slots), every third lane repeats lane 0's at the same slots, and the
    last slot is the final, partial block."""
    ids = rand((b, j), 0, nb, torch.int32)
    for i in range(1, b):
        ids[i] = ids[0] if i % 3 == 0 else torch.roll(ids[i // 2], 1)
    ids[:, -1] = nb - 1
    return ids


@pytest.mark.gpu
@pytest.mark.parametrize("br", [64, 128, 256])
@pytest.mark.parametrize("b", [1, 3, 32, 33])
def test_gather_tma_kernel_matches_plain_and_dp4a(cuda_device, br, b):
    """The TMA gather kernel, bit for bit against the
    plain version and the dp4a gather_kernel: a ragged plane whose last
    block is partial (an id on it in every lane; at 128 and 256 rows whole
    64-row pieces lie past N), J = 1 and J = 7, tables in which lanes share
    blocks, widths of one partial slab (D = 32), two slabs (512) and a
    partial last slab (D = 800: 400 bytes a row), the s8 operand's extremes,
    and the resident form over a plane of whole blocks."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(br * b),
                 cuda_device)
    for d in (32, 512, 800):
        n = 40 * br + 17
        nb = -(-n // br)
        plane = rand((n, d // 2), 0, 256, torch.uint8)
        for j in (1, 7):
            q_eo = rand((b, 2, d // 2), -8, 8, torch.int8)
            ids = _shared_ids(rand, b, j, nb)
            want = ref.stage1_gather_batched_ref(q_eo, plane, ids, br)
            dp4a = stage1_gather._gather(q_eo, plane, ids, br, route="dp4a")
            assert torch.equal(dp4a, want), (d, j)
            ops.reset_launch_counts()
            got = stage1_gather._gather(q_eo, plane, ids, br, route="tma")
            torch.cuda.synchronize()
            assert ops.launch_counts()["stage1_gather"] == 1
            assert torch.equal(got, want), (d, j)
        whole = plane[: (n // br) * br]
        ids_w = torch.clamp(ids, max=n // br - 1)
        q = rand((b, d), -128, 128, torch.int8)
        assert torch.equal(
            ops.stage1_scores_gather_resident(q >> 4, whole, ids_w,
                                              block_rows=br),
            ref.stage1_gather_resident_ref(ops.pack_queries_even_odd(q >> 4),
                                           whole, ids_w, br))
    plane = torch.full((3 * br, 256), 0x88, dtype=torch.uint8,
                       device=cuda_device)
    ids = torch.tensor([[2, 0, 1]] * b, dtype=torch.int32, device=cuda_device)
    for fill in (-8, 7):
        q_eo = torch.full((b, 2, 256), fill, dtype=torch.int8,
                          device=cuda_device)
        got = stage1_gather._gather(q_eo, plane, ids, br, route="tma")
        assert int(got[0, 0]) == 2 * 256 * (-8) * fill
        assert torch.equal(got, stage1_gather._gather(q_eo, plane, ids, br,
                                                      route="dp4a"))


@pytest.mark.gpu
def test_gather_tma_kernel_at_the_cluster_shape(cuda_device):
    """B = 32 lanes x 128 blocks of 64 rows over a 2^20 x 512 plane, laid
    out as the cluster path lays them (8 probed clusters of 16 blocks per
    lane, some clusters probed by several lanes), and the same tables
    over a plane of N = 2^20 - 40 rows whose last block is partial: TMA
    = dp4a = plain."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(2025),
                 cuda_device)
    n, d2 = 1 << 20, 256
    plane = rand((n, d2), 0, 256, torch.uint8)
    q_eo = rand((32, 2, d2), -8, 8, torch.int8)
    picks = rand((32, 8), 0, 1024, torch.int64)
    picks[1::4] = picks[0::4]
    ids = (picks[:, :, None] * 16 + torch.arange(16, device=cuda_device)
           ).reshape(32, 128).to(torch.int32)
    for rows in (n, n - 40):
        p = plane[:rows]
        want = ref.stage1_gather_batched_ref(q_eo, p, ids, 64)
        assert torch.equal(stage1_gather._gather(q_eo, p, ids, 64,
                                                 route="dp4a"), want)
        assert torch.equal(stage1_gather._gather(q_eo, p, ids, 64,
                                                 route="tma"), want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 256, 512, 768, 1024, 1280, 2048])
@pytest.mark.parametrize("b,j", [(3, 150), (32, 64)])
def test_gather_tma_first_fill_at_every_slab_count(cuda_device, d, b, j):
    """The TMA gather's producer requests the ring's first fill one lane
    per box (16 items of one 128-byte slab, 8 of two, 4 of three or four)
    and every later item from one lane; rows of five or more slabs skip
    the first fill. At 1 to 8 slabs a row, with few items a block (3
    lanes x 150 blocks: the first fill and a few more) and many (32 x
    64), the kernel equals the plain version on the (B, D) query and on
    the [even; odd] panels, which the wrapper interleaves back."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(d + b),
                 cuda_device)
    n = 64 * 300 + 40
    plane = rand((n, d // 2), 0, 256, torch.uint8)
    q = rand((b, d), -128, 128, torch.int8) >> 4
    ids = rand((b, j), 0, -(-n // 64), torch.int32)
    q_eo = ops.pack_queries_even_odd(q)
    want = ref.stage1_gather_batched_ref(q_eo, plane, ids, 64)
    assert torch.equal(stage1_gather._gather(q, plane, ids, 64,
                                             route="tma"), want)
    assert torch.equal(stage1_gather._gather(q_eo, plane, ids, 64,
                                             route="tma"), want)


@pytest.mark.gpu
def test_resident_gather_at_the_serving_shape(cuda_device):
    """#6 at the warm serving run's resident shape: a combined plane of
    2^20 arena rows and 2010 slab blocks of 64 rows (D = 512), B = 32
    lanes of 32 block ids, half in each region. The TMA kernel (through
    the resident and the plane-gather wrappers on the (B, D) query, and
    through `stage1_int4_gather` on the [even; odd] panels) and the dp4a
    kernel equal the plain version bit for bit, each counted under its
    key."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(2010),
                 cuda_device)
    br, nb, slots = 64, (1 << 20) // 64, 2010
    comb = rand(((nb + slots) * br, 256), 0, 256, torch.uint8)
    ids = torch.cat([rand((32, 16), 0, nb, torch.int32),
                     rand((32, 16), nb, nb + slots, torch.int32)], dim=1)
    q = rand((32, 512), -128, 128, torch.int8) >> 4
    q_eo = ops.pack_queries_even_odd(q)
    want = ref.stage1_gather_resident_ref(q_eo, comb, ids, br)
    ops.reset_launch_counts()
    for got in (ops.stage1_scores_gather_resident(q, comb, ids,
                                                  block_rows=br),
                ops.stage1_scores_gather(q, comb, ids, block_rows=br),
                stage1_int4_gather(q_eo, comb, ids, block_rows=br),
                stage1_gather._gather(q, comb, ids, br, route="dp4a")):
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(ZERO_COUNTS, stage1_gather_resident=1,
                                       stage1_gather=2, stage1_gather_dp4a=1)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [131072, (1 << 17) + 64, 349526])
def test_mma_plane_kernel_at_shard_rows(cuda_device, n):
    """#1 on the tensor-core kernel at one shard's rows (2^20 over 8 and
    over 3 slots, and 2^17 + 64, whose last tile is partial at every
    tile), B = 32, at every tile the kernel takes: equal to the plain
    version bit for bit, one launch counted each."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(n),
                 cuda_device)
    panel = rand((2, 32, 256), -8, 8, torch.int8)
    plane = rand((n, 256), 0, 256, torch.uint8)
    want = ref.stage1_scores_batched_ref(panel, plane)
    for rows in ROWS_CHOICES:
        ops.reset_launch_counts()
        assert torch.equal(stage1_int4._plane(panel, plane, rows,
                                              route="mma"), want), rows
        assert ops.launch_counts()["stage1_plane_mma"] == 1


@pytest.mark.gpu
def test_plane_maps_follow_the_plane(cuda_device):
    """The launchers keep tensor maps by (plane address, N, D/2, box
    rows). A plane is freed and one of another N allocated (the allocator
    hands the same address back where it can), one of the first N again,
    then two shard planes in turns: every plane scan and TMA gather equals
    the plain version, so no launch reads through a stale map."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(64),
                 cuda_device)
    q = rand((32, 512), -8, 8, torch.int8)
    panel, q_eo = ops.pack_query_panel(q), ops.pack_queries_even_odd(q)

    def check(plane):
        n = plane.shape[0]
        assert torch.equal(stage1_int4_batched(panel, plane),
                           ref.stage1_scores_batched_ref(panel, plane)), n
        ids = rand((32, 8), 0, -(-n // 64), torch.int32)
        assert torch.equal(ops.stage1_scores_gather(q, plane, ids,
                                                    block_rows=64),
                           ref.stage1_gather_batched_ref(q_eo, plane, ids,
                                                         64)), n
    addresses = []
    for n in (64 * 700, 64 * 500 + 17, 64 * 700):
        plane = rand((n, 256), 0, 256, torch.uint8)
        addresses.append(plane.data_ptr())
        check(plane)
        del plane
    a = rand((131072, 256), 0, 256, torch.uint8)
    b = rand((131072, 256), 0, 256, torch.uint8)
    for _ in range(3):
        check(a)
        check(b)
    print(f"plane addresses {addresses}: "
          f"{len(set(addresses))} distinct")


def _sign_case(rand, b, group, n, d, br, j):
    """q_sign (b, d) +-1, an (n, d/8) sign plane and a (b / group, j) table
    over its blocks in which the last slot of every row is the final
    (possibly partial) block, one slot of row 0 lies wholly past N and
    tables share blocks."""
    q_sign = ops.pack_query_signs(rand((b, d), -128, 128, torch.int8))
    plane = rand((n, d // 8), 0, 256, torch.uint8)
    nb = -(-n // br)
    ids = _shared_ids(rand, b // group, j, nb)
    if j > 1:
        ids[0, 0] = nb + 3
    return q_sign, plane, ids


# (lanes, group, N, D, BR, J): the decode prescreen's widths (hd 32, 64,
# 128 in 16-row pages, 7 query heads per KV head, 3 x 2 KV lanes), the
# serving path's resident and the cluster path's shapes (D = 512, 64-row
# blocks), and ragged planes whose last block straddles N (N % BR rows of
# a 16-byte multiple); rows of 32 and 128 bytes (D = 256, 1024).
SIGN_BULK_SHAPES = [(42, 7, 6 * 1024, 32, 16, 40),
                    (42, 7, 6 * 1024, 64, 16, 40),
                    (42, 7, 6 * 1024, 128, 16, 40),
                    (32, 1, 1 << 16, 512, 64, 32),
                    (32, 1, 1 << 16, 512, 64, 128),
                    (33, 1, 64 * 50 + 16, 512, 64, 7),
                    (14, 7, 16 * 30 + 2, 64, 16, 9),
                    (6, 3, 16 * 20 + 1, 128, 16, 5),
                    (8, 2, 64 * 20 + 8, 256, 64, 6),
                    (3, 1, 32 * 10 + 4, 1024, 32, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,group,n,d,br,j", SIGN_BULK_SHAPES)
def test_sign_bulk_kernel_matches_plain_and_popc(cuda_device, b, group, n,
                                                 d, br, j):
    """The bulk sign gather, bit for bit against the plain version, the
    popcount kernel and its own per-lane form (the table repeated
    `group` times), each launch counted once under `stage0_sign_gather`
    whatever the route; the launcher chooses it (answers 2) for rows of
    at most 16 bytes and only takes it (1) for wider rows."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(n + d + j),
                 cuda_device)
    q_sign, plane, ids = _sign_case(rand, b, group, n, d, br, j)
    assert stage0_sign._bulk_takes(plane.data_ptr(), n, d // 8, br,
                                   group) == (2 if d <= 128 else 1)
    want = ref.stage0_sign_gather_ref(q_sign, plane, ids, br, group=group)
    lane_ids = ids.repeat_interleave(group, 0)
    for route, table, g in (("bulk", ids, group), ("popc", ids, group),
                            ("bulk", lane_ids, 1), ("auto", ids, group)):
        ops.reset_launch_counts()
        got = stage0_sign_gather(q_sign, plane, table, block_rows=br,
                                 group=g, route=route)
        torch.cuda.synchronize()
        assert ops.launch_counts() == dict(ZERO_COUNTS,
                                           stage0_sign_gather=1)
        assert torch.equal(got, want), (route, g)
    sums = q_sign.sum(1, dtype=torch.int32)
    if j > 1:
        assert torch.equal(want[:group, :br], sums[:group, None].expand(
            group, br))
    past = n % br
    if past:
        assert torch.equal(want[:, -br + past:], sums[:, None].expand(
            b, br - past))


@pytest.mark.gpu
def test_sign_gather_route_by_shape(cuda_device):
    """The bulk sign gather's launcher takes rows of 4, 8, 16 bytes (BR %
    4 == 0) or 32, 64, 128 bytes, whole 16-byte units per block and per
    straddling block, a 16-byte aligned plane, 0 < N < 2^31 and a ring and
    packed signs that fit in shared memory, and refuses every other shape,
    which the popcount kernel takes; it chooses itself (2) for rows of at
    most 16 bytes and leaves wider ones to the popcount kernel (1). The
    wrapper launches the kernel its launcher names, "bulk" on an answer of
    1 too, each under the caller's counter, and refuses to force the bulk
    kernel on a shape it does not take."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(12),
                 cuda_device)
    base = rand((1 << 12, 64), 0, 256, torch.uint8)
    ptr = base.data_ptr()
    takes = stage0_sign._bulk_takes
    assert takes(ptr, 1 << 20, 64, 64, 1) == 1
    assert takes(ptr, 524288, 8, 16, 7) == 2
    assert takes(ptr, (1 << 31) - 16, 4, 16, 1) and takes(ptr, 100, 128, 1, 1)
    assert not takes(ptr, 1 << 31, 8, 16, 1) and not takes(ptr, 0, 8, 16, 1)
    assert not takes(ptr + 8, 1000, 64, 64, 1)
    assert not takes(ptr, 1000, 5, 8, 1)         # 40-byte blocks
    assert not takes(ptr, 16 * 9 + 2, 5, 16, 1)  # 10 bytes past the end
    assert not takes(ptr, 1000, 32768, 8, 1)     # rows of 4 KiB
    assert not takes(ptr, 1000, 48, 64, 1)       # rows of 48 bytes
    assert not takes(ptr, 1000, 8, 6, 1)         # BR % 4 != 0 at 8 bytes
    assert not takes(ptr, 1000, 64, 64, 1 << 14)  # 16384 lanes' signs
    for n, d, br, group, bulk in ((1000, 64, 16, 7, 2),
                                  (1000, 40, 8, 1, 0),
                                  (16 * 9 + 2, 40, 16, 1, 0),
                                  (16 * 9 + 2, 64, 16, 1, 2),
                                  (1000, 384, 64, 1, 0),
                                  (1000, 512, 64, 1, 1)):
        q_sign, plane, ids = _sign_case(rand, 2 * group, group, n, d, br, 4)
        assert takes(plane.data_ptr(), n, d // 8, br, group) == bulk
        for counter, fn in (
                ("stage0_sign_gather", lambda: stage0_sign_gather(
                    q_sign, plane, ids, block_rows=br, group=group)),
                ("stage0_sign_gather_resident",
                 lambda: stage0_sign_gather(
                     q_sign, plane, ids, block_rows=br, group=group,
                     counter="stage0_sign_gather_resident"))):
            ops.reset_launch_counts()
            got = fn()
            torch.cuda.synchronize()
            assert ops.launch_counts() == dict(ZERO_COUNTS, **{counter: 1})
            assert torch.equal(got, ref.stage0_sign_gather_ref(
                q_sign, plane, ids, br, group=group))
        if not bulk:
            with pytest.raises(ValueError, match="bulk sign gather does not "
                                                 f"take N = {n}, D = {d}"):
                stage0_sign_gather(q_sign, plane, ids, block_rows=br,
                                   group=group, route="bulk")
        else:
            ops.reset_launch_counts()
            assert torch.equal(stage0_sign_gather(
                q_sign, plane, ids, block_rows=br, group=group,
                route="bulk"), got)
            assert ops.launch_counts() == dict(ZERO_COUNTS,
                                               stage0_sign_gather=1)
    q_sign = torch.ones((6, 64), dtype=torch.int8, device=cuda_device)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    plane = base.view(-1, 8)
    with pytest.raises(ValueError, match="group 4 does not divide the 6"):
        stage0_sign_gather(q_sign, plane, ids, block_rows=16, group=4)
    with pytest.raises(ValueError, match="block_ids has 2 rows"):
        stage0_sign_gather(q_sign, plane, ids, block_rows=16, group=2)


@pytest.mark.gpu
@pytest.mark.parametrize("c0", [None, 256])
def test_cluster_backend_equals_plain_backend(cuda_device, c0):
    docs, queries, _ = retrieval_corpus(4096, 256, num_queries=24, seed=7,
                                        cluster_size=64)
    db = BitPlanarDB.from_quantized(build_database(docs, device=cuda_device))
    q, _ = quantize_int8(torch.from_numpy(queries).to(cuda_device),
                         per_vector=True)
    labels = (np.arange(4096) // 64).astype(np.int32)
    cents, _ = quantize_int8(torch.from_numpy(np.stack(
        [docs[labels == c].mean(0) for c in range(64)])))
    cb = clustering.ClusterCodebook.from_codes(cents, device=cuda_device)
    table = clustering.block_table(labels, 64, 64)
    ops.reset_launch_counts()
    for metric in ("cosine", "mips"):
        runs = [cluster_pruned_retrieve(
            q, db, cb, table, labels,
            RetrievalConfig(metric=metric, prescreen_c0=c0, backend=backend),
            nprobe=8, block_rows=64, device=cuda_device)
            for backend in ("cuda", "torch")]
        for field in ("indices", "scores", "candidate_indices"):
            assert torch.equal(getattr(runs[0], field),
                               getattr(runs[1], field))
    counts = ops.launch_counts()
    assert (counts["stage1_plane_mma"] == 2
            and counts["stage2_rerank_by_id"] == 2)
    assert counts["stage1_plane"] == counts["stage2_exact"] == 0
    assert counts["stage2_by_id"] == 0
    if c0 is None:
        assert counts["stage1_gather"] == 2
        assert counts["stage0_sign_gather"] == 0
    else:
        assert counts["stage0_sign_gather"] == 2
        assert counts["stage1_rows"] == 2


def _rand(gen, dev):
    def rand(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)
    return rand


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,block,k", [(4, 512, 256, 128, 8),
                                           (3, 250, 64, 32, 20),
                                           (33, 1000, 512, 512, 8),
                                           (1, 200, 36, 8, 12)])
def test_fused_kernel_matches_plain(cuda_device, b, n, d, block, k):
    """The fused kernel, masked (with a padding lane and a fully masked
    block) and unmasked, at ragged N, k above block_n and k above a
    lane's live rows, against its plain version; the single-query form
    too."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(n + k),
                 cuda_device)
    q_eo = rand((b, 2, d // 2), -8, 8, torch.int8)
    plane = rand((n, d // 2), 0, 256, torch.uint8)
    owner = rand((n,), 0, 3, torch.int32)
    owner[:block] = -1
    owner[owner == 1] = 2
    owner[block + 3] = 1
    tids = rand((b,), 0, 3, torch.int32)
    tids[-1] = -1
    ops.reset_launch_counts()
    got = fused_topk_batched(q_eo, plane, owner, tids, k=k, block_n=block)
    want = ref.fused_topk_batched_ref(q_eo, plane, block, k, owner, tids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[0][-1] == INT32_MIN).all())
    got = fused_topk_batched(q_eo, plane, k=k, block_n=block)
    want = ref.fused_topk_batched_ref(q_eo, plane, block, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = fused_topk_single(q_eo[0], plane, k=k, block_n=block)
    want = ref.fused_topk_ref(q_eo[0], plane, block, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    batched = ("fused_topk_mma"
               if fused_topk._fused_mma_lanes(b, d // 2, block, k)
               else "fused_topk")
    assert ops.launch_counts() == dict(ZERO_COUNTS, fused_topk_single=1,
                                       **{batched: 2})


@pytest.mark.gpu
def test_fused_mma_lane_tile_by_shape(cuda_device):
    """The tensor-core fused launcher takes B >= 2, D/2 % 16 == 0 and
    block_n of 128, 256, 512, 1024 with the smallest of 8, 16, 32 lanes that
    covers B (16 at most at block_n = 1024), shrunk until a block's ring,
    panels and key tile fit in shared memory, and answers 0 for every other
    shape; the wrapper launches the kernel it names."""
    lanes = fused_topk._fused_mma_lanes
    assert lanes(1, 256, 512, 8) == 0
    assert lanes(2, 256, 512, 8) == 8
    assert lanes(9, 256, 512, 8) == 16
    assert lanes(32, 256, 512, 8) == 32
    assert lanes(33, 256, 512, 8) == 32
    assert lanes(33, 256, 1024, 8) == 16
    assert lanes(32, 512, 512, 8) == 16      # D = 1024: 32 lanes do not fit
    assert lanes(32, 256, 512, 0) == 0
    assert lanes(32, 18, 512, 8) == 0
    for block in (64, 100, 2048):
        assert lanes(32, 256, block, 8) == 0
    assert lanes(32, 1 << 16, 128, 8) == 0   # panels past shared memory
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(7),
                 cuda_device)
    plane = rand((1000, 256), 0, 256, torch.uint8)
    for b, block in ((1, 512), (2, 512), (32, 512), (32, 100), (9, 1024)):
        q_eo = rand((b, 2, 256), -8, 8, torch.int8)
        ops.reset_launch_counts()
        fused_topk_batched(q_eo, plane, k=8, block_n=block)
        key = "fused_topk_mma" if lanes(b, 256, block, 8) else "fused_topk"
        assert ops.launch_counts() == dict(ZERO_COUNTS, **{key: 1})
    q_eo = torch.zeros((4, 2, 9), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="does not take B = 4, D/2 = 9"):
        fused_topk._fused(q_eo, plane[:, :9].contiguous(), None, None, 8, 512,
                          route="mma")


FUSED_MMA_BATCHES = (2, 9, 32, 33)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 256, 512, 1024])
@pytest.mark.parametrize("d", [32, 512, 1024])
def test_fused_mma_kernel_matches_plain_and_dp4a(cuda_device, block, d):
    """The tensor-core fused kernel, bit-exact against the plain version and
    the dp4a kernel on the same inputs, masked (a lane with tid < 0, a fully
    masked block, a tenant with 3 rows) and unmasked, at every lane tile and
    padding lanes (B = 2, 9, 32, 33), one and several slabs (D = 32, 512,
    1024), ragged N (N % block_n != 0, N % 4 != 0, N below one block) and
    k of 1, 8, 50 and above block_n."""
    gen = torch.Generator(device=cuda_device).manual_seed(block + d)
    rand = _rand(gen, cuda_device)
    for n in (3 * block + 1, block // 2 + 3):
        plane = rand((n, d // 2), 0, 256, torch.uint8)
        owner = rand((n,), 0, 3, torch.int32)
        owner[owner == 1] = 2
        first = block if n > block else 0    # block 0 fully masked
        owner[:first] = -1
        owner[first + torch.randperm(n - first, generator=gen,
                                     device=cuda_device)[:3]] = 1
        for b in FUSED_MMA_BATCHES:
            q_eo = rand((b, 2, d // 2), -8, 8, torch.int8)
            tids = rand((b,), 0, 3, torch.int32)
            tids[-1] = -1
            tids[0] = 1
            for k in (1, 8, 50, block + 3):
                assert fused_topk._fused_mma_lanes(b, d // 2, block, k)
                for mask in ((), (owner, tids)):
                    ops.reset_launch_counts()
                    got = fused_topk._fused(q_eo, plane, *(mask or (None,
                                                                    None)),
                                            k, block, route="mma")
                    torch.cuda.synchronize()
                    assert ops.launch_counts()["fused_topk_mma"] == 1
                    want = ref.fused_topk_batched_ref(q_eo, plane, block, k,
                                                      *mask)
                    dp4a = fused_topk._fused(q_eo, plane,
                                             *(mask or (None, None)), k,
                                             block, route="dp4a")
                    note = (b, n, d, block, k, bool(mask))
                    for g, w, p in zip(got, want, dp4a):
                        assert torch.equal(g, w), note
                        assert torch.equal(g, p), note


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 256, 512, 1024])
def test_fused_mma_kernel_near_the_key_limit(cuda_device, block):
    """At the widest D the launcher takes for each block_n (|score| up to
    64 * D, so the 32-bit keys come nearest their limit): all-(-8)
    nibbles against all-(-8) and all-7 panels (every row ties, so the
    picks are the block's first rows) and random ones, against the plain
    version."""
    d2 = 16
    while fused_topk._fused_mma_lanes(2, d2 + 16, block, 8):
        d2 += 16
    assert fused_topk._fused_mma_lanes(2, d2, block, 8) == 8
    n = 2 * block + 7
    extreme = torch.full((n, d2), 0x88, dtype=torch.uint8,
                         device=cuda_device)
    for fill in (-8, 7):
        q_eo = torch.full((2, 2, d2), fill, dtype=torch.int8,
                          device=cuda_device)
        got = fused_topk._fused(q_eo, extreme, None, None, 8, block,
                                route="mma")
        want = ref.fused_topk_batched_ref(q_eo, extreme, block, 8)
        assert int(want[0][0, 0, 0]) == 2 * d2 * (-8) * fill
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(block),
                 cuda_device)
    plane = rand((n, d2), 0, 256, torch.uint8)
    q_eo = rand((3, 2, d2), -8, 8, torch.int8)
    got = fused_topk._fused(q_eo, plane, None, None, 8, block, route="mma")
    want = ref.fused_topk_batched_ref(q_eo, plane, block, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", [(32, 5000, 512), (1, 777, 40),
                                   (33, 300, 96), (5, 1000, 262144)])
def test_sign_plane_and_single_kernels_match_plain(cuda_device, b, n, d):
    """The dense sign kernel at every read mode (16-byte, word, byte rows)
    and at a wide D, and the single-query stage-1 and stage-2 forms."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(b * n + d),
                 cuda_device)
    n = n if d < 65536 else 40
    ops.reset_launch_counts()
    q_sign = ops.pack_query_signs(rand((b, d), -128, 128, torch.int8))
    sign_plane = rand((n, d // 8), 0, 256, torch.uint8)
    assert torch.equal(stage0_sign_batched(q_sign, sign_plane),
                       ref.stage0_sign_batched_ref(q_sign, sign_plane))
    q_eo = rand((2, d // 2), -8, 8, torch.int8)
    plane = rand((n, d // 2), 0, 256, torch.uint8)
    assert torch.equal(stage1_int4_single(q_eo, plane),
                       ref.stage1_scores_ref(q_eo, plane))
    q8 = rand((2, d // 2), -128, 128, torch.int8)
    lsb = rand((n, d // 2), 0, 256, torch.uint8)
    assert torch.equal(stage2_int8_single(q8, plane, lsb),
                       ref.stage2_scores_ref(q8, plane, lsb))
    torch.cuda.synchronize()
    sign_key = ("stage0_sign_plane_mma"
                if stage0_sign._mma_lanes(b, n, d // 8, DEFAULT_ROWS)
                else "stage0_sign_plane")
    assert ops.launch_counts() == dict(ZERO_COUNTS, stage1_single=1,
                                       stage2_single=1, **{sign_key: 1})


@pytest.mark.gpu
def test_sign_mma_lane_tile_by_shape(cuda_device):
    """The tensor-core sign launcher takes B >= 2, D % 128 == 0 (D/8 % 16
    == 0) and 0 < N < 2^31 with the smallest of 8, 16, 32 lanes that covers
    B (16 at most at 512 rows per tile, 8 at 1024), shrunk until a block's
    ring, eight sub-panels and staging fit in shared memory, and answers 0
    for every other shape (those go to the popcount kernel); the wrapper
    launches the kernel it names, and refuses to force one it answers 0
    for."""
    lanes = stage0_sign._mma_lanes
    assert lanes(1, 1000, 64, 256) == 0
    assert lanes(2, 1000, 64, 256) == 8
    assert lanes(9, 1000, 64, 256) == 16
    assert lanes(32, 1000, 64, 256) == 32
    assert lanes(33, 1000, 64, 256) == 32
    assert lanes(33, 1000, 64, 512) == 16
    assert lanes(33, 1000, 64, 1024) == 8
    assert lanes(32, 1000, 512, 256) == 16     # D = 4096: 32 lanes too wide
    assert lanes(32, 1000, 512, 1024) == 8
    assert lanes(32, 1000, 1 << 11, 256) == 0  # panels past shared memory
    for d8 in (5, 8, 12, 48 + 8):               # D % 128 != 0
        assert lanes(32, 1000, d8, 256) == 0
    for n in (0, 2 ** 31):
        assert lanes(32, n, 64, 256) == 0
    assert lanes(32, 2 ** 31 - 1, 64, 256) == 32
    assert lanes(32, 1000, 64, 64) == 0
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(8),
                 cuda_device)
    plane = rand((1000, 64), 0, 256, torch.uint8)
    for b in (1, 2, 32, 33):
        q_sign = ops.pack_query_signs(rand((b, 512), -128, 128, torch.int8))
        ops.reset_launch_counts()
        got = stage0_sign_batched(q_sign, plane)
        key = ("stage0_sign_plane_mma" if b >= 2 else "stage0_sign_plane")
        assert ops.launch_counts() == dict(ZERO_COUNTS, **{key: 1})
        assert torch.equal(got, ref.stage0_sign_batched_ref(q_sign, plane))
    q_sign = torch.ones((4, 96), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="does not take B = 4, N = 1000, "
                                         "D = 96"):
        stage0_sign._sign_plane(q_sign, plane[:, :12].contiguous(), 256,
                                route="mma")


# B: one lane tile at 8 and 32 lanes, padding lanes in a second tile.
SIGN_MMA_BATCHES = (2, 3, 32, 33)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ROWS_CHOICES)
@pytest.mark.parametrize("d", [128, 384, 512, 640, 1152, 4096])
def test_sign_mma_kernel_matches_plain_and_popc(cuda_device, rows, d):
    """The tensor-core sign kernel, bit-exact against the plain version and
    the popcount kernel on the same +-1 queries, and against the plain
    version on random int8 queries (the s8 floor -128 against an
    all-negative row included), at every rows-per-tile instance, B = 2, 3,
    32, 33, ragged N (below, at and past an m-tile; N % 4 != 0 for the
    16-byte stores) and widths of one half-live chunk (D = 128), partial
    and several slabs (384-1152) and a lane tile that halves (4096)."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(rows + d),
                 cuda_device)
    for n in MMA_ROWS:
        plane = rand((n, d // 8), 0, 256, torch.uint8)
        plane[0] = 0xFF
        for b in SIGN_MMA_BATCHES:
            codes = rand((b, d), -128, 128, torch.int8)
            codes[0] = -128
            q_sign = ops.pack_query_signs(codes)
            assert stage0_sign._mma_lanes(b, n, d // 8, rows)
            ops.reset_launch_counts()
            got = stage0_sign._sign_plane(q_sign, plane, rows, route="mma")
            torch.cuda.synchronize()
            assert ops.launch_counts() == dict(ZERO_COUNTS,
                                               stage0_sign_plane_mma=1)
            note = (b, n, d, rows)
            assert torch.equal(got, ref.stage0_sign_batched_ref(
                q_sign, plane)), note
            assert torch.equal(got, stage0_sign._sign_plane(
                q_sign, plane, rows, route="popc")), note
            got = stage0_sign._sign_plane(codes, plane, rows, route="mma")
            want = ref.stage0_sign_batched_ref(codes, plane)
            assert int(want[0, 0]) == 128 * d
            assert torch.equal(got, want), note


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ROWS_CHOICES)
@pytest.mark.parametrize("b,d", [(32, 512), (3, 200), (1, 36)])
def test_rows_per_block_instances_match_plain(cuda_device, rows, b, d):
    """Every rows-per-block instance of the plane, rows and dense sign
    kernels gives the default's bits."""
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(rows + b),
                 cuda_device)
    panel = rand((2, b, d // 2), -8, 8, torch.int8)
    plane = rand((3001, d // 2), 0, 256, torch.uint8)
    assert torch.equal(stage1_int4_batched(panel, plane, rows=rows),
                       ref.stage1_scores_batched_ref(panel, plane))
    q_eo = rand((b, 2, d // 2), -8, 8, torch.int8)
    win = rand((b, 1100, d // 2), 0, 256, torch.uint8)
    assert torch.equal(stage1_int4_rows(q_eo, win, rows=rows),
                       ref.stage1_rows_batched_ref(q_eo, win))
    if d % 8 == 0:
        q_sign = ops.pack_query_signs(rand((b, d), -128, 128, torch.int8))
        sign_plane = rand((3001, d // 8), 0, 256, torch.uint8)
        assert torch.equal(stage0_sign_batched(q_sign, sign_plane, rows=rows),
                           ref.stage0_sign_batched_ref(q_sign, sign_plane))


@pytest.mark.gpu
def test_autotune_on_the_card(cuda_device):
    """A small search on the card: every entry at >= 1.0x its default, the
    table keyed to this card, and the tuned wrappers bit-identical to the
    default ones."""
    table = autotune.autotune(n=1 << 14, d=256, batches=(1, 8), reps=2,
                              device=cuda_device)
    assert table.signature["device_kind"] == torch.cuda.get_device_name(
        cuda_device)
    assert table.signature["backend"] == "torch-cuda"
    for e in table.entries.values():
        assert e["speedup_vs_default"] >= 1.0
        if e["kernel"] != "fused_topk":
            assert "2048" in e["left_out"]
    rand = _rand(torch.Generator(device=cuda_device).manual_seed(1),
                 cuda_device)
    q = rand((8, 256), -8, 8, torch.int8)
    plane = rand((1 << 14, 128), 0, 256, torch.uint8)
    base = ops.stage1_scores_batched(q, plane)
    cand = ops.fused_candidates_batched(q, plane, c=16, k_per_block=16)
    autotune.install(table)
    try:
        assert torch.equal(ops.stage1_scores_batched(q, plane), base)
        assert torch.equal(ops.fused_candidates_batched(
            q, plane, c=16, k_per_block=16), cand)
    finally:
        autotune.clear_installed()


def _tenant_indices(cuda_device, **kw):
    return [MultiTenantIndex(1024, 64, RetrievalConfig(k=3), device=dev,
                             **kw) for dev in (cuda_device, "cpu")]


def _same_state(gpu, cpu):
    for name in ("msb_plane", "lsb_plane", "sign_plane", "norms_sq",
                 "owner"):
        assert torch.equal(getattr(gpu.arena, name).cpu(),
                           getattr(cpu.arena, name)), name
    assert np.array_equal(gpu.arena.cluster_labels, cpu.arena.cluster_labels)
    assert gpu.arena.generation == cpu.arena.generation


def _same_batch(gpu, cpu, q, tids, kind):
    res = [idx.retrieve(q, tids) for idx in (gpu, cpu)]
    assert gpu.last_plan == cpu.last_plan and gpu.last_plan.kind == kind
    for field in ("indices", "scores", "candidate_indices"):
        assert torch.equal(getattr(res[0], field).cpu(),
                           getattr(res[1], field)), field


@pytest.mark.gpu
@pytest.mark.parametrize("clustered", [False, True])
def test_multi_tenant_index_on_the_card_matches_the_cpu(cuda_device,
                                                        clustered):
    """Interleaved ingests (masked), deletes, then compaction (windowed or
    the cluster cascade): the index on the card gives the CPU index's
    state and results bit for bit after every step."""
    kw = (dict(clusters=clustering.ClusterParams(4, nprobe=2, block_rows=64))
          if clustered else {})
    gpu, cpu = _tenant_indices(cuda_device, **kw)
    docs, queries, gold = retrieval_corpus(
        240, 64, num_queries=12, seed=4, noise=0.05,
        cluster_size=20 if clustered else 1)
    tenant = np.arange(240) // 20 % 4
    for lo in range(0, 240, 20):              # 12 runs: 3 per tenant
        for idx in (gpu, cpu):
            idx.ingest(int(tenant[lo]), docs[lo:lo + 20])
        _same_state(gpu, cpu)
    q, _ = quantize_int8(torch.from_numpy(queries), per_vector=True)
    tids = tenant[gold].astype(np.int32)
    _same_batch(gpu, cpu, q.numpy(), tids, "cluster" if clustered
                else "masked")
    for t in range(4):
        victims = cpu.table.slots(t)[::7]
        for idx in (gpu, cpu):
            idx.delete(t, victims)
        _same_state(gpu, cpu)
    assert np.array_equal(gpu.compact(), cpu.compact())
    _same_state(gpu, cpu)
    _same_batch(gpu, cpu, q.numpy(), tids, "cluster" if clustered
                else "windowed")
    one = [idx.retrieve(q[0].numpy(), int(tids[0])) for idx in (gpu, cpu)]
    assert torch.equal(one[0].indices.cpu(), one[1].indices)
    assert gpu.arena.stats.rebuilds == 0


@pytest.mark.gpu
@pytest.mark.parametrize("cache_bytes", [0, 1 << 20])
def test_serving_runtime_on_the_card_matches_the_cpu(cuda_device,
                                                     cache_bytes):
    """`ServingRuntime` over a clustered index on the card and on the CPU,
    cold (no cache: `index.retrieve`) and warm (a slab that holds every
    view: the `SlabPolicy` path, the sign prescreen on in the last turn):
    the same launches, results, ledgers and cache counters, turn for
    turn. The warm runtime's turns launch only the resident TMA gather
    and, with the prescreen, only the resident sign gather; the cold
    runtime's only the plane gathers."""
    kw = dict(clusters=clustering.ClusterParams(4, nprobe=2, block_rows=64))
    gpu, cpu = _tenant_indices(cuda_device, **kw)
    docs, queries, gold = retrieval_corpus(240, 64, num_queries=8, seed=6,
                                           noise=0.05, cluster_size=20)
    tenant = np.arange(240) // 20 % 4
    for lo in range(0, 240, 20):
        for idx in (gpu, cpu):
            idx.ingest(int(tenant[lo]), docs[lo:lo + 20])
    for idx in (gpu, cpu):
        idx.compact()
    q, _ = quantize_int8(torch.from_numpy(queries), per_vector=True)
    q = q.numpy()
    tids = tenant[gold]
    rts = [ServingRuntime(idx, RuntimeConfig(
        max_batch=8, cache_bytes=cache_bytes, auto_flush=False))
        for idx in (gpu, cpu)]
    for turn in range(4):
        if turn == 3:
            for idx in (gpu, cpu):
                idx.cfg = dataclasses.replace(idx.cfg, prescreen_c0=64)
        ops.reset_launch_counts()
        handles = [[rt.submit(int(tids[i]), q[i], now=float(turn))
                    for i in range(len(tids))] for rt in rts]
        for rt in rts:
            rt.flush()
        counts = ops.launch_counts()
        for hg, hc in zip(*handles, strict=True):
            assert hg.launch_index == hc.launch_index
            for field in ("indices", "scores", "candidate_indices"):
                assert torch.equal(getattr(hg.result(), field),
                                   getattr(hc.result(), field)), field
        for name in ("launches", "stage1_bytes_streamed",
                     "stage1_bytes_sram", "prefetch_bytes", "stage_bytes",
                     "stage_bytes_sram", "last_plan"):
            assert getattr(rts[0], name) == getattr(rts[1], name), name
        assert rts[0].cache_stats() == rts[1].cache_stats()
        resident = ("stage1_gather_resident", "stage0_sign_gather_resident")
        plane = ("stage1_gather", "stage0_sign_gather")
        on, off = (resident, plane) if cache_bytes else (plane, resident)
        assert counts[on[turn == 3]] >= 1
        assert counts[off[0]] == counts[off[1]] == 0
    if cache_bytes:
        assert rts[0].cache_stats()["hits"] > 0
        assert rts[0].cache.slab_plane.is_cuda


@pytest.mark.gpu
def test_tiered_serving_runtime_on_the_card_matches_the_cpu(cuda_device):
    """The precision-tier cache under a four-slot budget on the card and on
    the CPU, prescreen on: the same results, ledgers, tier counters and
    `block_tier` sidecar, turn for turn, with demotions and promotions."""
    kw = dict(clusters=clustering.ClusterParams(4, nprobe=2, block_rows=64))
    gpu, cpu = _tenant_indices(cuda_device, **kw)
    docs, queries, gold = retrieval_corpus(240, 64, num_queries=8, seed=6,
                                           noise=0.05, cluster_size=20)
    tenant = np.arange(240) // 20 % 4
    for lo in range(0, 240, 20):
        for idx in (gpu, cpu):
            idx.ingest(int(tenant[lo]), docs[lo:lo + 20])
    for idx in (gpu, cpu):
        idx.compact()
        idx.cfg = dataclasses.replace(idx.cfg, prescreen_c0=64)
    q, _ = quantize_int8(torch.from_numpy(queries), per_vector=True)
    q = q.numpy()
    tids = tenant[gold]
    rts = [ServingRuntime(idx, RuntimeConfig(
        max_batch=8, cache_bytes=4 * 64 * 32, precision_tiers=True,
        auto_flush=False)) for idx in (gpu, cpu)]
    for turn in range(4):
        handles = [[rt.submit(int(tids[i]), q[i], now=float(turn))
                    for i in range(len(tids))] for rt in rts]
        for rt in rts:
            rt.flush()
        for hg, hc in zip(*handles, strict=True):
            for field in ("indices", "scores", "candidate_indices"):
                assert torch.equal(getattr(hg.result(), field),
                                   getattr(hc.result(), field)), field
        for name in ("stage1_bytes_streamed", "stage1_bytes_sram",
                     "stage_bytes", "stage_bytes_sram", "last_plan"):
            assert getattr(rts[0], name) == getattr(rts[1], name), name
        assert rts[0].cache_stats() == rts[1].cache_stats()
        assert torch.equal(rts[0].cache.block_tier.cpu(),
                           rts[1].cache.block_tier)
    stats = rts[0].cache_stats()
    assert stats["promotions"] > 0 and stats["sign_entries"] > 0


def _decode_cache(dev, b, t, kh, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(b, t, kh, hd, generator=gen, device=dev)
    v = torch.randn(b, t, kh, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    return sparse_kv.build_quant_cache(k, v), gen


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_decode_widths_of_rows_and_sign_gather(cuda_device, hd):
    """#2 over per-lane page-centroid rows of hd/2 bytes and #8 over the
    flat cache sign plane of hd/8 bytes in page blocks (the widths the
    decode stages give them), per lane and grouped by KV head (one table
    row for the G = 7 query heads), against their plain versions."""
    b, t, kh, g, pr = 3, 1024, 2, 7, 16
    cache, gen = _decode_cache(cuda_device, b, t, kh, hd, hd)
    lanes, p = b * kh * g, t // pr
    cache = sparse_kv.build_page_centroids(
        cache, torch.full((b,), t, device=cuda_device), pr)
    q = torch.randint(-128, 128, (lanes, hd), generator=gen,
                      device=cuda_device, dtype=torch.int8)
    rows = (cache.cent_msb.transpose(1, 2)[:, :, None]
            .expand(b, kh, g, p, hd // 2).reshape(lanes, p, hd // 2)
            .contiguous())
    ops.reset_launch_counts()
    got = ops.centroid_scores_rows(q, rows)
    assert torch.equal(got, ref.centroid_scores_rows_ref(
        ops.pack_queries_even_odd(q), rows))
    flat = bitplanar.sign_plane_from_msb(
        cache.k_msb.transpose(1, 2).reshape(b * kh * t, hd // 2))
    ids = torch.randint(0, b * kh * p, (lanes, 40), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    q_sign = ops.pack_query_signs(q)
    got = ops.stage0_sign_scores_gather(q_sign, flat, ids, block_rows=pr)
    assert torch.equal(got, ref.stage0_sign_gather_ref(q_sign, flat, ids,
                                                       pr))
    # the grouped form the prescreen passes: one table row per KV lane
    kv_ids = ids[::g].contiguous()
    got = ops.stage0_sign_scores_gather(q_sign, flat, kv_ids, block_rows=pr,
                                        group=g)
    assert torch.equal(got, ref.stage0_sign_gather_ref(
        q_sign, flat, kv_ids.repeat_interleave(g, 0), pr))
    counts = ops.launch_counts()
    assert counts["stage1_rows"] == 1 and counts["stage0_sign_gather"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("h,kh,hd", [(14, 2, 64), (24, 8, 128), (8, 4, 32)])
def test_decode_cuda_backend_matches_torch_backend(cuda_device, h, kh, hd):
    """The decode cascade on the "cuda" and "torch" backends gives the same
    bits on the card in every schedule (they differ only in #2 and #8),
    full-coverage paged equals flat and flat the legacy oracle, and the
    empty sequence reads exact zeros."""
    b, t, pr = 3, 1024, 16
    cache, gen = _decode_cache(cuda_device, b, t, kh, hd, h * hd)
    length = torch.tensor([0, 100, 900], dtype=torch.int32,
                          device=cuda_device)
    cache = sparse_kv.build_page_centroids(cache, length, pr)
    q = torch.randn(b, 1, h, hd, generator=gen, device=cuda_device)
    legacy = sparse_kv.sparse_decode_attention_ref(q, cache, length, 64)
    for kw in ({}, {"npages": 16}, {"npages": 16, "prescreen_c0": 128},
               {"npages": t // pr}):
        ops.reset_launch_counts()
        a = sparse_kv.sparse_decode_attention(q, cache, length, 64,
                                              page_rows=pr, backend="cuda",
                                              **kw)
        counts = ops.launch_counts()
        assert counts["stage1_rows"] == ("npages" in kw)
        assert counts["stage0_sign_gather"] == ("prescreen_c0" in kw)
        c = sparse_kv.sparse_decode_attention(q, cache, length, 64,
                                              page_rows=pr, backend="torch",
                                              **kw)
        assert torch.equal(a, c)
        assert not a.isnan().any() and not a[0].any()
        if kw.get("npages") in (None, t // pr):
            assert torch.equal(a, legacy)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _tiny_rag_models():
    """The CPU RAG tests' widths (tests/test_torch_rag.py), f32 compute,
    parameters drawn on the CPU."""
    ecfg = embedder.MINILM_CFG.with_(num_layers=2, d_model=32, num_heads=4,
                                     num_kv_heads=4, d_ff=64, vocab_size=128,
                                     pooled_dim=32)
    gcfg = get_config("qwen2-0.5b", smoke=True).with_(
        compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    return (ecfg, embedder.init_params(ecfg, gen, device="cpu"), gcfg,
            dense.init_params(gcfg, gen, device="cpu"))


@pytest.mark.gpu
def test_quantization_scales_on_the_card_equal_the_cpu(cuda_device):
    """The INT8/INT4 scales and codes (per vector and per tensor) and the
    KV keys' planes and scales come out bit for bit as on the CPU (and so
    as the reference's): the scale divides by a tensor, since torch on a
    CUDA tensor multiplies by the reciprocal of a Python divisor."""
    x = torch.randn(4096, 64, generator=torch.Generator().manual_seed(5))
    for fn in (quantize_int8, quantization.quantize_int4):
        for per_vector in (True, False):
            want = fn(x, per_vector=per_vector)
            got = fn(x.to(cuda_device), per_vector=per_vector)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (fn.__name__, per_vector)
    k = x.reshape(8, 128, 4, 64)
    for g, w in zip(sparse_kv.quantize_keys(k.to(cuda_device)),
                    sparse_kv.quantize_keys(k)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_rag_pipeline_retrieve_on_the_card_matches_the_cpu(cuda_device):
    """RAGPipeline.retrieve on the card (kernel backend) against the CPU
    (plain versions): the same ids and ledger, embeddings within 1e-5;
    on the card the plain backend gives the kernel backend's bits."""
    ecfg, ep, gcfg, gp = _tiny_rag_models()
    api = get_model(gcfg)
    docs = np.random.default_rng(3).integers(0, 128, (40, 12)).astype(
        np.int32)
    cpu = RAGPipeline.build(ecfg, ep, api, gp, docs, RetrievalConfig(k=2),
                            device="cpu")
    gpu = RAGPipeline.build(ecfg, _to(ep, cuda_device), api,
                            _to(gp, cuda_device), docs, RetrievalConfig(k=2))
    q = docs[[5, 17, 23]]
    ops.reset_launch_counts()
    res, ledger = gpu.retrieve(q)
    counts = ops.launch_counts()
    assert counts["stage1_plane_mma"] + counts["stage1_plane"] == 1
    assert counts["stage2_rerank_by_id"] == 1 and counts["stage2_by_id"] == 0
    want, want_ledger = cpu.retrieve(q)
    assert torch.equal(res.indices.cpu(), want.indices)
    assert res.indices[:, 0].tolist() == [5, 17, 23]
    assert ledger.total_uj == want_ledger.total_uj
    got_e = embedder.encode(gpu.emb_params, torch.from_numpy(q), ecfg)
    want_e = embedder.encode(cpu.emb_params, torch.from_numpy(q), ecfg)
    assert float((got_e.cpu() - want_e).abs().max()) < 1e-5
    gpu.retrieval_cfg = RetrievalConfig(k=2, backend="torch")
    plain, _ = gpu.retrieve(q)
    assert torch.equal(plain.indices, res.indices)
    assert torch.equal(plain.scores, res.scores)


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [dict(top_k=8),
                                   dict(top_k=6, npages=3, prescreen_c0=10)])
def test_decode_step_quant_on_the_card_matches_the_cpu(cuda_device, knobs):
    """One decode_step_quant step at the CPU tests' widths: the card's
    kernel backend equals its plain backend bit for bit and the CPU within
    1e-4; a cache quantized on the card from the CPU's K equals the CPU's
    bit for bit; #2 and #8 launch once per layer when the schedule asks."""
    _, _, gcfg, gp = _tiny_rag_models()
    gpu_p = _to(gp, cuda_device)
    page_rows = 4 if "npages" in knobs else None
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (2, 13)).astype(np.int32))
    _, cpu_kv = dense.prefill(gp, toks[:, :12], gcfg, max_len=16)
    _, gpu_kv = dense.prefill(gpu_p, toks[:, :12].to(cuda_device), gcfg,
                              max_len=16)
    assert float((gpu_kv.k.cpu() - cpu_kv.k).abs().max()) < 1e-4
    cpu_q = dense.quantize_cache(cpu_kv, page_rows=page_rows)
    same_k = dense.quantize_cache(dense.KVCache(
        k=cpu_kv.k.to(cuda_device), v=cpu_kv.v.to(cuda_device),
        length=cpu_kv.length.to(cuda_device)), page_rows=page_rows)
    for f in ("k_msb", "k_lsb", "k_scale", "cent_msb", "cent_scale"):
        a, b = getattr(same_k, f), getattr(cpu_q, f)
        assert (a is None and b is None) or torch.equal(a.cpu(), b), f
    tok = toks[:, 12:13]
    want, _ = dense.decode_step_quant(gp, cpu_q, tok, gcfg, **knobs)
    outs = []
    for backend in ("cuda", "torch"):
        qc = dense.quantize_cache(dense.KVCache(
            k=gpu_kv.k.clone(), v=gpu_kv.v, length=gpu_kv.length.clone()),
            page_rows=page_rows)
        ops.reset_launch_counts()
        outs.append(dense.decode_step_quant(gpu_p, qc, tok.to(cuda_device),
                                            gcfg, backend=backend,
                                            **knobs)[0])
        if backend == "cuda":
            counts = ops.launch_counts()
            layers = gcfg.num_layers
            assert counts["stage1_rows"] == (
                layers if "npages" in knobs else 0)
            assert counts["stage0_sign_gather"] == (
                layers if "prescreen_c0" in knobs else 0)
    assert torch.equal(outs[0], outs[1])
    assert float((outs[0].cpu() - want).abs().max()) < 1e-4


@pytest.mark.gpu
def test_rag_agent_turn_on_the_card_matches_the_cpu(cuda_device):
    """RAGAgent.turn over a 2-tenant pipeline on the card and on the CPU,
    f32 compute: the same slots, ids, greedy tokens, µJ and decode steps;
    #8 launched once per layer per quantized step."""
    ecfg, ep, gcfg, gp = _tiny_rag_models()
    api = get_model(gcfg)
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 128, size=(6, 4)) for _ in range(2)]
    q = rng.integers(0, 128, size=(2, 4))
    reps = []
    for dev in ("cpu", cuda_device):
        pipe = MultiTenantRAGPipeline.create(
            ecfg, _to(ep, dev), api, _to(gp, dev), capacity=64, doc_len=4,
            device=dev)
        for t in range(2):
            pipe.ingest(t, docs[t])
        rt = ServingRuntime(pipe.index, RuntimeConfig(max_batch=2))
        agent = RAGAgent(pipeline=pipe, runtime=rt, top_k=16, npages=4,
                         prescreen_c0=24, page_rows=8)
        ops.reset_launch_counts()
        reps.append(agent.turn(np.array([0, 1]), q, max_new=6))
        counts = ops.launch_counts()
        assert rt.decode_steps == 6
    assert counts["stage0_sign_gather"] == 5 * gcfg.num_layers
    assert counts["stage1_rows"] == 5 * gcfg.num_layers + rt.launches
    cpu, gpu = reps
    np.testing.assert_array_equal(gpu.retrieved, cpu.retrieved)
    assert torch.equal(gpu.tokens.cpu(), cpu.tokens)
    assert (gpu.uj_per_query, gpu.uj_per_token) == (cpu.uj_per_query,
                                                     cpu.uj_per_token)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 1), (4, 2)])
def test_sharded_index_on_the_card_matches_the_cpu(cuda_device, shape):
    """S shard slots on the card (S row blocks of one plane) give the CPU
    port's bits, and one batch launches #1 and #3-by-id once per slot and
    the final rerank kernel once."""
    from repro_torch.core.index import (ShardedIndex, pad_database,
                                        shard_database)
    from repro_torch.launch.mesh import make_test_mesh
    docs, queries, _ = retrieval_corpus(5000, 512, num_queries=8, seed=4)
    bp = BitPlanarDB.from_quantized(build_database(docs, device="cpu"))
    q, _ = quantize_int8(torch.from_numpy(queries), per_vector=True)
    slots = shape[0] * shape[1]
    padded = pad_database(bp, slots)
    cpu = ShardedIndex(db=shard_database(padded, make_test_mesh(
        *shape, "cpu")), mesh=make_test_mesh(*shape, "cpu"), n_global=5000)
    mesh = make_test_mesh(*shape)
    card = ShardedIndex(db=shard_database(padded, mesh), mesh=mesh,
                        n_global=5000)
    assert all(b.msb_plane.device == cuda_device for b in card.db)
    for metric in ("cosine", "mips"):
        cfg = RetrievalConfig(k=5, metric=metric)
        want = cpu.retrieve_fn(cfg)(q)
        ops.reset_launch_counts()
        got = card.retrieve_fn(cfg)(q.to(cuda_device))
        counts = ops.launch_counts()
        assert counts["stage1_plane_mma"] == slots, counts
        assert counts["stage2_by_id"] == slots, counts
        assert counts["stage2_rerank"] == 1, counts
        assert counts["stage1_plane"] == counts["stage2_exact"] == 0
        for f in ("indices", "scores", "candidate_indices"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.gpu
def test_sharded_runtime_failover_on_the_card_matches_the_cpu(cuda_device):
    """The same trace, a failover in its middle, through 3 shards on the
    card and on the CPU: every result and the ledger bit for bit."""
    from repro_torch.serve import ShardedRuntimeConfig, ShardedServingRuntime
    rng = np.random.default_rng(5)
    nt, nd, dim = 6, 64, 128
    docs = {t: rng.integers(-40, 41, (nd, dim), dtype=np.int8)
            for t in range(nt)}
    qs = [(t, rng.integers(-40, 41, (dim,), dtype=np.int8))
          for t in list(range(nt)) * 4]
    cfg = ShardedRuntimeConfig(
        num_shards=3, capacity_per_shard=1024, dim=dim,
        retrieval=RetrievalConfig(k=4, metric="mips", candidate_frac=1.0,
                                  max_candidates=nd),
        runtime=RuntimeConfig(max_batch=4, max_wait=1.0, cache_bytes=0,
                              auto_flush=False))

    def drive(devices):
        rt = ShardedServingRuntime(cfg, devices=devices)
        for half in (0, 1):
            for t in range(nt):
                rt.ingest_codes(t, docs[t][half * nd // 2:
                                           (half + 1) * nd // 2])
        out, now = [], 0.0
        for i, (t, q) in enumerate(qs):
            if i == len(qs) // 2:
                rt.fail_shard(rt.placement.shard_of(t), now=now)
            now += 1e-3
            out.append(rt.submit(t, q, now=now))
            if i % 4 == 3:
                rt.poll(now=now)
        rt.flush(now=now + 1)
        return [h.result() for h in out], rt.ledger()

    got, got_ledger = drive(None)
    want, want_ledger = drive(["cpu"])
    assert got_ledger == want_ledger and got_ledger["failovers"] == 1
    for g, w in zip(got, want):
        for f in ("indices", "scores", "candidate_indices"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_multi_tenant_index_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        assert MultiTenantIndex(64, 64).arena.owner.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiTenantIndex(64, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Arena(64, 64)
