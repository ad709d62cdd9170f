"""The hand-written CUDA kernels and the kernel backend on a CUDA device.

Marked `gpu`; without a CUDA device every case skips. This file imports
no JAX (the GPU machine has none), so on a GPU it runs with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core import (BitPlanarDB, build_database, clustering,
                              quantize_int8)
from repro_torch.core.engine import (MaskedPolicy, PlainPolicy,
                                     RetrievalEngine, WindowedPolicy)
from repro_torch.core.retrieval import RetrievalConfig, cluster_pruned_retrieve
from repro_torch.data import retrieval_corpus
from repro_torch.kernels import ops, ref
from repro_torch.kernels.stage0_sign import stage0_sign_gather
from repro_torch.kernels.stage1_gather import stage1_int4_gather
from repro_torch.kernels.stage1_int4 import (stage1_int4_batched,
                                             stage1_int4_rows)
from repro_torch.kernels.stage2_int8 import stage2_int8_batched

ZERO_COUNTS = {"stage1_plane": 0, "stage1_rows": 0, "stage2_exact": 0,
               "stage1_gather": 0, "stage0_sign_gather": 0}


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
    assert ops.launch_counts() == dict(ZERO_COUNTS, stage1_plane=1,
                                       stage1_rows=1, stage2_exact=1)
    with pytest.raises(ValueError):
        stage1_int4_batched(panel, plane[:, : d // 2 - 16].contiguous())
    with pytest.raises(TypeError):
        stage1_int4_batched(panel, plane.to(torch.int8))
    with pytest.raises(ValueError):
        stage2_int8_batched(q8, m[:, ::2], lo[:, ::2])


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
    assert ops.launch_counts() == dict(ZERO_COUNTS, stage1_plane=2,
                                       stage1_rows=1, stage2_exact=3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d", [(3, 64), (33, 1536), (40, 8192), (5, 200),
                                 (2, 8)])
def test_kernels_take_every_width(cuda_device, b, d):
    """The plane, rows and exact kernels at widths past the 64-byte chunk
    and the 48 KiB shared-memory default, bit-exact against plain."""
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
    with pytest.raises(ValueError, match="multiple of 8"):
        stage1_int4_batched(panel[..., :-1].contiguous(),
                            plane[:, :-1].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("b,br,d,n", [(1, 64, 512, 1000), (3, 8, 200, 777),
                                      (33, 32, 64, 4099), (8, 64, 40, 300)])
def test_gather_kernels_match_plain(cuda_device, b, br, d, n):
    """Both gather kernels over a ragged plane whose last block reads past
    N, against their plain versions; the resident forms over a plane of
    whole blocks."""
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
    assert counts["stage1_gather"] == 2
    assert counts["stage0_sign_gather"] == (db.sign_plane is not None)


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
    assert counts["stage1_plane"] == 2 and counts["stage2_exact"] == 2
    if c0 is None:
        assert counts["stage1_gather"] == 2
        assert counts["stage0_sign_gather"] == 0
    else:
        assert counts["stage0_sign_gather"] == 2
        assert counts["stage1_rows"] == 2
