"""The hand-written CUDA kernels and the kernel backend on a CUDA device.

Marked `gpu`; without a CUDA device every case skips. This file imports
no JAX (the GPU machine has none), so on a GPU it runs with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import BitPlanarDB, build_database, quantize_int8
from repro_torch.core.engine import (MaskedPolicy, PlainPolicy,
                                     RetrievalEngine, WindowedPolicy)
from repro_torch.core.retrieval import RetrievalConfig
from repro_torch.data import retrieval_corpus
from repro_torch.kernels import ops, ref
from repro_torch.kernels.stage1_int4 import (stage1_int4_batched,
                                             stage1_int4_rows)
from repro_torch.kernels.stage2_int8 import stage2_int8_batched


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
    assert ops.launch_counts() == {"stage1_plane": 1, "stage1_rows": 1,
                                   "stage2_exact": 1}
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
    assert ops.launch_counts() == {"stage1_plane": 2, "stage1_rows": 1,
                                   "stage2_exact": 3}
