"""Hand-written Hopper kernels (CUDA C++ in `../csrc`) and their wrappers.

  stage1_int4   — the stage-1 INT4 plane, single-query and rows scans
                  (the batched plane scan on the int8 tensor cores of
                  `stage1_mma.cu` where its shape allows)
  stage1_gather — stage 1 over per-lane block tables (cluster cascade;
                  whole blocks by TMA onto the int8 tensor cores in
                  `stage1_gather.cu` where its shape allows)
  stage2_int8   — the exact INT8 rescore: by candidate id, and on
                  gathered rows (batched and single-query); the engine's
                  whole exact stage in one launch (rescore by id, norms,
                  pins and the comparator or MIPS rerank, `stage2_rerank.cu`)
                  and its ranking half
  stage0_sign   — the 1-bit sign scans: dense plane and block gather
  fused_topk    — stage-1 scoring fused with a per-block top-k

ops.py: the public stage functions; ref.py: the plain versions;
autotune.py: the measured block search the ops wrappers consult.
Importing this package builds nothing: a kernel is compiled on its first
launch (or by `_build.build()`).
"""
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels.fused_topk import (fused_topk_batched,
                                            fused_topk_single)
from repro_torch.kernels.stage0_sign import (stage0_sign_batched,
                                             stage0_sign_gather)
from repro_torch.kernels.stage1_gather import stage1_int4_gather
from repro_torch.kernels.stage1_int4 import (stage1_int4_batched,
                                             stage1_int4_rows,
                                             stage1_int4_single)
from repro_torch.kernels.stage2_int8 import (stage2_int8_batched,
                                             stage2_int8_by_id,
                                             stage2_int8_rerank_by_id,
                                             stage2_int8_single,
                                             stage2_rerank)
