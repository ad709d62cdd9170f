#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's retrieval cascades, models (dense, vlm,
MoE, SSM, hybrid, enc-dec), RAG pipeline, training and the examples on
one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. card    — print the card's name and power limit (nvidia-smi).
  2. build   — compile every CUDA kernel from src/repro_torch/csrc.
  3. corpus  — a seeded planted-relevance corpus of N = 2^20 documents x
               D = 512 (512 users x 2048 docs, the paper's 1 MB unit per
               user) built on the card: 256 MiB MSB plane, 256 MiB LSB.
  4. kernels — each kernel against its plain PyTorch version on the card,
               bit-exact, at the main paths' shapes and at ragged shapes
               (widths D = 8 to 262,144, D % 8 != 0 included, for the plane,
               rows, gather, exact and fused kernels); times from CUDA
               events (median of 20 after warm-up). The plane scan on both
               of its kernels (tensor-core and dp4a, and their times at
               B = 2, 4, 8: the crossover), the block gather on both of its
               kernels (TMA and dp4a, held to each other, and both timed
               with the L2 flushed before each call as well), the sign
               gather on both of its kernels (popcount, which the route
               takes at D = 512, and bulk-copy, held to each other, with
               the bulk kernel's one-block floor), the exact rescore in
               both forms
               (gathered rows and by id, held to each other), and the
               exact stage in one launch (`stage2_rerank_by_id`: by-id
               rescore, norms, pins and rerank; cosine and MIPS, masked
               and not, at the main shape and ragged ones) and its
               ranking half (`stage2_rerank`, any int32), each against
               its plain version, timed beside the parent's stage (the
               by-id kernel, then the plain rerank) with its launches by
               kernel, and at one block (the floor).
  5. main    — B = 32 query batches through `RetrievalEngine.retrieve`
               with the Plain (cosine, MIPS), Masked (512 tenants) and
               Windowed (window 2048) policies on the kernel backend; the
               launch counter of each kernel of the path must grow (the
               dp4a plane kernel, the gathered-rows exact form and the
               separate by-id rescore must not: the path takes the
               tensor-core plane kernel and one exact-stage launch that
               reads candidates by id and ranks them), every result must
               equal the plain
               backend's bit for bit, the exact scores must equal the INT8
               dot products, and recall@5 against the planted gold is
               checked.
 5b. sharded — ROADMAP A2's serving half, S logical shard slots on this
               one card (the code path of S cards, not multi-card
               scaling). (a) `ShardedIndex` over the arena corpus at 1, 3
               (2 pad rows) and 8 slots, cosine and MIPS, B = 32 batches:
               bit-identical to the plain backend and to the unsharded
               engine, no pad id, recall@5 >= 0.95, #1 and #3-by-id
               launched exactly S times per batch and the final rerank
               kernel once (never dp4a or the
               gathered rows); #1 at each shard's shape against its bound
               and `torch._int_mm`; the all-negative MIPS corpus padded to
               4. (b) `ShardedServingRuntime`: the 512 users as tenants
               over 4 shards of 2^19 rows, 1536 requests (3 per tenant)
               with a poll every 32 submits: MIPS spread 1 and 2 (budget
               2048), cosine (budget 50), MIPS with `fail_shard` at
               request 768; each equal to a 1-shard baseline (the
               failover's scores, its indices to the exact oracle), the
               ledger exactly once, the kernel backend equal to the plain
               one (cosine). Prints per run the turn p50 and max,
               queries/s, lanes per shard, stage-1 bytes, launches, and
               the failover's ms, moved tenants and restored docs. (c),
               in the rag phase: `RAGPipeline.build(mesh=(4, 2))` equal to
               the unsharded pipeline, and the launchers with `--data 2
               --model 2` and with `--shards 4 --fail-at 20`.
  6. autotune — this slice's path. The single-query and fused kernels and
               the dense sign scan (table rows 4, 5, 7, 9, 10) against their
               plain versions, bit-exact at full width (the arena corpus;
               B = 32 for the sign scan and the fused top-k, masked with 512
               tenants and a padding lane and unmasked; B = 1 for the
               single-query forms) and at ragged shapes, and timed; the
               batched fused top-k on both of its kernels (tensor-core and
               dp4a: each against the plain version and the other, and
               timed masked and unmasked at k = 8 and k = 1, which splits
               scoring from selection); the dense sign scan on both of
               its kernels (tensor-core and popcount: each against the
               plain version and the other, at the main shape and at
               ragged shapes each takes, and timed); the fused
               candidates (k_per_block = c = 50, on the tensor-core
               kernel) against the stable top-c of the masked
               plane-kernel scores. Then, with the
               launch counts set to 0: `autotune.autotune` over N = 2^20 x
               D = 512 at B = 1, 8, 32 (reps 5) and 12 single queries
               through `ops.fused_candidates`, `ops.stage1_scores` and
               `ops.stage2_scores`, each held to the engine's B = 1 MIPS
               result. The table must show every entry at >= 1.0x its
               default; it is saved, reloaded and installed through
               REPRO_TORCH_AUTOTUNE_CACHE by an engine, a copy with its
               device_kind altered is refused, the tuned wrappers give the
               default blocks' bits, and Plain and Masked batches served
               with the table installed equal the untuned ones.
  7. cluster — the cluster-pruned cascade at full width: a clustered corpus
               of N = 2^20 x D = 512 (1024 clusters of 1024 rows) built on
               the card, its INT8 codebook of cluster means and block table
               (64-row blocks), and B = 32 batches through
               `RetrievalEngine.retrieve` with `ClusterPolicy(nprobe=8)`:
               cosine, MIPS, and cosine with the sign prescreen at
               C0 = 2048; counted, checked against the plain backend and
               the planted gold like the main phase; then cluster MIPS
               with the block gather on its TMA kernel and on dp4a in
               turns in this one process (the redesign end to end).
  8. tenancy — the multi-tenant streaming index at full width through
               `MultiTenantIndex` on the card: 512 tenants x 2048 docs
               ingested online (float embeddings, the arena's fixed scale)
               into one 2^20-row arena in 4 rounds, so every tenant is 4
               runs; B = 32 batches of 32 distinct tenants on the Masked
               policy and 12 single queries; 256 docs of each tenant
               deleted; compact(), then Windowed (2048); then a second,
               clustered index (64 shared planted centres, 64 codebook
               clusters, nprobe 8, 64-row blocks) served cosine, MIPS and
               with the sign prescreen at C0 = 256. Checks: the policy
               each batch takes, no cross-tenant leak, no tombstoned id,
               recall@5, exact scores, bit-identical to the plain backend,
               online ingest equal to a rebuild after compact(), no
               rebuild, and the Prometheus round trip of the metrics every
               retrieve publishes; the trace goes to build/.
  9. serving — `ServingRuntime` over the tenancy phase's clustered index:
               a session trace (32 tenants x 48 turns, after the reference
               bench's `_session_trace`) cold, warm (preload), under a
               quarter of the warm budget, warm at async_depth 0, with
               the sign prescreen (C0 = 256) cold and warm, and with the
               prescreen under the quarter budget at full precision and
               with the cache's precision tiers (which must demote and
               promote, hold more residents than the slab has slots and
               stream no more stage-1 plane bytes than full precision);
               #8's resident route counted against a profile of 20 calls
               (ROADMAP C6); `CrossTenantBatchScheduler` over the
               tenancy phase's Masked arena (run from inside that phase,
               before its deletes); two open loops of 1536 requests from
               all 512 tenants; the resident gathers (#6 and #8 over the
               slab's combined plane) against their plain versions. Checks:
               every run bit-identical to cold, cold to `index.retrieve`
               and to the plain backend, the facade to `index.retrieve`,
               fewer stage-1 bytes warm than cold, the byte ledgers equal
               to the launches' plans, no cross-tenant row, every
               open-loop request resolved once, and the path's launches
               (the TMA gather, the sign gather, the exact rescore by id
               and both resident routes; never the dp4a gather or the
               gathered-rows rescore). Per run it prints per-turn p50 and
               max, queries/s, hit rate, stage-1 bytes from device memory
               and from the slab, device busy and idle share, host syncs
               per dispatch and the host's own time by function.
 10. decode  — the KV cascade (`serve.sparse_kv.sparse_decode_attention`)
               at qwen2-0.5b's attention widths (24 layers, 14 query heads,
               2 KV heads, hd 64): B = 8 sequences over a seeded
               32768-position cache per layer (INT8 K nibble planes with
               16-row page centroids, bf16 V; lengths 0, 100 and the rest
               in [T/2, T]); one 24-layer step per schedule (flat, paged
               npages 256, paged + prescreen C0 1024, paged at full
               coverage) on the "cuda" and the "torch" backend. Checks:
               cuda = torch bit for bit, full coverage = flat =
               `sparse_decode_attention_ref`, exact zeros at length 0,
               top_k = T within 1e-4 of dense f32 attention, the kv_plan
               ledger and `account_decode`, #2 launched 24 times per paged
               step and #8 24 times per prescreen step (neither flat), and
               cuda = torch at minitron-4b's widths (hd 128, one layer).
               Prints per schedule the p50 step, tokens/s, busy ms, idle
               share, launches, the ledger's bytes against dense; the
               flat-plane copies' bytes and device time; a dense bf16
               yardstick; #2 and #8 at the decode shapes (#8 over the
               grouped (B*KH, pages) table the prescreen passes, on both
               kernels, and on popcount over the per-lane table; the bulk
               kernel's one-block floor at hd 64).

 11. rag     — the models and the RAG pipeline at both models' full
               widths, random weights from a seeded generator on the card,
               under `torch.inference_mode()`: qwen2-0.5b (24 layers x 896,
               14 query heads over 2 KV heads, vocab 151936; f32 weights,
               bf16 compute) and the MiniLM embedder (6 layers x 384,
               pooled 512; f32). One user through `RAGPipeline`: 2048 docs
               of 64 tokens embedded and quantized, B = 8 queries that copy
               docs, `retrieve` and `answer` (32 new tokens); top-1 8/8 and
               the ledger equal to cost_cascade of the plain plan, below
               the full scan. Many users through `MultiTenantRAGPipeline`:
               32 tenants x 2048 docs ingested online, a `ServingRuntime`
               (max_batch 32) and a `RAGAgent` (top_k 32, 8 pages of 16
               rows, prescreen C0 64), two turns of one query per tenant
               (384-token prompts, a 416-position cache); top-1 32/32, no
               id of another tenant, equal turns, decode_steps and the
               energy_uj_per_token count 64, the kv_plan below dense, #2
               and #8 launched 24 times per quantized step and #2 and #3
               per retrieval launch; the kernel backend equal to the plain
               one bit for bit (ids; one decode_step_quant's logits and
               cache). At f32 compute and full width: prefill + 8
               decode_steps against `forward` (within RAG_TF_ATOL), and
               decode_step_quant at top_k >= T against decode_step, two
               steps (within 0.1). Then `python -m repro_torch.launch.serve
               --requests 4 --num-docs 64 --max-new 4` must exit 0 with
               `top-1 hit 4/4`. Prints, with the card's name and power
               limit: ingest docs/s, each turn's split (embed + retrieve,
               prefill, decode), the p50 24-layer step of
               decode_step_quant and of the bf16 decode_step with
               tokens/s, one profiled quant step (busy, idle share,
               launches, its four busiest kernels), the tied head's cast
               per step, the kv_plan bytes against dense, the phase's
               seconds.
 12. train   — training and its state at qwen2-0.5b's full width (f32
               weights, bf16 compute, remat), B = 8 sequences of 64 tokens
               of the synthetic LM stream, AdamW at lr 3e-4; checkpoints in
               a directory under build/ that the phase removes. (a) At 2
               layers and f32 compute, one batch: loss, grads, one AdamW
               and one Adafactor step (from the same grads) on the card
               against the port's CPU path, grad_accum 2 against 1, and
               two INT8 error-feedback rounds bit for bit (TRAIN_* limits).
               (b) 24 layers through `ElasticTrainer` on 2 slots of the
               card: 10 steps of one repeated batch, a checkpoint every 5
               (keep 2), a worker lost at step 7; restarts 1, final_devices
               1, 10 finite losses, the first within 0.5 of ln V, the last
               0.5 below the first, the step-5 restore equal to the state
               saved, bit for bit. (d) The step-10 weights restored and
               served through `RAGPipeline` with the full-width MiniLM over
               2048 docs of 64 tokens: top-1 8/8, #1 (`stage1_plane_mma`)
               and the exact stage (`stage2_rerank_by_id`) launched
               (counts set to 0 before). (c) The p50
               of 20 steps and tokens/s, one profiled step (busy, idle
               share, launches, busiest kernels), the AdamW update's share,
               peak device memory, a synchronous save and restore of the
               state with GB/s. (e) `python -m repro_torch.launch.train`
               at full width (4 steps, a save at 4) and `--smoke
               --grad-accum 2 --compress-grads`, side by side: rc 0 and the
               closing line. Prints every number with the card's name and
               power limit.
 12a. models  — the dense, vlm and MoE configs at full width with random
               weights (see MD_* below): llama4-scout (1 layer, f32) on
               the card against the port's CPU path (routing exact with
               near-ties counted, logits, the MoE dispatch bit-identical
               across two runs); llama4-scout (4 layers), llama4-maverick
               (one superblock, bf16), minitron-4b, internvl2-26b (8
               layers), deepseek-coder-33b and deepseek-67b (4 layers)
               one at a time behind `RAGPipeline.answer` (top-1 8/8, #1
               and the exact stage counted, prefill and decode p50, one
               profiled step, peak memory; decode against `forward` at
               f32 for the dense and vlm ones); llama4-scout (1 layer)
               trained through `ElasticTrainer` with Adafactor, its
               checkpoint restored bit for bit; three launchers with the
               new `--arch` ids.
 12b. ssm     — the SSM and hybrid configs at full width with random
               weights (see SSM_* below): mamba2-2.7b (2 layers; prefills
               of 512 and 384 tokens) and zamba2-2.7b (one superblock) at
               f32 on the card against the port's CPU path, and the
               chunked SSD scan at the full head shape against the f64
               recurrence; both at full depth behind `RAGPipeline.answer`
               (top-1 8/8, #1 and the exact stage counted, decode against
               `forward` at f32); mamba2 (16 layers) and zamba2 (12
               layers) trained with AdamW through `ElasticTrainer`, the
               state restored bit for bit; four launchers with the new
               `--arch` ids.
 12c. encdec  — seamless-m4t-medium at full width with random weights
               (see ED_* below): 2 + 2 layers at f32 on the card against
               the port's CPU path at 4096 frames (the encoder's
               non-causal chunked path) and 1024 (naive); full depth
               behind `serve.sampler.generate` (B = 8, 1024 frames, 32
               new tokens; decode against `forward` at f32; no kernel
               launched) and trained with AdamW through
               `ElasticTrainer`, the state restored bit for bit; the
               training launcher with the new `--arch` id and the
               serving launcher's refusal of it.
 12d. dryrun  — the dry run (`launch/dryrun.py`): every (arch x shape)
               cell of the single production mesh (16, 16) run once on
               meta tensors, host only, over 8 worker processes, with the
               roofline of each (`launch/roofline.py`): 32 ok, 8 skipped,
               no error. Then three steps at full width on the card, each
               held to its dry run at the same shape: the qwen2-0.5b
               AdamW train step (B = 8 x 64), the seamless-m4t-medium
               decode step (B = 8, 96 positions, 1024 frames) and
               qwen2-0.5b's `decode_step_quant` (B = 8, T = 32768, paged
               + prescreen): dot FLOPs equal to the same dispatch count
               around the real step, #2's and #8's launches equal to the
               counters (24 each per step), the peak within DRY_BAND of
               the prediction, the step no faster than 0.95 x its bound.
 12e. train_sharded — a training state sharded over 4 torch.distributed
               ranks that share this one card over gloo (the code path of a
               (data 2, model 2) mesh, not multi-card scaling; see SH_*
               below): a probe of the gloo collectives on CUDA tensors; (a)
               the sharded step at 2 layers and f32 against the one-rank
               step; (b) the two-level INT8 all-reduce at (pod 2, data 2);
               (c) qwen2-0.5b FULL through the SPMD ElasticTrainer, 2 ranks
               dropped at step 3, the step-2 checkpoint restored onto (data
               1, model 2), each rank holding only its blocks; (d) the
               launcher at --smoke --data 2 --model 2. No kernel runs here.
 12f. examples — the five examples (`repro_torch.examples`, see EX_* below)
               on cuda:0 and with device "cpu", the same weights in both:
               quickstart, pod_retrieval, multi_user_agent and
               serve_rag_agent must print the CPU's lines (wall times
               masked; the agents' bf16 tokens equal but for near-tie
               rows, counted), the train_100m smoke run's losses within
               EX_LOSS_RTOL; #1 on the tensor cores, the exact stage, #3
               by id and the final rerank (pod) and #6 on TMA counted.
               Then train_100m --full (~126M parameters, B = 8 x 128):
               p50 step, tokens/s, first and last loss, the
               saves; it fails unless the loss is finite and falls.

Then the exact wrappers' and the block gather's host microseconds per
call (`host_us_per_call`).
The line before the last is a JSON object describing every kernel
(launches: the sum over the main, sharded, autotune, cluster, tenancy,
serving, decode, rag, train, models, ssm, encdec, dryrun and examples
paths (the encdec path has no kernel; the dryrun path's are #2 and #8 of
its kvq decode step); `stage1_gather_resident` and `stage0_sign_gather_resident`
are counted by the resident wrappers where they launch, which only the
serving phase's cached segments call; the `@decode_hd64` rows are #2 and
#8 at the decode phase's shapes, with the decode path's launches); the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import cProfile
import dataclasses
import io
import itertools
import json
import math
import os
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import _tree, obs  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.core import (bitplanar, clustering, energy,  # noqa: E402
                              engine, quantization)
from repro_torch.core.engine import (ClusterPolicy,  # noqa: E402
                                     MaskedPolicy, PlainPolicy,
                                     RetrievalEngine, WindowedPolicy,
                                     select_clusters, stage_fns)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.index import (ShardedIndex,  # noqa: E402
                                    pad_database, shard_database)
from repro_torch.core.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.core.similarity import stable_topk  # noqa: E402
from repro_torch.data import (LMTaskConfig, lm_batches,  # noqa: E402
                              shard_batch)
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.examples import (agent_models,  # noqa: E402
                                  multi_user_agent, pod_retrieval,
                                  quickstart, seeded_params, serve_rag_agent,
                                  train_100m)
from repro_torch.kernels import (  # noqa: E402
    _build, autotune, fused_topk, ops, ref, stage0_sign, stage1_gather,
    stage1_int4)
from repro_torch.kernels.fused_topk import (  # noqa: E402
    fused_topk_batched, fused_topk_single)
from repro_torch.kernels.stage0_sign import (  # noqa: E402
    stage0_sign_batched, stage0_sign_gather)
from repro_torch.kernels.stage1_gather import (  # noqa: E402
    stage1_int4_gather)
from repro_torch.kernels.stage1_int4 import (  # noqa: E402
    DEFAULT_ROWS, stage1_int4_batched, stage1_int4_rows, stage1_int4_single)
from repro_torch.kernels.stage2_int8 import (  # noqa: E402
    stage2_int8_batched, stage2_int8_by_id, stage2_int8_single)
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch import (dryrun, hlo_analysis, roofline,  # noqa: E402
                                shapes)
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import (attention, dense, embedder,  # noqa: E402
                                encdec, get_model, mamba2, moe, zamba2)
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.serve import (HotClusterCache,  # noqa: E402
                               MultiTenantRAGPipeline, RAGAgent, RAGPipeline,
                               RuntimeConfig, ServingRuntime,
                               ShardedRuntimeConfig, ShardedServingRuntime,
                               sparse_kv)
from repro_torch.serve.sampler import generate  # noqa: E402
from repro_torch.runtime import ElasticTrainer, FailureInjector  # noqa: E402
from repro_torch.tenancy import (CrossTenantBatchScheduler,  # noqa: E402
                                 MultiTenantIndex)
from repro_torch.train import (adafactor, adamw,  # noqa: E402
                               make_sharded_train_step, make_train_step)
from repro_torch.train.step import value_and_grad  # noqa: E402

SEED = 20251027
N, D = 1 << 20, 512
USERS, DOCS_PER_USER = 512, 2048
B, C, K = 32, 50, 5
BATCHES = 12
NOISE = 0.1
# The cluster path: 1024 planted clusters of 1024 rows (spread 0.2, query
# noise 0.1: the golden protocol's ratios), 64-row blocks, 8 probes.
CLUSTERS, CLUSTER_ROWS, SPREAD = 1024, 1024, 0.2
BLOCK_ROWS, NPROBE, PRESCREEN_C0 = 64, 8, 2048
MAIN_KERNELS = ("stage1_plane_mma", "stage1_rows", "stage2_rerank_by_id")
# Kernels the main and cluster paths must not launch: at B = 32, D = 512
# the plane scan takes the tensor-core kernel, the block gather the TMA
# kernel, and the exact stage is one launch that reads candidates by id
# and ranks them (no gathered-rows form, so no index gathers before it;
# no by-id rescore apart from its rerank; no sharded rerank).
OFF_PATH_KERNELS = ("stage1_plane", "stage2_exact", "stage1_gather_dp4a",
                    "stage2_by_id", "stage2_rerank")
# The autotune path: the autotuner and the single-query entry points.
TUNE_KERNELS = ("stage1_plane", "stage1_plane_mma", "stage1_rows",
                "stage1_single", "stage2_single", "stage0_sign_plane",
                "stage0_sign_plane_mma", "fused_topk", "fused_topk_single",
                "fused_topk_mma")
# The batches at which the tensor-core and dp4a plane kernels are compared.
CROSSOVER_BATCHES = (2, 4, 8)
HOST_CALLS = 1000
STAGE_CALLS = 50            # the parent's exact stage: ~10 ms a call
FUSED_BLOCK, FUSED_K = 512, 8
SINGLE_QUERIES = 12
ROOT = os.path.dirname(os.path.abspath(__file__))
CLUSTER_KERNELS = ("stage1_plane_mma", "stage1_rows", "stage2_rerank_by_id",
                   "stage1_gather", "stage0_sign_gather")
# Published H100 SXM peaks (NVIDIA data sheet): device memory and dense
# int8 tensor-core rate. Used only for the least-time bound of each kernel.
INT32_MIN = -(2 ** 31)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
L2_BYTES = 50 << 20         # a launch that moves less may beat the HBM rate


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _traced(fn, reps: int):
    """torch.profiler's CUPTI trace of `reps` calls of `fn`, recorded after
    a warm-up step of `reps` calls that is traced but not kept: a trace
    window opened right at the first call can miss kernels (ROADMAP C6)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def device_profile(fn, reps: int = 5) -> list[tuple[str, float, float]]:
    """(name, device microseconds per call, launches per call) of every
    GPU kernel `fn` launches, from torch.profiler's CUPTI trace, busiest
    first."""
    fn()
    torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / reps, e.count / reps)
            for e in _traced(fn, reps).key_averages()
            if e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def kernel_device_us(fn, symbol: str) -> str:
    """Device-only time per call of the kernels whose name holds `symbol`
    (e.g. "::plane_kernel<", which "sign_plane_kernel" does not hold), or
    "not measured" when the trace holds no such kernel."""
    times = [t for name, t, _ in device_profile(fn, reps=20)
             if symbol in name]
    return f"{sum(times):.2f}" if times else "not measured"


def bound_ms(bytes_moved: int, int8_ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _share(bound: float, device_us: str) -> str:
    """' (share of bound x %)': the bound over a measured device time."""
    if device_us == "not measured":
        return ""
    return f" (share of bound {bound * 1e5 / float(device_us):.0f} %)"


# The sign gather's two kernels' names in a profile: the bulk-copy kernel
# of stage0_sign_gather.cu and the popcount one of stage0_sign.cu.
SIGN_BULK, SIGN_POPC = "sign_bulk_kernel", "sign_gather_kernel"


def _sign_answer(plane: torch.Tensor, br: int, group: int = 1) -> int:
    """The bulk sign gather launcher's answer for this plane and block: 2
    the route takes the bulk kernel, 1 only `route="bulk"` does, 0 it does
    not take the shape."""
    return stage0_sign._bulk_takes(plane.data_ptr(), plane.shape[0],
                                   plane.shape[1], br, group)


def _sign_floor(gen, dev, d: int, br: int, label: str) -> None:
    """The bulk sign gather at one lane and one block of `br` rows of D/8
    bytes: the device-only time of a launch that copies one block and
    scores it, the floor below the kernel's time at scale."""
    plane = torch.randint(0, 256, (1 << 16, d // 8), generator=gen,
                          device=dev, dtype=torch.uint8)
    qs = ops.pack_query_signs(torch.randint(
        -128, 128, (1, d), generator=gen, device=dev, dtype=torch.int8))
    one = torch.zeros((1, 1), dtype=torch.int32, device=dev)

    def fn():
        return stage0_sign_gather(qs, plane, one, block_rows=br,
                                  route="bulk")
    _check_kernel("stage0_sign_gather (one block)", lambda *a: fn(),
                  lambda *a: ref.stage0_sign_gather_ref(qs, plane, one, br),
                  (), f"1 lane, 1 block, D={d} BR={br}")
    t_bound, by = bound_ms(d + 4 + br * d // 8 + br * 4, 2 * br * d)
    dev_us = "not measured"
    for _ in range(3):      # a short trace can miss the one kernel (C6)
        dev_us = kernel_device_us(fn, SIGN_BULK)
        if dev_us != "not measured":
            break
    log(f"kernel stage0_sign_gather@one_block ({label} width D={d}, "
        f"BR={br}): device_only_us {dev_us} "
        f"(the floor: one CTA, one id read, one bulk copy, one block "
        f"scored) bound_us {t_bound * 1e3:.4f} ({by}); bit-exact")


def max_abs_err(got, want) -> int:
    """Largest absolute difference of two int32 results (or of each pair
    of a (scores, ids) result)."""
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want, strict=True))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"kernel gave {got.dtype}{tuple(got.shape)}, "
                             f"plain {want.dtype}{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = out.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    return card


# The instances the D = 512 paths launch (mangled template arguments):
# every instance of the tensor-core plane, fused and sign kernels (rows
# per tile x lane tile: 8, 16 or 32 lanes by B; the plane and fused
# kernels at most 16 at 1024 rows, the sign kernel 16 at 512 and 8 at
# 1024), the dp4a plane kernel's 32- and 1-lane ones, the TMA gather (no
# template: its name ends in E), the bulk sign gather's 16-byte-segment
# instance and its instances for the decode rows of 8 and 16 bytes.
MAIN_INSTANCES = tuple(
    f"{kernel}_kernelILi{rows}ELi{nt}EE"
    for kernel in ("plane_mma", "fused_mma", "sign_mma")
    for rows in (256, 128, 512, 1024) for nt in (4, 2, 1)
    if rows * nt <= (1024 if kernel == "sign_mma" else 2048)) + (
    "plane_kernelILi32ELi256ELi0ELb0EE", "plane_kernelILi1ELi256ELi0ELb0EE",
    "rows_kernelILi256ELi0ELb0EE", "gather_tma_kernelE",
    "gather_kernelILi0ELb0EE",
    "exact_kernelILi1EE", "rerank_kernelILb1ELi1ELi0EE",
    "rerank_kernelILb1ELi1ELi1EE", "rerank_kernelILb0ELi1ELi0EE",
    "sign_gather_kernelILi16EE",
    "sign_bulk_kernelILi64EE", "sign_bulk_kernelILi8EE",
    "sign_bulk_kernelILi16EE",
    "sign_plane_kernelILi32ELi256ELi16EE", "fused_kernelILi32ELi0ELb0EE",
    "fused_kernelILi1ELi0ELb0EE")


def phase_build() -> None:
    """Compile every source; print each one's nvcc time, the registers of
    the instances the D = 512 paths launch, and any instance that spills."""
    t0 = time.perf_counter()
    built = _build.build()
    for name, (text, secs) in built.items():
        regs, spills, kernel = {}, [], ""
        for line in text.splitlines():
            entry = re.search(r"((?:plane_wide|sign_plane|sign_mma|"
                              r"plane_mma|plane|"
                              r"rows|sign_gather|sign_bulk|gather_tma|"
                              r"gather|exact|rerank|"
                              r"fused_mma|fused)"
                              r"_kernel(?:I.*?EE|E))", line)
            if "Compiling entry function" in line and entry:
                kernel = entry.group(1)
            used = re.search(r"Used (\d+) registers", line)
            if used:
                regs[kernel] = int(used.group(1))
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill and int(spill.group(1)):
                spills.append(f"{kernel} ({spill.group(1)} B)")
            if "error" in line.lower():
                log(f"  nvcc {name}: {line.strip()}")
        main = ", ".join(f"{k} {regs[k]}" for k in MAIN_INSTANCES if k in regs)
        log(f"build: {name}.cu compiled in {secs:.1f} s: {len(regs)} "
            f"kernel instances, at most {max(regs.values(), default=0)} "
            f"registers; main instances' registers: {main or 'none'}; "
            f"instances that spill: {', '.join(spills) or 'none'}")
    log(f"build: {len(built)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def phase_corpus(dev: torch.device):
    """Seeded corpus on the card: random unit documents, each query a
    noisy copy (relative noise 0.1) of a planted gold document."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    docs = _unit(torch.randn(N, D, generator=gen, device=dev))
    q_total = B * BATCHES
    gold = torch.randint(0, N, (q_total,), generator=gen, device=dev)
    noise = _unit(torch.randn(q_total, D, generator=gen, device=dev))
    queries = _unit(docs[gold] + NOISE * noise)
    qdb = quantization.build_database(docs, device=dev)
    del docs
    db = bitplanar.BitPlanarDB.from_quantized(qdb)
    q_codes, _ = quantization.quantize_int8(queries, per_vector=True)
    torch.cuda.synchronize()
    log(f"corpus: {N} x {D} int8 ({USERS} users x {DOCS_PER_USER} docs) "
        f"built on the card in {time.perf_counter() - t0:.1f} s")
    return qdb, db, q_codes, gold


def _route(b: int, d2: int) -> str:
    """The plane scan's kernel for B lanes of D/2 bytes at the default rows
    per tile, as the tensor-core launcher decides it."""
    return "mma" if stage1_int4._mma_lanes(b, d2, DEFAULT_ROWS) else "dp4a"


def _fused_route(b: int, d2: int, block_n: int, k: int = 5) -> str:
    """The fused top-k's kernel for this shape, as its tensor-core launcher
    decides it."""
    return ("mma" if fused_topk._fused_mma_lanes(b, d2, block_n, k)
            else "dp4a")


def _check_kernel(name, kernel, plain, args, shapes_note) -> int:
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shapes_note}: max abs err {err}")
    return err


def _check_library(name: str, fn, want: torch.Tensor) -> None:
    """Raises unless one PyTorch library call that computes a kernel's
    function on pre-unpacked operands gives the kernel's answer (float32
    products are exact here: every partial sum is an integer below 2^24,
    and TF32 is off by default)."""
    got = fn()
    got = (got if got.dtype == torch.int32 else got.to(torch.int32)).reshape(
        want.shape)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the library yardstick disagrees with "
                             "the kernel")


def _library_ms(name: str, fn, want: torch.Tensor) -> float:
    """Time one PyTorch library call (`_check_library` first)."""
    _check_library(name, fn, want)
    return time_ms(fn)


def _turns_note(fn, lib, rounds: int = 3) -> str:
    """`time_ms` of a kernel's call and of its library yardstick taken in
    turns (kernel, library, kernel, ...), `rounds` each, as a note for a
    log line: the median of each. A second view beside the single
    `time_ms` of each, which the kernels line keeps: the host's noise,
    which both event times carry, falls on both alike."""
    mine, theirs = [], []
    for _ in range(rounds):
        mine.append(time_ms(fn))
        theirs.append(time_ms(lib))
    return (f"; in turns (median of {rounds} each): kernel_ms "
            f"{statistics.median(mine):.4f} library_ms "
            f"{statistics.median(theirs):.4f}")


def phase_kernels(db, q_codes, dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = q_codes[:B]
    q_msb = quantization.msb_nibble(q)
    d2 = D // 2
    rows = []

    # -- plane: the shared-plane stage-1 scan, on the tensor cores ---------
    # (the route the main path takes at B = 32, D = 512) and on dp4a.
    panel = ops.pack_query_panel(q_msb)
    if stage1_int4._mma_lanes(B, d2, DEFAULT_ROWS) != 32:
        raise AssertionError(f"the plane scan at B={B} D={D} does not take "
                             "the tensor-core kernel's 32-lane tile")

    def plane_mma(qp, p):
        return stage1_int4._plane(qp, p, DEFAULT_ROWS, route="mma")

    def plane_dp4a(qp, p):
        return stage1_int4._plane(qp, p, DEFAULT_ROWS, route="dp4a")

    errs = {}
    for name, fn in (("stage1_plane_mma", plane_mma),
                     ("stage1_plane", plane_dp4a)):
        errs[name] = _check_kernel(name, fn, ref.stage1_scores_batched_ref,
                                   (panel, db.msb_plane),
                                   f"B={B} N={N} D={D}")
        for bb, nn, dd in ((2, 1000, 512), (3, 4099, 256), (33, 777, 512),
                           (17, 256, 128), (65, 20001, 64)):
            p = torch.randint(0, 256, (nn, dd // 2), generator=gen,
                              device=dev, dtype=torch.uint8)
            qp = torch.randint(-8, 8, (2, bb, dd // 2), generator=gen,
                               device=dev, dtype=torch.int8)
            _check_kernel(name, fn, ref.stage1_scores_batched_ref, (qp, p),
                          f"B={bb} N={nn} D={dd}")
    unpacked = bitplanar.unpack_nibble_plane_signed(db.msb_plane)
    unpacked_t = unpacked.t()
    q_int8 = q_msb.contiguous()
    lib_ms = _library_ms("stage1_plane",
                         lambda: torch._int_mm(q_int8, unpacked_t),
                         stage1_int4_batched(panel, db.msb_plane))
    del unpacked, unpacked_t
    t_bound, by = bound_ms(2 * B * d2 + N * d2 + B * N * 4, 2 * B * N * D)
    plain_ms = time_ms(lambda: ref.stage1_scores_batched_ref(
        panel, db.msb_plane))
    for name, fn, source in (
            ("stage1_plane_mma", plane_mma,
             "src/repro_torch/csrc/stage1_mma.cu"),
            ("stage1_plane", plane_dp4a,
             "src/repro_torch/csrc/stage1_plane.cuh")):
        rows.append(dict(
            name=name, route="cuda", source=source,
            replaces="src/repro/kernels/stage1_int4.py:79",
            max_abs_err=errs[name],
            ms=time_ms(lambda: fn(panel, db.msb_plane)), plain_ms=plain_ms,
            bound_ms=t_bound, bound_by=by, library_ms=lib_ms))
    # The crossover: both kernels over the arena plane at small batches.
    for bb in CROSSOVER_BATCHES:
        qp = ops.pack_query_panel(q_msb[:bb])
        want = plane_dp4a(qp, db.msb_plane)
        if not torch.equal(plane_mma(qp, db.msb_plane), want):
            raise AssertionError(f"stage1_plane_mma disagrees with dp4a at "
                                 f"B={bb} N={N} D={D}")
        mma_ms = time_ms(lambda: plane_mma(qp, db.msb_plane))
        dp4a_ms = time_ms(lambda: plane_dp4a(qp, db.msb_plane))
        log(f"plane crossover B={bb} N={N} D={D}: mma_ms {mma_ms:.4f} "
            f"dp4a_ms {dp4a_ms:.4f} (route at this B: "
            f"{_route(bb, d2)})")

    # -- rows: per-lane windows of the arena (the Windowed policy) ---------
    w = DOCS_PER_USER
    starts = torch.randint(0, USERS, (B,), generator=gen, device=dev) * w
    win = db.msb_plane[starts[:, None] + torch.arange(w, device=dev)]
    q_eo = ops.pack_queries_even_odd(q_msb)
    err = _check_kernel("stage1_rows", stage1_int4_rows,
                        ref.stage1_rows_batched_ref, (q_eo, win),
                        f"B={B} W={w} D={D}")
    for bb, ww, dd in ((1, 5, 512), (3, 777, 512), (8, 2049, 256),
                       (5, 300, 32)):
        r = torch.randint(0, 256, (bb, ww, dd // 2), generator=gen,
                          device=dev, dtype=torch.uint8)
        qe = torch.randint(-8, 8, (bb, 2, dd // 2), generator=gen,
                           device=dev, dtype=torch.int8)
        _check_kernel("stage1_rows", stage1_int4_rows,
                      ref.stage1_rows_batched_ref, (qe, r),
                      f"B={bb} W={ww} D={dd}")
    win_f = bitplanar.unpack_nibble_plane_signed(win).float()   # (B, W, D)
    q_col = q_msb.float()[:, :, None]                            # (B, D, 1)
    lib_ms = _library_ms("stage1_rows", lambda: torch.bmm(win_f, q_col),
                         stage1_int4_rows(q_eo, win))
    t_bound, by = bound_ms(2 * B * d2 + B * w * d2 + B * w * 4,
                           2 * B * w * D)
    rows.append(dict(
        name="stage1_rows", route="cuda",
        source="src/repro_torch/csrc/stage1_rows.cu",
        replaces="src/repro/kernels/stage1_int4.py:120",
        max_abs_err=err,
        ms=time_ms(lambda: stage1_int4_rows(q_eo, win)),
        plain_ms=time_ms(lambda: ref.stage1_rows_batched_ref(q_eo, win)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

    # -- exact: INT8 rescore of gathered candidates (the reference's form) --
    cand = torch.randint(0, N, (B, C), generator=gen, device=dev)
    msb_rows, lsb_rows = db.msb_plane[cand], db.lsb_plane[cand]
    q_eo8 = ops.pack_queries_even_odd(q)
    err = _check_kernel("stage2_exact", stage2_int8_batched,
                        ref.stage2_scores_batched_ref,
                        (q_eo8, msb_rows, lsb_rows), f"B={B} C={C} D={D}")
    for bb, cc, dd in ((1, 1, 512), (3, 50, 512), (7, 13, 256),
                       (2, 64, 8)):
        m = torch.randint(0, 256, (bb, cc, dd // 2), generator=gen,
                          device=dev, dtype=torch.uint8)
        lo = torch.randint(0, 256, (bb, cc, dd // 2), generator=gen,
                           device=dev, dtype=torch.uint8)
        qe = torch.randint(-128, 128, (bb, 2, dd // 2), generator=gen,
                           device=dev, dtype=torch.int8)
        _check_kernel("stage2_exact", stage2_int8_batched,
                      ref.stage2_scores_batched_ref, (qe, m, lo),
                      f"B={bb} C={cc} D={dd}")
    docs_f = bitplanar.reconstruct_int8(
        msb_rows.reshape(B * C, d2), lsb_rows.reshape(B * C, d2)).reshape(
            B, C, D).float()                                     # (B, C, D)
    q_col8 = q.float()[:, :, None]                               # (B, D, 1)
    lib_ms = _library_ms("stage2_exact", lambda: torch.bmm(docs_f, q_col8),
                         stage2_int8_batched(q_eo8, msb_rows, lsb_rows))
    t_bound, by = bound_ms(2 * B * d2 + 2 * B * C * d2 + B * C * 4,
                           2 * B * C * D)
    rows.append(dict(
        name="stage2_exact", route="cuda",
        source="src/repro_torch/csrc/stage2_int8.cu",
        replaces="src/repro/kernels/stage2_int8.py:62",
        max_abs_err=err,
        ms=time_ms(lambda: stage2_int8_batched(q_eo8, msb_rows, lsb_rows)),
        plain_ms=time_ms(lambda: ref.stage2_scores_batched_ref(
            q_eo8, msb_rows, lsb_rows)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

    # -- exact by id: the same kernel reading the candidates in place ------
    ids8 = cand.to(torch.int32)
    by_id_args = (q_eo8, db.msb_plane, db.lsb_plane, ids8)
    err = _check_kernel("stage2_by_id", stage2_int8_by_id,
                        ref.stage2_scores_by_id_ref, by_id_args,
                        f"B={B} C={C} D={D}")
    if not torch.equal(stage2_int8_by_id(*by_id_args),
                       stage2_int8_batched(q_eo8, msb_rows, lsb_rows)):
        raise AssertionError("stage2_by_id disagrees with the gathered form")
    for bb, cc, nn, dd in ((1, 1, 1000, 512), (3, 50, 4099, 512),
                           (7, 13, 777, 250), (2, 64, 300, 8)):
        m = torch.randint(0, 256, (nn, dd // 2), generator=gen, device=dev,
                          dtype=torch.uint8)
        lo = torch.randint(0, 256, (nn, dd // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
        qe = torch.randint(-128, 128, (bb, 2, dd // 2), generator=gen,
                           device=dev, dtype=torch.int8)
        ii = torch.randint(-2, nn + 2, (bb, cc), generator=gen, device=dev,
                           dtype=torch.int32)
        ii[:, 0] = -1
        ii[:, -1] = nn - 1
        _check_kernel("stage2_by_id", stage2_int8_by_id,
                      ref.stage2_scores_by_id_ref, (qe, m, lo, ii),
                      f"B={bb} C={cc} N={nn} D={dd}, ids -1, N - 1 and "
                      "past N")
        safe = ii.clamp(0, nn - 1).long()
        if not torch.equal(stage2_int8_by_id(qe, m, lo, ii),
                           stage2_int8_batched(qe, m[safe], lo[safe])):
            raise AssertionError(f"stage2_by_id disagrees with the gathered "
                                 f"form at B={bb} C={cc} N={nn} D={dd}")
    # Yardstick: the two index gathers the by-id kernel spares the engine,
    # then torch.bmm on the candidates' rebuilt INT8 rows.
    lib_ms = _library_ms(
        "stage2_by_id",
        lambda: (db.msb_plane[cand], db.lsb_plane[cand],
                 torch.bmm(docs_f, q_col8))[2],
        stage2_int8_by_id(*by_id_args))
    uniq_cand = int(torch.unique(cand).numel())
    t_bound, by = bound_ms(2 * B * d2 + B * C * 4 + 2 * uniq_cand * d2
                           + B * C * 4, 2 * B * C * D)
    rows.append(dict(
        name="stage2_by_id", route="cuda",
        source="src/repro_torch/csrc/stage2_int8.cu",
        replaces="src/repro/kernels/stage2_int8.py:62",
        max_abs_err=err,
        ms=time_ms(lambda: stage2_int8_by_id(*by_id_args)),
        plain_ms=time_ms(lambda: ref.stage2_scores_by_id_ref(*by_id_args)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

    rows += _exact_stage_rows(db, q, cand.to(torch.int32), gen, dev)
    _check_widths(gen, dev)

    # -- gather: stage 1 over the cluster path's per-lane block tables, on --
    # the TMA kernel (the route at D = 512, 64-row blocks) and on dp4a.
    ids = _cluster_like_ids(gen, dev)
    j = ids.shape[1]
    r_view = j * BLOCK_ROWS
    view = bitplanar.expand_block_rows(ids, BLOCK_ROWS)
    uniq_rows = int(torch.unique(view[view < N]).numel())
    if not stage1_gather._tma_takes(N, d2, BLOCK_ROWS):
        raise AssertionError(f"the block gather at D={D} BR={BLOCK_ROWS} "
                             "does not take the TMA kernel")

    # Each route on the (B, D) nibble query, as `ops.stage1_scores_gather`
    # hands it over: the TMA kernel reads it in place, the dp4a route packs
    # it into [even; odd] panels first.
    def gather_on(route):
        def run(qm, plane, block_ids, br=BLOCK_ROWS):
            return stage1_gather._gather(qm, plane, block_ids, br,
                                         route=route)
        return run

    gather_tma, gather_dp4a = gather_on("tma"), gather_on("dp4a")

    def gather_plain(qm, plane, block_ids, br=BLOCK_ROWS):
        return ref.stage1_gather_batched_ref(ops.pack_queries_even_odd(qm),
                                             plane, block_ids, br)

    gather_args = (q_msb, db.msb_plane, ids)
    errs = {name: _check_kernel(name, fn, gather_plain, gather_args,
                                f"B={B} J={j} BR={BLOCK_ROWS} D={D}")
            for name, fn in (("stage1_gather", gather_tma),
                             ("stage1_gather_dp4a", gather_dp4a))}
    if not torch.equal(gather_tma(*gather_args), gather_dp4a(*gather_args)):
        raise AssertionError("the TMA gather disagrees with the dp4a gather "
                             f"at B={B} J={j} BR={BLOCK_ROWS} D={D}")
    for bb, nn, dd, br in ((1, 1000, 64, 64), (3, 4099, 200, 8),
                           (33, 777, 512, 32), (3, 300, 512, 64),
                           (33, 4099, 512, 128), (32, 777, 64, 256),
                           (3, 1000, 800, 64)):
        p = torch.randint(0, 256, (nn, dd // 2), generator=gen, device=dev,
                          dtype=torch.uint8)
        qm = torch.randint(-8, 8, (bb, dd), generator=gen, device=dev,
                           dtype=torch.int8)
        args = (qm, p, _ragged_ids(gen, dev, bb, nn, br))
        takes = stage1_gather._tma_takes(nn, dd // 2, br)
        routes = (("stage1_gather", gather_tma),) if takes else ()
        for name, fn in routes + (("stage1_gather_dp4a", gather_dp4a),):
            _check_kernel(name, lambda a, b_, c: fn(a, b_, c, br),
                          lambda a, b_, c: gather_plain(a, b_, c, br), args,
                          f"B={bb} N={nn} D={dd} BR={br}")
        log(f"kernel stage1_gather: B={bb} N={nn} D={dd} BR={br} route "
            f"{'tma' if takes else 'dp4a'}: bit-exact"
            f"{', and equal to dp4a' if takes else ''}")
    gathered, _ = bitplanar.gather_blocks(db.msb_plane, ids, BLOCK_ROWS)
    gat_f = bitplanar.unpack_nibble_plane_signed(
        gathered.reshape(B * r_view, d2)).reshape(B, r_view, D).float()
    lib_ms = _library_ms("stage1_gather", lambda: torch.bmm(gat_f, q_col),
                         gather_tma(*gather_args))
    del gathered, gat_f
    t_bound, by = bound_ms(2 * B * d2 + B * j * 4 + uniq_rows * d2
                           + B * r_view * 4, 2 * B * r_view * D)
    plain_ms = time_ms(lambda: gather_plain(*gather_args))
    for name, fn, source in (
            ("stage1_gather", gather_tma,
             "src/repro_torch/csrc/stage1_gather.cu"),
            ("stage1_gather_dp4a", gather_dp4a,
             "src/repro_torch/csrc/stage1_rows.cu")):
        rows.append(dict(
            name=name, route="cuda", source=source,
            replaces="src/repro/kernels/stage1_gather.py:65",
            max_abs_err=errs[name], ms=time_ms(lambda: fn(*gather_args)),
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=lib_ms))
    # Both gathers with none of their inputs in L2: a 256 MiB write (the
    # H100's L2 holds 50 MB) before each call, outside the timed kernel.
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def cold(fn):
        def run():
            flush.zero_()
            return fn(*gather_args)
        return run

    cold_us = {name: kernel_device_us(cold(fn), symbol)
               for name, fn, symbol in (
                   ("tma", gather_tma, "gather_tma_kernel"),
                   ("dp4a", gather_dp4a, "::gather_kernel<"))}
    del flush
    all_rows_ms, _ = bound_ms(2 * B * d2 + B * j * 4 + B * r_view * d2
                              + B * r_view * 4, 0)
    log(f"kernel stage1_gather cold L2: device_only_us {cold_us['tma']} "
        f"(dp4a {cold_us['dp4a']}; every gathered row read once from "
        f"device memory: {all_rows_ms * 1e3:.2f} us)")

    # -- sign gather: the prescreen over the same block tables, on both
    # routes (the bulk-copy kernel the shape takes, and the popcount one) --
    q_sign = ops.pack_query_signs(q)
    d8 = D // 8

    def sign(qs, plane, block_ids):
        return stage0_sign_gather(qs, plane, block_ids,
                                  block_rows=BLOCK_ROWS)

    def sign_bulk(qs, plane, block_ids):
        return stage0_sign_gather(qs, plane, block_ids,
                                  block_rows=BLOCK_ROWS, route="bulk")

    def sign_plain(qs, plane, block_ids):
        return ref.stage0_sign_gather_ref(qs, plane, block_ids, BLOCK_ROWS)

    sign_args = (q_sign, db.sign_plane, ids)
    if _sign_answer(db.sign_plane, BLOCK_ROWS) != 1:
        raise AssertionError("the bulk sign gather's launcher does not take "
                             "the cluster path's shape for the bulk route "
                             "only (its answer 1)")
    errs["stage0_sign_gather"] = _check_kernel(
        "stage0_sign_gather", sign, sign_plain, sign_args,
        f"B={B} J={j} BR={BLOCK_ROWS} D={D}")
    errs["stage0_sign_gather_bulk"] = _check_kernel(
        "stage0_sign_gather_bulk", sign_bulk, sign, sign_args,
        f"B={B} J={j} BR={BLOCK_ROWS} D={D} (bulk against popcount)")
    _check_kernel("stage0_sign_gather_bulk", sign_bulk, sign_plain,
                  sign_args, f"B={B} J={j} BR={BLOCK_ROWS} D={D}")
    # Ragged planes: N % BR rows of 16-byte multiples in the straddling
    # block (bulk), rows of 5 and 25 bytes (popcount only), ids past the
    # end.
    for bb, nn, dd, br in ((1, 1000, 64, 64), (3, 4099, 200, 8),
                           (33, 777, 512, 32), (3, 300, 40, 64),
                           (7, 64 * 50 + 16, 512, 64), (14, 16 * 30 + 2, 64,
                                                        16)):
        p = torch.randint(0, 256, (nn, dd // 8), generator=gen, device=dev,
                          dtype=torch.uint8)
        qs = ops.pack_query_signs(torch.randint(
            -128, 128, (bb, dd), generator=gen, device=dev,
            dtype=torch.int8))
        args = (qs, p, _ragged_ids(gen, dev, bb, nn, br))
        takes = _sign_answer(p, br) > 0
        routes = ("bulk", "popc") if takes else ("popc",)
        for route in routes:
            _check_kernel(f"stage0_sign_gather ({route})",
                          lambda a, b_, c: stage0_sign_gather(
                              a, b_, c, block_rows=br, route=route),
                          lambda a, b_, c: ref.stage0_sign_gather_ref(
                              a, b_, c, br),
                          args, f"B={bb} N={nn} D={dd} BR={br}")
        log(f"kernel stage0_sign_gather: B={bb} N={nn} D={dd} BR={br} "
            f"routes {'/'.join(routes)}: bit-exact"
            f"{', and equal to each other' if takes else ''}")
    gathered, _ = bitplanar.gather_blocks(db.sign_plane, ids, BLOCK_ROWS)
    sgn_f = bitplanar.unpack_sign_pm1(gathered).float()          # (B, R, D)
    q_sign_col = q_sign.float()[:, :, None]
    lib_ms = _library_ms("stage0_sign_gather",
                         lambda: torch.bmm(sgn_f, q_sign_col),
                         sign(*sign_args))
    del gathered, sgn_f
    t_bound, by = bound_ms(B * D + B * j * 4 + uniq_rows * d8
                           + B * r_view * 4, 2 * B * r_view * D)
    plain_ms = time_ms(lambda: sign_plain(*sign_args))
    for name, fn, source in (
            ("stage0_sign_gather", sign,
             "src/repro_torch/csrc/stage0_sign.cu"),
            ("stage0_sign_gather_bulk", sign_bulk,
             "src/repro_torch/csrc/stage0_sign_gather.cu")):
        rows.append(dict(
            name=name, route="cuda", source=source,
            replaces="src/repro/kernels/stage0_sign.py:113",
            max_abs_err=errs[name], ms=time_ms(lambda: fn(*sign_args)),
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=lib_ms))
    _sign_floor(gen, dev, D, BLOCK_ROWS, "cluster")

    device_only = {
        "stage1_plane_mma": kernel_device_us(
            lambda: plane_mma(panel, db.msb_plane), "::plane_mma_kernel<"),
        "stage1_plane": kernel_device_us(
            lambda: plane_dp4a(panel, db.msb_plane), "::plane_kernel<"),
        "stage1_rows": kernel_device_us(
            lambda: stage1_int4_rows(q_eo, win), "rows_kernel"),
        "stage2_exact": kernel_device_us(
            lambda: stage2_int8_batched(q_eo8, msb_rows, lsb_rows),
            "exact_kernel"),
        "stage2_by_id": kernel_device_us(
            lambda: stage2_int8_by_id(*by_id_args), "exact_kernel"),
        "stage1_gather": kernel_device_us(
            lambda: gather_tma(*gather_args), "gather_tma_kernel"),
        "stage1_gather_dp4a": kernel_device_us(
            lambda: gather_dp4a(*gather_args), "::gather_kernel<"),
        "stage0_sign_gather": kernel_device_us(
            lambda: sign(*sign_args), SIGN_POPC),
        "stage0_sign_gather_bulk": kernel_device_us(
            lambda: sign_bulk(*sign_args), SIGN_BULK),
    }
    notes = {
        "stage1_plane_mma": " (library yardstick: torch._int_mm on the "
                            "pre-unpacked int8 plane)",
        "stage1_plane": " (the dp4a kernel, which the main path no longer "
                        "takes at this shape; same yardstick)",
        "stage1_gather_dp4a": " (the dp4a kernel, which the cluster path no "
                              "longer takes at this shape; same yardstick)",
        "stage0_sign_gather_bulk": " (the bulk-copy kernel, which the "
                                   "cluster path does not take at this "
                                   "shape; same yardstick)",
        "stage2_by_id": " (library yardstick: the two index gathers of the "
                        "candidate rows, then torch.bmm on their pre-rebuilt "
                        "INT8 rows)"}
    for r in rows:
        if r["name"] not in device_only:
            continue            # the exact stage's rows: their own lines
        note = (" (library yardstick: one torch.bmm on the pre-gathered, "
                "pre-unpacked operand; it leaves out the gather)"
                if r["name"] in ("stage1_gather", "stage0_sign_gather")
                else notes.get(r["name"], ""))
        log(f"kernel {r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_us {r['bound_ms'] * 1e3:.2f} "
            f"({r['bound_by']}) library_ms {r['library_ms']} "
            f"device_only_us {device_only[r['name']]}"
            f"{_share(r['bound_ms'], device_only[r['name']])}{note}")
    log(f"kernel gathers: {uniq_rows} distinct plane rows of the "
        f"{B * r_view} gathered at B={B} J={j} BR={BLOCK_ROWS}")
    return rows


def _parent_stage(q, db, ids, member, k, metric):
    """The parent's exact stage, the yardstick of the one-launch kernel:
    the by-id kernel (#3 by id), then the norms gather, the pins, the
    rerank and the result's masking in plain PyTorch, as
    `ExactRescore.run` composed them."""
    exact = ops.stage2_scores_by_id(q, db.msb_plane, db.lsb_plane, ids)
    return ref.pin_and_rerank_ref(exact, ids, db.norms_sq, member, k=k,
                                  metric=metric)


def _stage_split(label: str, fn) -> None:
    """Launches and device microseconds of one call of `fn`, by kernel."""
    prof = device_profile(fn, reps=5)
    top = ", ".join(f"{n[:56]} x{c:.0f} {t:.1f}us" for n, t, c in prof[:6])
    log(f"kernel {label} split: {sum(c for _, _, c in prof):.0f} launches "
        f"of {len(prof)} kinds, device_us {sum(t for _, t, _ in prof):.1f} "
        f"per call; busiest: {top}")


RERANK_BY_ID, RERANK = "rerank_kernel<true", "rerank_kernel<false"


def _exact_stage_rows(db, q, cand, gen, dev) -> list[dict]:
    """The exact stage in one launch (`stage2_rerank_by_id`) and its
    ranking half (`stage2_rerank`): bit-exact against the plain versions at
    the main shape (B = 32, C = 50, D = 512, k = 5; cosine and MIPS,
    masked and not) and at ragged shapes (ids at -1 and past N, a lane
    with no member, k = C), then timed beside the parent's stage, with
    both splits by kernel and the one-block floor. library_ms is null: no
    single PyTorch call ranks by the non-division comparator."""
    d2 = D // 2
    member = torch.rand((B, C), generator=gen, device=dev) < 0.8
    member[0] = False
    errs = {}
    for metric in ("cosine", "mips"):
        for mask in (None, member):
            args = (q, db.msb_plane, db.lsb_plane, cand, db.norms_sq, mask)
            errs[metric, mask is None] = _check_kernel(
                "stage2_rerank_by_id",
                lambda *a: ops.exact_rerank_by_id(*a, k=K, metric=metric),
                lambda *a: ref.exact_rerank_by_id_ref(*a, k=K, metric=metric),
                args, f"B={B} C={C} D={D} k={K} {metric}, "
                f"{'un' if mask is None else ''}masked")
            want = _parent_stage(q, db, cand, mask, K, metric)
            got = ops.exact_rerank_by_id(*args, k=K, metric=metric)
            if any(not torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"stage2_rerank_by_id differs from the "
                                     f"parent's stage ({metric})")
    for bb, cc, nn, dd, kk in ((1, 1, 1000, 512, 1), (3, 50, 4099, 512, 50),
                               (7, 13, 777, 250, 5), (2, 64, 300, 8, 7),
                               (5, 257, 3000, 36, 5)):
        m = torch.randint(0, 256, (nn, dd // 2), generator=gen, device=dev,
                          dtype=torch.uint8)
        lo = torch.randint(0, 256, (nn, dd // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
        qq = torch.randint(-128, 128, (bb, dd), generator=gen, device=dev,
                           dtype=torch.int8)
        ii = torch.randint(-2, nn + 2, (bb, cc), generator=gen, device=dev,
                           dtype=torch.int32)
        ii[:, 0] = -1
        ii[:, -1] = nn
        nrm = torch.randint(0, 1 << 20, (nn,), generator=gen, device=dev,
                            dtype=torch.int32)
        nrm[: nn // 4] = 0
        mm = torch.rand((bb, cc), generator=gen, device=dev) < 0.6
        mm[0] = False
        for metric in ("cosine", "mips"):
            for mask in (None, mm):
                _check_kernel(
                    "stage2_rerank_by_id",
                    lambda *a: ops.exact_rerank_by_id(*a, k=kk,
                                                      metric=metric),
                    lambda *a: ref.exact_rerank_by_id_ref(*a, k=kk,
                                                          metric=metric),
                    (qq, m, lo, ii, nrm, mask),
                    f"B={bb} C={cc} N={nn} D={dd} k={kk} {metric}")
    # The ranking half on the sharded path's inputs: exact scores summed
    # over owners, pad candidates pinned to INT32_MIN with norm 1.
    scores = ops.stage2_scores_by_id(q, db.msb_plane, db.lsb_plane, cand)
    norms = db.norms_sq[cand.long()]
    scores[:, -3:] = INT32_MIN
    norms[:, -3:] = 1
    for metric in ("cosine", "mips"):
        errs[metric, "rerank"] = _check_kernel(
            "stage2_rerank",
            lambda *a: ops.rerank(*a, k=K, metric=metric),
            lambda *a: ref.rerank_ref(*a, k=K, metric=metric),
            (scores, norms, cand), f"B={B} C={C} k={K} {metric}")
        wide = torch.randint(INT32_MIN, 2 ** 31 - 1, (3, 2048), generator=gen,
                             device=dev, dtype=torch.int32)
        wide[:, ::5] = INT32_MIN
        wide_n = torch.randint(-2, 2 ** 31 - 1, (3, 2048), generator=gen,
                               device=dev, dtype=torch.int32)
        wide_n[:, ::7] = 0
        _check_kernel("stage2_rerank",
                      lambda *a: ops.rerank(*a, k=2048, metric=metric),
                      lambda *a: ref.rerank_ref(*a, k=2048, metric=metric),
                      (wide, wide_n, wide), f"B=3 C=2048 k=C {metric}")

    def stage(metric, mask=None, qq=q, ids=cand):
        return ops.exact_rerank_by_id(qq, db.msb_plane, db.lsb_plane, ids,
                                      db.norms_sq, mask, k=K, metric=metric)
    uniq = int(torch.unique(cand).numel())
    # Bytes: the query, ids, the unique candidate rows of both planes, their
    # norms, the outputs; operations: the INT8 dots (the C^2 integer
    # comparisons have no published peak and are left out).
    t_bound, by = bound_ms(B * D + B * C * 4 + 2 * uniq * d2 + uniq * 4
                           + 2 * B * K * 4 + B * C * 4, 2 * B * C * D)
    out = []
    for metric in ("cosine", "mips"):
        ms = time_ms(lambda: stage(metric))
        parent_ms = time_ms(lambda: _parent_stage(q, db, cand, None, K,
                                                  metric))
        dev_us = kernel_device_us(lambda: stage(metric), RERANK_BY_ID)
        masked_us = kernel_device_us(lambda: stage(metric, member),
                                     RERANK_BY_ID)
        floor_us = "not measured"
        for _ in range(3):      # a short trace can miss the one kernel (C6)
            floor_us = kernel_device_us(
                lambda: stage(metric, None, q[:1], cand[:1]), RERANK_BY_ID)
            if floor_us != "not measured":
                break
        _stage_split(f"stage2_rerank_by_id {metric} (parent's stage)",
                     lambda: _parent_stage(q, db, cand, None, K, metric))
        _stage_split(f"stage2_rerank_by_id {metric} (this stage)",
                     lambda: stage(metric))
        log(f"kernel stage2_rerank_by_id {metric}: kernel_ms {ms:.4f} "
            f"parent_stage_ms {parent_ms:.4f} ({parent_ms / ms:.1f}x) "
            f"device_only_us {dev_us} (masked {masked_us}; one block, B = "
            f"1: {floor_us}) bound_us {t_bound * 1e3:.4f} ({by})"
            f"{_share(t_bound, dev_us)}; B={B} C={C} D={D} k={K}, "
            f"{uniq} distinct rows; bit-exact masked and not")
        if metric == "cosine":
            out.append(dict(
                name="stage2_rerank_by_id", route="cuda",
                source="src/repro_torch/csrc/stage2_rerank.cu",
                replaces="src/repro/kernels/stage2_int8.py:62",
                max_abs_err=max(errs[m, u] for m in ("cosine", "mips")
                                for u in (True, False)),
                ms=ms, plain_ms=time_ms(lambda: ref.exact_rerank_by_id_ref(
                    q, db.msb_plane, db.lsb_plane, cand, db.norms_sq, None,
                    k=K, metric="cosine")),
                bound_ms=t_bound, bound_by=by, library_ms=None))
    r_bound, r_by = bound_ms(3 * B * C * 4 + 2 * B * K * 4, 0)
    def rerank(metric):
        return ops.rerank(scores, norms, cand, k=K, metric=metric)
    r_ms = time_ms(lambda: rerank("cosine"))
    r_us = kernel_device_us(lambda: rerank("cosine"), RERANK)
    log(f"kernel stage2_rerank cosine: kernel_ms {r_ms:.4f} device_only_us "
        f"{r_us} bound_us {r_bound * 1e3:.4f} ({r_by}){_share(r_bound, r_us)}"
        f"; MIPS kernel_ms {time_ms(lambda: rerank('mips')):.4f}; B={B} "
        f"C={C} k={K}, 3 pad pins a lane; bit-exact, also at C = 2048 over "
        "the whole int32 range")
    out.append(dict(
        name="stage2_rerank", route="cuda",
        source="src/repro_torch/csrc/stage2_rerank.cu",
        replaces="src/repro/kernels/stage2_int8.py:62",
        max_abs_err=max(errs["cosine", "rerank"], errs["mips", "rerank"]),
        ms=r_ms, plain_ms=time_ms(lambda: ref.rerank_ref(
            scores, norms, cand, k=K, metric="cosine")),
        bound_ms=r_bound, bound_by=r_by, library_ms=None))
    return out


WIDTHS = (8, 36, 64, 200, 250, 1536, 8192, 262144)


def _check_widths(gen, dev) -> None:
    """The plane (by its shape rule and on dp4a), rows, gather, exact (both
    forms) and fused kernels at every kind of width: one partial 64-byte
    chunk (D = 8, 200), rows that are not whole words (36, 250: read byte
    by byte), 16-byte loads (64, 1536, 8192; at B = 5 the tensor-core plane
    kernel, with a partial 128-byte slab at 64), shared-memory panels past
    the 48 KiB default (8192, where both plane kernels' lane tiles also
    shrink; B = 40 spans more than one tile), and panels past what a block
    holds (262,144: walked through shared memory, on dp4a)."""
    for dd in WIDTHS:
        d2 = dd // 2
        for bb in (1, 5) + ((40,) if dd == 8192 else ()):
            p = torch.randint(0, 256, (1000, d2), generator=gen, device=dev,
                              dtype=torch.uint8)
            qp = torch.randint(-8, 8, (2, bb, d2), generator=gen, device=dev,
                               dtype=torch.int8)
            for label, fn in (
                    (f"auto: {_route(bb, d2)}", stage1_int4_batched),
                    ("dp4a", lambda a, b_: stage1_int4._plane(
                        a, b_, DEFAULT_ROWS, route="dp4a"))):
                _check_kernel(f"stage1_plane ({label})", fn,
                              ref.stage1_scores_batched_ref, (qp, p),
                              f"B={bb} N=1000 D={dd}")
            qe = qp.transpose(0, 1).contiguous()
            for blk in (300, 256):
                route = _fused_route(bb, d2, blk)
                _check_kernel(f"fused_topk (auto: {route})",
                              lambda a, b_: fused_topk_batched(a, b_, k=5,
                                                               block_n=blk),
                              lambda a, b_: ref.fused_topk_batched_ref(
                                  a, b_, blk, 5), (qe, p),
                              f"B={bb} N=1000 D={dd} block_n={blk} k=5")
            tma = stage1_gather._tma_takes(1000, d2, 64)
            for label, fn in (
                    (f"auto: {'tma' if tma else 'dp4a'}",
                     lambda a, b_, c: stage1_int4_gather(a, b_, c,
                                                         block_rows=64)),
                    ("dp4a", lambda a, b_, c: stage1_gather._gather(
                        a, b_, c, 64, route="dp4a"))):
                _check_kernel(f"stage1_gather ({label})", fn,
                              lambda a, b_, c: ref.stage1_gather_batched_ref(
                                  a, b_, c, 64),
                              (qe, p, _ragged_ids(gen, dev, bb, 1000, 64)),
                              f"B={bb} N=1000 D={dd} BR=64")
            r = torch.randint(0, 256, (bb, 77, d2), generator=gen,
                              device=dev, dtype=torch.uint8)
            _check_kernel("stage1_rows", stage1_int4_rows,
                          ref.stage1_rows_batched_ref, (qe, r),
                          f"B={bb} W=77 D={dd}")
            m = torch.randint(0, 256, (bb, 13, d2), generator=gen,
                              device=dev, dtype=torch.uint8)
            lo = torch.randint(0, 256, (bb, 13, d2), generator=gen,
                               device=dev, dtype=torch.uint8)
            q8 = torch.randint(-128, 128, (bb, 2, d2), generator=gen,
                               device=dev, dtype=torch.int8)
            _check_kernel("stage2_exact", stage2_int8_batched,
                          ref.stage2_scores_batched_ref, (q8, m, lo),
                          f"B={bb} C=13 D={dd}")
            ids = torch.randint(-1, 1001, (bb, 13), generator=gen,
                                device=dev, dtype=torch.int32)
            _check_kernel("stage2_by_id", stage2_int8_by_id,
                          ref.stage2_scores_by_id_ref, (q8, p, p, ids),
                          f"B={bb} C=13 N=1000 D={dd}")
    log(f"widths: plane (tensor-core and dp4a), fused (block_n = 300 on dp4a, "
        f"256 on the tensor cores where D/2 % 16 == 0 and B > 1), gather "
        f"(TMA where D/2 % 16 == 0, and dp4a), "
        f"rows, exact and by-id exact kernels bit-exact at D in {WIDTHS} "
        "(B = 1, 5; "
        "B = 40 at D = 8192)")


def _cluster_like_ids(gen, dev) -> torch.Tensor:
    """(B, NPROBE * MB) block ids laid out as the cluster path lays them:
    each lane probes NPROBE random clusters of MB = CLUSTER_ROWS /
    BLOCK_ROWS contiguous blocks."""
    mb = CLUSTER_ROWS // BLOCK_ROWS
    picks = torch.randint(0, N // CLUSTER_ROWS, (B, NPROBE), generator=gen,
                          device=dev)
    return (picks[:, :, None] * mb + torch.arange(mb, device=dev)).reshape(
        B, -1).to(torch.int32)


def _ragged_ids(gen, dev, b: int, n: int, br: int) -> torch.Tensor:
    """(b, 6) random block ids over an n-row plane; the last column is the
    final, partial block, so rows past n are gathered."""
    nb = -(-n // br)
    ids = torch.randint(0, nb, (b, 6), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[:, -1] = nb - 1
    return ids


def _fused_library(scores_fn, nb: int):
    """The fused kernel's yardstick: a stage-1 scan, then `torch.topk` of
    each block (its values are the fused kernel's scores; its ids may
    order ties otherwise)."""
    def run():
        s = scores_fn()
        return torch.topk(s.reshape(*s.shape[:-1], nb, FUSED_BLOCK), FUSED_K,
                          dim=-1)
    return run


def _sparse_owner(gen, dev, n: int, tenants: int = 3) -> torch.Tensor:
    """Random owners with a fully unowned first block of 64 rows and
    tenant 1 holding just 3 rows (k above its live rows)."""
    owner = torch.randint(0, tenants, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    owner[owner == 1] = 0
    owner[torch.randperm(n - 64, generator=gen, device=dev)[:3] + 64] = 1
    owner[:64] = -1
    return owner


def phase_new_kernels(db, q_codes, gold, dev) -> list[dict]:
    """Table rows 4, 5, 7, 9 and 10 (this slice's kernels) against their
    plain versions on the card, bit-exact at the arena corpus's full width
    and at ragged shapes (N not a block multiple, B = 1, 3, 33, k above the
    live rows and above block_n, D % 8 != 0), timed like the first
    slices' kernels; #7 and #9 on both of their kernels."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rand(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    q = q_codes[:B]
    q_msb = quantization.msb_nibble(q)
    d2 = D // 2
    nb = N // FUSED_BLOCK
    rows = []

    # -- stage1_single: one query over the plane (#4) ---------------------
    q1 = ops.pack_query_even_odd(q_msb[0])
    err = _check_kernel("stage1_single", stage1_int4_single,
                        ref.stage1_scores_ref, (q1, db.msb_plane),
                        f"N={N} D={D}")
    for nn, dd in ((1000, 512), (4099, 36), (777, 250)):
        _check_kernel("stage1_single", stage1_int4_single,
                      ref.stage1_scores_ref,
                      (rand((2, dd // 2), -8, 8, torch.int8),
                       rand((nn, dd // 2), 0, 256, torch.uint8)),
                      f"N={nn} D={dd}")
    plane_f = bitplanar.unpack_nibble_plane_signed(db.msb_plane).float()
    q1_f = q_msb[0].float()
    lib_ms = _library_ms("stage1_single", lambda: torch.mv(plane_f, q1_f),
                         stage1_int4_single(q1, db.msb_plane))
    del plane_f
    t_bound, by = bound_ms(2 * d2 + N * d2 + N * 4, 2 * N * D)
    rows.append(dict(
        name="stage1_single", route="cuda",
        source="src/repro_torch/csrc/stage1_plane.cuh",
        replaces="src/repro/kernels/stage1_int4.py:144", max_abs_err=err,
        ms=time_ms(lambda: stage1_int4_single(q1, db.msb_plane)),
        plain_ms=time_ms(lambda: ref.stage1_scores_ref(q1, db.msb_plane)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

    # -- fused_topk_single: one query, per-block top-k (#10) ---------------
    def fused1(a, p):
        return fused_topk_single(a, p, k=FUSED_K, block_n=FUSED_BLOCK)

    def fused1_plain(a, p):
        return ref.fused_topk_ref(a, p, FUSED_BLOCK, FUSED_K)

    err = _check_kernel("fused_topk_single", fused1, fused1_plain,
                        (q1, db.msb_plane),
                        f"N={N} D={D} block_n={FUSED_BLOCK} k={FUSED_K}")
    for nn, dd, blk, kk in ((1000, 512, 512, 8), (300, 64, 8, 12),
                            (4099, 250, 512, 8)):
        _check_kernel("fused_topk_single",
                      lambda a, p: fused_topk_single(a, p, k=kk, block_n=blk),
                      lambda a, p: ref.fused_topk_ref(a, p, blk, kk),
                      (rand((2, dd // 2), -8, 8, torch.int8),
                       rand((nn, dd // 2), 0, 256, torch.uint8)),
                      f"N={nn} D={dd} block_n={blk} k={kk}")
    lib = _fused_library(lambda: stage1_int4_single(q1, db.msb_plane), nb)
    got = fused1(q1, db.msb_plane)
    if not torch.equal(lib().values, got[0]):
        raise AssertionError("fused_topk_single: the yardstick's top-k "
                             "values differ from the kernel's")
    t_bound, by = bound_ms(2 * d2 + N * d2 + 2 * nb * FUSED_K * 4,
                           2 * N * D)
    rows.append(dict(
        name="fused_topk_single", route="cuda",
        source="src/repro_torch/csrc/fused_topk.cu",
        replaces="src/repro/kernels/fused_topk.py:132", max_abs_err=err,
        ms=time_ms(lambda: fused1(q1, db.msb_plane)),
        plain_ms=time_ms(lambda: fused1_plain(q1, db.msb_plane)),
        bound_ms=t_bound, bound_by=by, library_ms=time_ms(lib)))

    # -- stage2_single: one query's exact rescore (#5) ---------------------
    cand = torch.randint(0, N, (C,), generator=gen, device=dev)
    mr, lr = db.msb_plane[cand], db.lsb_plane[cand]
    q81 = ops.pack_query_even_odd(q[0])
    err = _check_kernel("stage2_single", stage2_int8_single,
                        ref.stage2_scores_ref, (q81, mr, lr),
                        f"C={C} D={D}")
    for cc, dd in ((1, 512), (13, 36), (50, 250)):
        _check_kernel("stage2_single", stage2_int8_single,
                      ref.stage2_scores_ref,
                      (rand((2, dd // 2), -128, 128, torch.int8),
                       rand((cc, dd // 2), 0, 256, torch.uint8),
                       rand((cc, dd // 2), 0, 256, torch.uint8)),
                      f"C={cc} D={dd}")
    docs_f = bitplanar.reconstruct_int8(mr, lr).float()
    q8_f = q[0].float()
    lib_ms = _library_ms("stage2_single", lambda: torch.mv(docs_f, q8_f),
                         stage2_int8_single(q81, mr, lr))
    t_bound, by = bound_ms(2 * d2 + 2 * C * d2 + C * 4, 2 * C * D)
    rows.append(dict(
        name="stage2_single", route="cuda",
        source="src/repro_torch/csrc/stage2_int8.cu",
        replaces="src/repro/kernels/stage2_int8.py:88", max_abs_err=err,
        ms=time_ms(lambda: stage2_int8_single(q81, mr, lr)),
        plain_ms=time_ms(lambda: ref.stage2_scores_ref(q81, mr, lr)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

    # -- stage0_sign_plane: the dense sign scan (#7), on both of its
    # kernels: tensor-core (the route at B = 32, D = 512) and popcount.
    q_sign = ops.pack_query_signs(q)
    ops.reset_launch_counts()
    auto = stage0_sign_batched(q_sign, db.sign_plane)
    if ops.launch_counts()["stage0_sign_plane_mma"] != 1:
        raise AssertionError(f"the dense sign scan at B={B} D={D} did not "
                             "take the tensor-core kernel")

    def sign_on(route):
        def run(a, p, tile_rows=DEFAULT_ROWS):
            return stage0_sign._sign_plane(a, p, tile_rows, route=route)
        return run

    sign_mma, sign_popc = sign_on("mma"), sign_on("popc")
    sign_routes = (("stage0_sign_plane_mma", sign_mma, "sign_mma_kernel"),
                   ("stage0_sign_plane", sign_popc, "sign_plane_kernel"))
    errs = {name: _check_kernel(name, fn, ref.stage0_sign_batched_ref,
                                (q_sign, db.sign_plane), f"B={B} N={N} D={D}")
            for name, fn, _ in sign_routes}
    if not torch.equal(auto, sign_popc(q_sign, db.sign_plane)):
        raise AssertionError("stage0_sign_plane_mma disagrees with the "
                             f"popcount kernel at B={B} N={N} D={D}")
    for tile_rows in stage1_int4.ROWS_CHOICES:
        if not torch.equal(sign_mma(q_sign, db.sign_plane, tile_rows), auto):
            raise AssertionError("stage0_sign_plane_mma at "
                                 f"{tile_rows} rows per tile changed a "
                                 "result")
    for bb, nn, dd in ((1, 1000, 512), (3, 4099, 40), (33, 777, 96),
                       (2, 1, 128), (3, 4099, 384), (33, 20001, 640),
                       (9, 3001, 1152), (32, 5001, 4096)):
        qs = ops.pack_query_signs(rand((bb, dd), -128, 128, torch.int8))
        p = rand((nn, dd // 8), 0, 256, torch.uint8)
        takes = bool(stage0_sign._mma_lanes(bb, nn, dd // 8, DEFAULT_ROWS))
        for name, fn, _ in sign_routes[0 if takes else 1:]:
            _check_kernel(name, fn, ref.stage0_sign_batched_ref, (qs, p),
                          f"B={bb} N={nn} D={dd}")
        if takes and not torch.equal(sign_mma(qs, p), sign_popc(qs, p)):
            raise AssertionError("stage0_sign_plane_mma disagrees with the "
                                 f"popcount kernel at B={bb} N={nn} D={dd}")
        log(f"kernel stage0_sign_plane: B={bb} N={nn} D={dd} route "
            f"{'mma' if takes else 'popc'}: bit-exact"
            f"{', and equal to popcount' if takes else ''}")
    sgn_f = bitplanar.unpack_sign_pm1(db.sign_plane).float()    # (N, D)
    q_sign_f = q_sign.float()
    lib_ms = _library_ms("stage0_sign_plane",
                         lambda: torch.mm(q_sign_f, sgn_f.t()), auto)
    del sgn_f
    t_bound, by = bound_ms(B * D + N * D // 8 + B * N * 4, 2 * B * N * D)
    plain_ms = time_ms(lambda: ref.stage0_sign_batched_ref(q_sign,
                                                           db.sign_plane))
    for name, fn, _ in sign_routes:
        rows.append(dict(
            name=name, route="cuda",
            source=("src/repro_torch/csrc/stage0_sign_mma.cu"
                    if fn is sign_mma else
                    "src/repro_torch/csrc/stage0_sign.cu"),
            replaces="src/repro/kernels/stage0_sign.py:73",
            max_abs_err=errs[name],
            ms=time_ms(lambda: fn(q_sign, db.sign_plane)),
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=lib_ms))

    # -- fused_topk: the batched fused scan, masked and unmasked (#9), on
    # both of its kernels: tensor-core (the route at B = 32, D = 512,
    # block_n = 512) and dp4a.
    q_eo = ops.pack_queries_even_odd(q_msb)
    owner = (torch.arange(N, device=dev) // DOCS_PER_USER).to(torch.int32)
    tids = (gold[:B] // DOCS_PER_USER).to(torch.int32)
    tids[-1] = -1                                       # a padding lane
    if not fused_topk._fused_mma_lanes(B, d2, FUSED_BLOCK, FUSED_K):
        raise AssertionError(f"the fused top-k at B={B} D={D} block_n="
                             f"{FUSED_BLOCK} does not take the tensor-core "
                             "kernel")

    def fused_on(route):
        def run(a, p, o=None, t=None, k=FUSED_K, blk=FUSED_BLOCK):
            return fused_topk._fused(a, p, o, t, k, blk, route=route)
        return run

    fused_mma, fused_dp4a = fused_on("mma"), fused_on("dp4a")

    def fused_plain(a, p, o=None, t=None, k=FUSED_K, blk=FUSED_BLOCK):
        return ref.fused_topk_batched_ref(a, p, blk, k, o, t)

    full_args = ((q_eo, db.msb_plane), (q_eo, db.msb_plane, owner, tids))
    errs = {}
    for name, fn in (("fused_topk_mma", fused_mma),
                     ("fused_topk", fused_dp4a)):
        errs[name] = max(
            _check_kernel(name, fn, fused_plain, args, f"B={B} N={N} D={D} "
                          + (f"masked, {USERS} tenants" if len(args) > 2
                             else "unmasked"))
            for args in full_args)
    for args in full_args:
        got, other = fused_mma(*args), fused_dp4a(*args)
        if not (torch.equal(got[0], other[0])
                and torch.equal(got[1], other[1])):
            raise AssertionError("fused_topk_mma disagrees with the dp4a "
                                 f"fused kernel at B={B} N={N} D={D}")
    for bb, nn, dd, blk, kk in ((3, 1000, 512, 512, 8),
                                (33, 4099, 256, 64, 70),
                                (1, 777, 36, 100, 8),
                                (9, 4099, 1024, 256, 50),
                                (33, 3001, 512, 1024, 9),
                                (2, 77, 64, 128, 130)):
        qe = rand((bb, 2, dd // 2), -8, 8, torch.int8)
        p = rand((nn, dd // 2), 0, 256, torch.uint8)
        o = _sparse_owner(gen, dev, nn)
        t = torch.arange(bb, device=dev, dtype=torch.int32) % 3
        t[-1] = -1 if bb > 1 else 1
        takes = bool(fused_topk._fused_mma_lanes(bb, dd // 2, blk, kk))
        for args in ((qe, p), (qe, p, o, t)):
            note = (f"B={bb} N={nn} D={dd} block_n={blk} k={kk} "
                    f"{'masked' if len(args) > 2 else 'unmasked'}")
            routes = (("fused_topk_mma", fused_mma),) if takes else ()
            for name, fn in routes + (("fused_topk", fused_dp4a),):
                _check_kernel(name, lambda *a: fn(*a, k=kk, blk=blk),
                              lambda *a: fused_plain(*a, k=kk, blk=blk), args,
                              note)
        log(f"kernel fused_topk: B={bb} N={nn} D={dd} block_n={blk} k={kk} "
            f"route {'mma' if takes else 'dp4a'}: bit-exact, masked and "
            f"unmasked{', and equal to dp4a' if takes else ''}")
    panel = ops.pack_query_panel(q_msb)
    lib = _fused_library(lambda: stage1_int4_batched(panel, db.msb_plane), nb)
    if not torch.equal(lib().values, fused_mma(q_eo, db.msb_plane)[0]):
        raise AssertionError("fused_topk: the yardstick's top-k values "
                             "differ from the kernel's")
    # k_per_block = c: the fused candidates are the stable top-c of the
    # masked plane-kernel scores, lane for lane (every live lane holds
    # 2048 rows; the padding lane's are all masked); at this shape they
    # take the tensor-core kernel.
    ops.reset_launch_counts()

    def fused_cands():
        return ops.fused_candidates_batched(q_msb, db.msb_plane, owner, tids,
                                            c=C, k_per_block=C,
                                            block_n=FUSED_BLOCK)
    cands = fused_cands()
    if ops.launch_counts()["fused_topk_mma"] != 1:
        raise AssertionError("fused_candidates_batched did not take the "
                             "tensor-core fused kernel")
    scores = stage1_int4_batched(panel, db.msb_plane)
    member = (owner[None, :] == tids[:, None]) & (tids >= 0)[:, None]
    _, dense = stable_topk(scores.masked_fill(~member, -(2 ** 31)), C)
    live = tids >= 0
    if not torch.equal(cands[live], dense[live].to(torch.int32)):
        raise AssertionError("fused_candidates_batched differs from the "
                             "stable top-c of the masked plane scores")
    del scores, member, dense
    log(f"kernel fused_topk: fused_candidates_batched (k_per_block = c = {C}) "
        f"equals the masked plane kernel's stable top-{C} in all "
        f"{int(live.sum())} live lanes: kernel_ms "
        f"{time_ms(fused_cands):.4f} device_only_us "
        f"{kernel_device_us(fused_cands, '::fused_mma_kernel<')} "
        "(tensor-core kernel at k = 50, then the cross-block merge)")
    t_bound, by = bound_ms(B * D + N * d2 + 2 * B * nb * FUSED_K * 4,
                           2 * B * N * D)
    lib_ms = time_ms(lib)
    for name, fn in (("fused_topk_mma", fused_mma),
                     ("fused_topk", fused_dp4a)):
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/fused_topk.cu",
            replaces="src/repro/kernels/fused_topk.py:86",
            max_abs_err=errs[name],
            ms=time_ms(lambda: fn(q_eo, db.msb_plane)),
            plain_ms=time_ms(lambda: fused_plain(q_eo, db.msb_plane)),
            bound_ms=t_bound, bound_by=by, library_ms=lib_ms))
    # Scoring against selection: each kernel unmasked and masked at k = 8
    # and k = 1 (one pick per lane and block), event and device-only time.
    for name, fn, symbol in (
            ("fused_topk_mma", fused_mma, "::fused_mma_kernel<"),
            ("fused_topk", fused_dp4a, "::fused_kernel<")):
        for kk in (FUSED_K, 1):
            for label, args in (("unmasked", full_args[0]),
                                ("masked", full_args[1])):
                bound_k, _ = bound_ms(
                    B * D + N * d2 + 2 * B * nb * kk * 4
                    + (N * 4 + B * 4 if len(args) > 2 else 0), 2 * B * N * D)
                log(f"kernel {name} split: k={kk} {label}: kernel_ms "
                    f"{time_ms(lambda: fn(*args, k=kk)):.4f} device_only_us "
                    f"{kernel_device_us(lambda: fn(*args, k=kk), symbol)} "
                    f"bound_us {bound_k * 1e3:.2f}")

    device_only = {
        "stage1_single": kernel_device_us(
            lambda: stage1_int4_single(q1, db.msb_plane), "::plane_kernel<"),
        "fused_topk_single": kernel_device_us(
            lambda: fused1(q1, db.msb_plane), "fused_kernel"),
        "stage2_single": kernel_device_us(
            lambda: stage2_int8_single(q81, mr, lr), "exact_kernel"),
        **{name: kernel_device_us(lambda: fn(q_sign, db.sign_plane), symbol)
           for name, fn, symbol in sign_routes},
        "fused_topk_mma": kernel_device_us(
            lambda: fused_mma(q_eo, db.msb_plane), "::fused_mma_kernel<"),
        "fused_topk": kernel_device_us(
            lambda: fused_dp4a(q_eo, db.msb_plane), "::fused_kernel<"),
    }
    yardstick = (" (library yardstick: the plane scan, on the tensor-core "
                 "kernel at this B, then torch.topk of each block)")
    for r in rows:
        note = {"fused_topk_mma": yardstick,
                "fused_topk": " (the dp4a kernel, which this shape no longer "
                              "takes; same yardstick)",
                "stage0_sign_plane": " (the popcount kernel, which this "
                                     "shape no longer takes; same "
                                     "yardstick)",
                "fused_topk_single": " (library yardstick: the plane kernel "
                                     "at B = 1, then torch.topk of each "
                                     "block)"}.get(r["name"], "")
        log(f"kernel {r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_us {r['bound_ms'] * 1e3:.2f} "
            f"({r['bound_by']}) library_ms {r['library_ms']} "
            f"device_only_us {device_only[r['name']]}"
            f"{_share(r['bound_ms'], device_only[r['name']])}{note}")
    return rows


def _serve_single(db, q_codes, dev) -> list:
    """One query at a time through the single-query entry points: the
    fused candidates (k_per_block = c, so exact), the dense single-query
    scan's stable top-c (which they must equal), then the exact rescore of
    the candidates and its top-k (MIPS)."""
    out = []
    lat = []
    for i in range(SINGLE_QUERIES):
        qc = q_codes[i]
        q_msb = quantization.msb_nibble(qc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cand = ops.fused_candidates(q_msb, db.msb_plane, c=C, k_per_block=C)
        _, dense = stable_topk(ops.stage1_scores(q_msb, db.msb_plane), C)
        safe = cand.long()
        exact = ops.stage2_scores(qc, db.msb_plane[safe], db.lsb_plane[safe])
        top_scores, top = stable_topk(exact, K)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        out.append((cand, dense, cand[top], top_scores))
    log(f"single-query path: {SINGLE_QUERIES} queries, p50 "
        f"{statistics.median(lat) * 1e3:.3f} ms per query (fused "
        f"candidates + single-query scan + exact rescore)")
    return out


def phase_autotune(qdb, db, q_codes, gold, dev) -> dict[str, int]:
    """This slice's path, with the launch counts set to 0 just before and
    read just after: the measured autotuner on the card and single
    queries through the single-query entry points. Then the table's
    checks, and Plain and Masked batches served with it installed."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    table = autotune.autotune(n=N, d=D, batches=(1, 8, 32), reps=5,
                              device=dev, verbose=True)
    tune_s = time.perf_counter() - t0
    singles = _serve_single(db, q_codes, dev)
    launches = ops.launch_counts()
    log(f"autotune path launches (autotune over N={N} D={D} at B = 1, 8, 32 "
        f"in {tune_s:.1f} s, then {SINGLE_QUERIES} single queries): "
        f"{launches}")
    for key in TUNE_KERNELS:
        if launches[key] <= 0:
            raise AssertionError(f"kernel {key} was not launched by the "
                                 "autotune path")

    mips = RetrievalEngine(RetrievalConfig(k=K, metric="mips"), dev)
    for i, (cand, dense, idx, scores) in enumerate(singles):
        if not torch.equal(cand, dense.to(torch.int32)):
            raise AssertionError(f"single query {i}: fused candidates differ "
                                 "from the single-query scan's top-c")
        want = mips.retrieve_single(q_codes[i], db)
        if not (torch.equal(idx, want.indices)
                and torch.equal(scores, want.scores)
                and torch.equal(cand, want.candidate_indices)):
            raise AssertionError(f"single query {i}: the single-query path "
                                 "differs from the engine's B = 1 result")
    log(f"single-query path: {SINGLE_QUERIES} results equal the engine's "
        "B = 1 MIPS results (candidates, indices, scores)")

    for key, e in sorted(table.entries.items()):
        log(f"autotune {key}: block {e['block_n']} (default "
            f"{e['default_block_n']}, speedup {e['speedup_vs_default']:.4f}) "
            f"timings_ms {e['timings_ms']} left_out "
            f"{sorted(e.get('left_out', {}), key=int)}")
        if e["speedup_vs_default"] < 1.0:
            raise AssertionError(f"autotune {key}: speedup "
                                 f"{e['speedup_vs_default']} < 1.0")
    path = os.path.join(ROOT, "BENCH_autotune_torch.json")
    table.save(path)
    back = autotune.load(path, dev)
    if back is None or back.entries != table.entries:
        raise AssertionError("the saved table did not load back whole")
    obj = table.to_json()
    obj["signature"]["device_kind"] += " (altered)"
    altered = os.path.join(ROOT, "BENCH_autotune_torch_altered.json")
    with open(altered, "w") as f:
        json.dump(obj, f)
    if autotune.load(altered, dev) is not None:
        raise AssertionError("a table with an altered device_kind loaded")
    os.remove(altered)

    # The tuned and the default wrappers give the same bits.
    win = db.msb_plane[:B * DOCS_PER_USER].reshape(B, DOCS_PER_USER, D // 2)
    q_sign = ops.pack_query_signs(q_codes[:B])
    calls = {
        "stage1_single": lambda bn: ops.stage1_scores(
            quantization.msb_nibble(q_codes[0]), db.msb_plane, block_n=bn),
        "stage1_batched": lambda bn, b: ops.stage1_scores_batched(
            quantization.msb_nibble(q_codes[:b]), db.msb_plane, block_n=bn),
        "stage1_rows": lambda bn, b: ops.stage1_scores_rows(
            quantization.msb_nibble(q_codes[:b]), win[:b], block_w=bn),
        "stage0_sign": lambda bn, b: ops.stage0_sign_scores_batched(
            q_sign[:b], db.sign_plane, block_n=bn),
        "fused_topk": lambda bn, b: ops.fused_candidates_batched(
            quantization.msb_nibble(q_codes[:b]), db.msb_plane, c=16,
            k_per_block=16, block_n=bn),
    }
    os.environ[autotune.ENV_CACHE] = path
    autotune.clear_installed()
    autotune._load_env_cache.cache_clear()
    RetrievalEngine(RetrievalConfig(k=K), dev)     # installs the artifact
    if autotune.installed() is None or \
            autotune.installed().entries != table.entries:
        raise AssertionError("the engine did not install the saved table")
    for key, e in table.entries.items():
        b, default = e["batch_bucket"], e["default_block_n"]
        if e["kernel"] == "stage1_single":
            same = torch.equal(calls["stage1_single"](None),
                               calls["stage1_single"](default))
        else:
            fn = calls[e["kernel"]]
            same = torch.equal(fn(None, b), fn(default, b))
        if not same:
            raise AssertionError(f"autotune {key}: the tuned block "
                                 f"{e['block_n']} changed a result")
    log("autotune: the table saved, reloaded and installed by an engine "
        "through REPRO_TORCH_AUTOTUNE_CACHE; a copy with an altered "
        "device_kind was refused; tuned and default wrappers bit-identical "
        f"in all {len(table.entries)} entries")

    # Plain and Masked served with the table installed == untuned.
    variants = [v for v in _variants(gold, dev)
                if v[0] in ("plain_cosine", "plain_mips", "masked")]
    tuned = {}
    for name, cfg, policy_for in variants:
        engine = RetrievalEngine(cfg, dev)
        tuned[name] = [engine.retrieve(q_codes[i * B:(i + 1) * B], db,
                                       policy_for(slice(i * B, (i + 1) * B)))
                       for i in range(3)]
    del os.environ[autotune.ENV_CACHE]
    autotune.clear_installed()
    for name, cfg, policy_for in variants:
        engine = RetrievalEngine(cfg, dev)
        for i, got in enumerate(tuned[name]):
            sl = slice(i * B, (i + 1) * B)
            want = engine.retrieve(q_codes[sl], db, policy_for(sl))
            for field in ("indices", "scores", "candidate_indices"):
                if not torch.equal(getattr(got, field), getattr(want, field)):
                    raise AssertionError(f"{name} batch {i}: {field} with the "
                                         "tuned table differs from untuned")
    log("autotune: Plain (cosine, MIPS) and Masked batches served with the "
        "tuned table installed are bit-identical to the untuned ones")
    return launches


def _variants(gold: torch.Tensor, dev: torch.device):
    owner = (torch.arange(N, device=dev) // DOCS_PER_USER).to(torch.int32)
    tids = (gold // DOCS_PER_USER).to(torch.int32)
    return [
        ("plain_cosine", RetrievalConfig(k=K, metric="cosine"),
         lambda sl: PlainPolicy()),
        ("plain_mips", RetrievalConfig(k=K, metric="mips"),
         lambda sl: PlainPolicy()),
        ("masked", RetrievalConfig(k=K),
         lambda sl: MaskedPolicy(owner=owner, tenant_ids=tids[sl])),
        ("windowed", RetrievalConfig(k=K),
         lambda sl: WindowedPolicy(owner=owner, tenant_ids=tids[sl],
                                   starts=tids[sl] * DOCS_PER_USER,
                                   window=DOCS_PER_USER)),
    ]


def phase_main(qdb, db, q_codes, gold, dev) -> dict[str, int]:
    return _serve("main", _variants(gold, dev), MAIN_KERNELS, qdb, db,
                  q_codes, gold, dev)


def _serve(label: str, variants, path_kernels, qdb, db, q_codes, gold,
           dev) -> dict[str, int]:
    """Drive `BATCHES` batches of each variant through the kernel backend
    with the launch counts set to 0 just before and read just after (every
    kernel of `path_kernels` must have launched, none of
    OFF_PATH_KERNELS); then hold every batch to the plain backend, the
    exact INT8 dot products and the planted gold, and profile one batch of
    each variant."""
    results = {}
    ops.reset_launch_counts()
    for name, cfg, policy_for in variants:
        engine = RetrievalEngine(cfg, dev)
        lat = []
        outs = []
        for i in range(BATCHES):
            sl = slice(i * B, (i + 1) * B)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.retrieve(q_codes[sl], db, policy_for(sl))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            outs.append(res)
        results[name] = (lat, outs)
    launches = ops.launch_counts()
    log(f"{label} path launches over {len(variants)} x {BATCHES} batches: "
        f"{launches}")
    for key in path_kernels:
        if launches[key] <= 0:
            raise AssertionError(f"kernel {key} was not launched by the "
                                 f"{label} path")
    for key in OFF_PATH_KERNELS:
        if launches[key]:
            raise AssertionError(f"kernel {key} was launched by the {label} "
                                 "path, which should not take it")

    for name, cfg, policy_for in variants:
        plain_engine = RetrievalEngine(
            dataclasses.replace(cfg, backend="torch"), dev)
        lat, outs = results[name]
        hits = 0
        for i, res in enumerate(outs):
            sl = slice(i * B, (i + 1) * B)
            want = plain_engine.retrieve(q_codes[sl], db, policy_for(sl))
            for field in ("indices", "scores", "candidate_indices"):
                got_f, want_f = getattr(res, field), getattr(want, field)
                if not torch.equal(got_f, want_f):
                    raise AssertionError(f"{name} batch {i}: {field} differs "
                                         "from the plain backend")
            if res.indices.shape != (B, K):
                raise AssertionError(f"{name}: indices shape "
                                     f"{tuple(res.indices.shape)}")
            idx = res.indices.long()
            if bool((idx < 0).any()):
                raise AssertionError(f"{name}: unfilled result positions")
            exact = (qdb.values[idx].to(torch.int32)
                     * q_codes[sl][:, None, :].to(torch.int32)).sum(
                         -1, dtype=torch.int32)
            if not torch.equal(exact, res.scores):
                raise AssertionError(f"{name}: scores are not the exact "
                                     "INT8 dot products")
            hits += int((idx == gold[sl][:, None]).any(dim=1).sum())
        recall = hits / (B * BATCHES)
        p50 = statistics.median(lat)
        log(f"{label} {name}: recall@{K} {recall:.4f} p50_batch_ms "
            f"{p50 * 1e3:.3f} queries_per_s {B / p50:.1f} "
            f"(B={B}, {BATCHES} batches, plain-backend bit-identical)")
        if recall < 0.95:
            raise AssertionError(f"{name}: recall@{K} {recall} < 0.95")
        engine = RetrievalEngine(cfg, dev)
        sl = slice(0, B)
        kernels = device_profile(
            lambda: engine.retrieve(q_codes[sl], db, policy_for(sl)))
        busy = sum(t for _, t, _ in kernels) * 1e-6
        launched = sum(n for _, _, n in kernels)
        top = ", ".join(f"{n[:48]} {t:.1f}us" for n, t, _ in kernels[:4])
        log(f"profile {name}: device_busy_ms {busy * 1e3:.3f} of "
            f"p50_batch_ms {p50 * 1e3:.3f} (idle share "
            f"{1 - busy / p50:.3f}); {launched:.0f} kernel "
            f"launches of {len(kernels)} kinds per batch, top: {top}")
    return launches


def phase_cluster(dev) -> dict[str, int]:
    """The cluster-pruned cascade at full width on its own clustered
    corpus, which is freed before the phase returns."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    centers = _unit(torch.randn(CLUSTERS, D, generator=gen, device=dev))
    docs = _unit(centers.repeat_interleave(CLUSTER_ROWS, dim=0)
                 + SPREAD * _unit(torch.randn(N, D, generator=gen,
                                              device=dev)))
    del centers
    q_total = B * BATCHES
    gold = torch.randint(0, N, (q_total,), generator=gen, device=dev)
    noise = _unit(torch.randn(q_total, D, generator=gen, device=dev))
    queries = _unit(docs[gold] + NOISE * noise)
    # The codebook: the INT8 quantization of each planted cluster's mean
    # (k-means at this size is held against the reference on the CPU).
    means = docs.reshape(CLUSTERS, CLUSTER_ROWS, D).mean(dim=1)
    qdb = quantization.build_database(docs, device=dev)
    del docs
    db = bitplanar.BitPlanarDB.from_quantized(qdb)   # with its sign plane
    q_codes, _ = quantization.quantize_int8(queries, per_vector=True)
    cents, _ = quantization.quantize_int8(means)
    codebook = clustering.ClusterCodebook.from_codes(cents, device=dev)
    labels = (torch.arange(N, device=dev) // CLUSTER_ROWS).to(torch.int32)
    table = torch.from_numpy(clustering.block_table(
        labels.cpu().numpy(), CLUSTERS, BLOCK_ROWS)).to(dev)
    policy = ClusterPolicy(
        owner=torch.zeros(N, dtype=torch.int32, device=dev),
        tenant_ids=torch.zeros(B, dtype=torch.int32, device=dev),
        labels=labels, centroid_msb=codebook.msb_plane,
        centroid_norms=codebook.norms_sq, cluster_blocks=table,
        nprobe=NPROBE, block_rows=BLOCK_ROWS)
    torch.cuda.synchronize()
    log(f"cluster corpus: {N} x {D} int8 in {CLUSTERS} clusters of "
        f"{CLUSTER_ROWS} rows, block table {tuple(table.shape)}, view "
        f"{NPROBE * table.shape[1] * BLOCK_ROWS} rows per lane, built on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    variants = [
        ("cluster_cosine", RetrievalConfig(k=K), lambda sl: policy),
        ("cluster_mips", RetrievalConfig(k=K, metric="mips"),
         lambda sl: policy),
        (f"cluster_prescreen_{PRESCREEN_C0}",
         RetrievalConfig(k=K, prescreen_c0=PRESCREEN_C0), lambda sl: policy),
    ]
    launches = _serve("cluster", variants, CLUSTER_KERNELS, qdb, db, q_codes,
                      gold, dev)
    _gather_in_turns(variants[1], db, q_codes, dev)
    del qdb, db, q_codes, gold, codebook, policy, variants
    torch.cuda.empty_cache()
    return launches


def _gather_in_turns(variant, db, q_codes, dev, rounds: int = 10) -> None:
    """p50 of BATCHES batches of one cluster variant per round, the block
    gather on its TMA kernel and (the launcher's answer patched to 0) on
    dp4a, in turns (TMA first in even rounds): the redesign end to end,
    free of the spread between processes. After the path's counts were
    read, so these launches count nowhere."""
    name, cfg, policy_for = variant
    engine = RetrievalEngine(cfg, dev)
    p50 = {"tma": [], "dp4a": []}
    for rnd in range(rounds):
        for route in ("tma", "dp4a") if rnd % 2 == 0 else ("dp4a", "tma"):
            lat = []
            with mock.patch.object(stage1_gather, "_tma_takes",
                                   side_effect=lambda *a, tma=(
                                       route == "tma"): tma):
                for i in range(BATCHES):
                    sl = slice(i * B, (i + 1) * B)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine.retrieve(q_codes[sl], db, policy_for(sl))
                    torch.cuda.synchronize()
                    lat.append(time.perf_counter() - t0)
            p50[route].append(round(statistics.median(lat) * 1e3, 3))
    wins = sum(t < d for t, d in zip(p50["tma"], p50["dp4a"], strict=True))
    log(f"{name} in turns ({rounds} rounds of {BATCHES} batches per "
        f"kernel): p50_batch_ms on the TMA gather {p50['tma']}, on dp4a "
        f"{p50['dp4a']}; TMA faster in {wins} of {rounds}")


# The tenancy path: 512 tenants x 2048 docs (the paper's 1 MB of INT8 per
# user) ingested online into one 2^20-row arena in 4 rounds of 512 rows per
# tenant, so every tenant is 4 runs until compact(); 256 docs of each
# tenant deleted; then a second, clustered index (64 shared planted centres,
# 64 codebook clusters, 8 probes, 64-row blocks).
TENANTS, TENANT_DOCS, INGEST_ROUNDS, TENANT_DELETES = 512, 2048, 4, 256
T_CLUSTERS, T_NPROBE, T_BLOCK_ROWS, T_PRESCREEN_C0 = 64, 8, 64, 256
# Bytes per arena slot: the two nibble planes, the sign plane, norm, owner.
SLOT_BYTES = D // 2 + D // 2 + D // 8 + 4 + 4
TENANCY_KERNELS = ("stage1_plane_mma", "stage1_plane", "stage1_rows",
                   "stage2_rerank_by_id", "stage1_gather",
                   "stage0_sign_gather")
PUBLISH_REPS = 200


class _Tenancy:
    """One tenancy run's shared state: the launch counts of the path (each
    segment driven with the counts set to 0 just before it and read just
    after), the metrics registry and tracer every retrieve publishes into,
    and the plans whose bytes the registry must add up to."""

    def __init__(self, dev):
        self.dev = dev
        self.launches: dict[str, int] = {}
        self.registry = obs.MetricsRegistry()
        self.tracer = obs.Tracer()
        self.plans = []

    def path(self, fn):
        ops.reset_launch_counts()
        out = fn()
        for key, n in ops.launch_counts().items():
            self.launches[key] = self.launches.get(key, 0) + n
        return out

    def span(self, name, fn, **attrs):
        """`fn()` inside a span that closes after the card has finished."""
        with self.tracer.span(name, **attrs):
            out = fn()
            torch.cuda.synchronize()
        return out

    def publish(self, plan, queries: int) -> None:
        plan.publish(self.registry)
        energy.observe_cost(self.registry,
                            energy.cost_cascade(plan.stages, D,
                                                batch=plan.batch),
                            queries=queries)
        self.plans.append(plan)


def _tenant_docs(gen, dev, centres=None):
    """(TENANTS, TENANT_DOCS, D) seeded unit vectors; with `centres`, each
    drawn around a random one of them (spread SPREAD), and then also the
    (TENANTS, TENANT_DOCS) centre of each doc."""
    noise = _unit(torch.randn(TENANTS * TENANT_DOCS, D, generator=gen,
                              device=dev))
    if centres is None:
        return noise.reshape(TENANTS, TENANT_DOCS, D)
    pick = torch.randint(0, centres.shape[0], (TENANTS * TENANT_DOCS,),
                         generator=gen, device=dev)
    docs = _unit(centres[pick] + SPREAD * noise).reshape(TENANTS,
                                                         TENANT_DOCS, D)
    return docs, pick.reshape(TENANTS, TENANT_DOCS).cpu().numpy()


def _tenant_queries(docs, gen, rng):
    """BATCHES batches of B lanes, B distinct tenants per batch; each query
    one of its tenant's docs plus NOISE. Returns (tenant ids (BATCHES, B),
    gold doc of each lane (BATCHES, B), query codes per batch)."""
    tids = np.stack([rng.permutation(TENANTS)[:B] for _ in range(BATCHES)])
    gold = rng.integers(0, TENANT_DOCS, (BATCHES, B))
    t, g = (torch.from_numpy(a.reshape(-1)).to(docs.device)
            for a in (tids, gold))
    noise = _unit(torch.randn(B * BATCHES, D, generator=gen,
                              device=docs.device))
    queries = _unit(docs[t, g] + NOISE * noise)
    q_codes, _ = quantization.quantize_int8(queries, per_vector=True)
    return tids.astype(np.int32), gold, list(q_codes.split(B))


def _ingest(run, index, docs, label) -> np.ndarray:
    """INGEST_ROUNDS rounds in which every tenant in turn ingests its next
    TENANT_DOCS / INGEST_ROUNDS docs; returns slots (TENANTS, TENANT_DOCS)."""
    per = TENANT_DOCS // INGEST_ROUNDS
    slots = np.empty((TENANTS, TENANT_DOCS), np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(INGEST_ROUNDS):
        rows = slice(r * per, (r + 1) * per)
        for t in range(TENANTS):
            slots[t, rows] = run.span(
                "ingest", lambda: index.ingest(t, docs[t, rows]), tid=t,
                rows=per)
    secs = time.perf_counter() - t0
    calls = INGEST_ROUNDS * TENANTS
    log(f"tenancy {label} ingest: {calls} ingest calls of {per} rows in "
        f"{secs:.3f} s ({calls * per / secs:.0f} rows/s, "
        f"{secs / calls * 1e3:.3f} ms per call, each synchronized)")
    return slots


def _serve_index(run, index, label, kind, q_codes, tids):
    """BATCHES batches through `index.retrieve`, timed on the host clock
    around retrieve + synchronize; every plan published after its batch."""
    lat, outs = [], []
    for i in range(BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run.span("retrieve", lambda: index.retrieve(q_codes[i],
                                                          tids[i]),
                       policy=label)
        lat.append(time.perf_counter() - t0)
        plan = index.last_plan
        if plan.kind != kind:
            raise AssertionError(f"tenancy {label}: the index chose the "
                                 f"{plan.kind} policy, not {kind}")
        run.publish(plan, B)
        outs.append(res)
    return lat, outs


def _check_served(index, label, outs, tids, gold_slots, q_codes, slot_codes,
                  recall_lanes=None) -> float:
    """No cross-tenant leak, exact scores, bit-identical to the plain
    backend on the card (the index re-planned with backend="torch");
    returns recall@K against the gold slots over `recall_lanes`."""
    owner = index.arena.owner
    cfg = index.cfg
    index.cfg = dataclasses.replace(cfg, backend="torch")
    try:
        plain = [index.retrieve(q_codes[i], tids[i]) for i in range(BATCHES)]
    finally:
        index.cfg = cfg
    hits = lanes = 0
    for i, (res, want) in enumerate(zip(outs, plain, strict=True)):
        for field in ("indices", "scores", "candidate_indices"):
            if not torch.equal(getattr(res, field), getattr(want, field)):
                raise AssertionError(f"tenancy {label} batch {i}: {field} "
                                     "differs from the plain backend")
        t = torch.from_numpy(tids[i]).to(owner.device)
        for ids in (res.indices, res.candidate_indices):
            safe = ids.long().clamp(min=0)
            if bool(((ids >= 0) & (owner[safe] != t[:, None])).any()):
                raise AssertionError(f"tenancy {label} batch {i}: a "
                                     "returned id belongs to another tenant")
        idx = res.indices.long()
        if bool((idx < 0).any()):
            raise AssertionError(f"tenancy {label}: unfilled positions")
        exact = (slot_codes(idx).to(torch.int32)
                 * q_codes[i][:, None, :].to(torch.int32)).sum(
                     -1, dtype=torch.int32)
        if not torch.equal(exact, res.scores):
            raise AssertionError(f"tenancy {label}: scores are not the exact "
                                 "INT8 dot products")
        found = (idx.cpu().numpy() == gold_slots[i][:, None]).any(axis=1)
        keep = (np.ones(B, bool) if recall_lanes is None
                else recall_lanes[i])
        hits += int(found[keep].sum())
        lanes += int(keep.sum())
    return hits / lanes


def _report(index, label, lat, recall, q_codes, tids) -> None:
    p50 = statistics.median(lat)
    kernels = device_profile(lambda: index.retrieve(q_codes[0], tids[0]))
    busy = sum(t for _, t, _ in kernels) * 1e-6
    launched = sum(n for _, _, n in kernels)
    top = ", ".join(f"{n[:48]} {t:.1f}us" for n, t, _ in kernels[:4])
    log(f"tenancy {label}: recall@{K} {recall:.4f} p50_batch_ms "
        f"{p50 * 1e3:.3f} queries_per_s {B / p50:.1f} device_busy_ms "
        f"{busy * 1e3:.3f} idle_share {1 - busy / p50:.3f} launches_per_batch "
        f"{launched:.0f} (B={B}, {BATCHES} batches of {B} distinct tenants, "
        f"plain-backend bit-identical, 0 leaks); top: {top}")
    if recall < 0.95:
        raise AssertionError(f"tenancy {label}: recall@{K} {recall} < 0.95")


def _masked_arena(run, dev, gen, rng, serving) -> None:
    """Fragmented ingest -> Masked, single queries, the scheduler facade
    (the serving phase's, counted there), delete -> Masked, compact ->
    Windowed, on one index that is freed before returning."""
    docs = _tenant_docs(gen, dev)
    tids, gold, q_codes = _tenant_queries(docs, gen, rng)
    index = MultiTenantIndex(N, D, RetrievalConfig(k=K), device=dev)
    slots = run.path(lambda: _ingest(run, index, docs, "arena"))
    codes = index.arena.quantize(docs.reshape(-1, D)).reshape(
        TENANTS, TENANT_DOCS, D)
    del docs
    doc_of = np.full(N, -1, np.int64)           # slot -> t * TENANT_DOCS + j
    doc_of[slots.reshape(-1)] = np.arange(TENANTS * TENANT_DOCS)
    flat = codes.reshape(-1, D)

    def slot_codes(idx):
        return flat[torch.from_numpy(doc_of).to(dev)[idx]]

    gold_slots = slots[tids, gold]
    lat, outs = run.path(lambda: _serve_index(run, index, "masked", "masked",
                                              q_codes, tids))
    def single(i):
        one = run.span("retrieve", lambda: index.retrieve(
            q_codes[0][i], int(tids[0][i])), policy="single")
        if index.last_plan.kind != "masked":
            raise AssertionError("tenancy: a single query was not masked")
        run.publish(index.last_plan, 1)
        return one

    singles = run.path(lambda: [single(i) for i in range(SINGLE_QUERIES)])
    for i, one in enumerate(singles):
        if not all(torch.equal(getattr(one, f), getattr(outs[0], f)[i])
                   for f in ("indices", "scores", "candidate_indices")):
            raise AssertionError(f"tenancy single query {i} differs from "
                                 f"lane {i} of the batched result")
    recall = _check_served(index, "masked", outs, tids, gold_slots, q_codes,
                           slot_codes)
    if index.arena.stats.rebuilds:
        raise AssertionError("tenancy: the online path rebuilt the arena")
    _report(index, f"masked ({TENANTS} tenants, {INGEST_ROUNDS} runs each)",
            lat, recall, q_codes, tids)
    log(f"tenancy single queries: {SINGLE_QUERIES} retrieve(q, tenant) "
        f"calls equal lanes 0-{SINGLE_QUERIES - 1} of the batched masked "
        "result")
    serving.facade(index, q_codes, tids)

    # Delete 256 of each tenant's docs (every 8th), golds of some lanes too.
    dead_local = np.arange(TENANT_DOCS) % (TENANT_DOCS // TENANT_DELETES) == 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.path(lambda: [run.span("delete", lambda: index.delete(
        t, slots[t, dead_local]), tid=t) for t in range(TENANTS)])
    secs = time.perf_counter() - t0
    lost = dead_local[gold]
    if not lost.any():
        raise AssertionError("tenancy: no lane's gold was deleted")
    if index.num_live != N - TENANTS * TENANT_DELETES:
        raise AssertionError(f"tenancy: num_live {index.num_live} after the "
                             "deletes")
    log(f"tenancy delete: {TENANTS} delete calls of {TENANT_DELETES} slots "
        f"in {secs:.3f} s ({secs / TENANTS * 1e3:.3f} ms per call, each "
        f"synchronized); num_live {index.num_live}; the gold of "
        f"{int(lost.sum())} of {lost.size} lanes deleted")
    dead = torch.zeros(N, dtype=torch.bool, device=dev)
    dead[torch.from_numpy(slots[:, dead_local].reshape(-1)).to(dev)] = True
    lat, outs = run.path(lambda: _serve_index(
        run, index, "masked_after_delete", "masked", q_codes, tids))
    for res in outs:
        for ids in (res.indices, res.candidate_indices):
            if bool(((ids >= 0) & dead[ids.long().clamp(min=0)]).any()):
                raise AssertionError("tenancy: a tombstoned id was returned")
    recall = _check_served(index, "masked after delete", outs, tids,
                           gold_slots, q_codes, slot_codes, ~lost)
    _report(index, "masked after delete", lat, recall, q_codes, tids)

    # Compact: every tenant one run, the planes a rebuild's.
    live = TENANTS * (TENANT_DOCS - TENANT_DELETES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapping = run.path(lambda: run.span("compact", index.compact))
    secs = time.perf_counter() - t0
    least = (live + N) * SLOT_BYTES / HBM_BYTES_PER_S
    log(f"tenancy compact: {secs * 1e3:.3f} ms (host clock, synchronized) "
        f"against its least time {least * 1e3:.4f} ms ({live} live rows "
        f"read + {N} rows written x {SLOT_BYTES} bytes at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    if any(len(index.table.segments(t)) != 1 for t in range(TENANTS)):
        raise AssertionError("tenancy: a tenant is not one run after compact")
    survivors = flat.reshape(TENANTS, TENANT_DOCS, D)[:, ~dead_local]
    survivors = survivors.reshape(-1, D)
    rebuilt = bitplanar.BitPlanarDB.from_quantized(quantization.QuantizedDB(
        values=survivors, scale=index.arena.scale,
        norms_sq=(survivors.to(torch.int32) ** 2).sum(-1, dtype=torch.int32)))
    arena = index.arena
    for name in ("msb_plane", "lsb_plane", "sign_plane", "norms_sq"):
        mine = getattr(arena, name)
        if not (torch.equal(mine[:live], getattr(rebuilt, name))
                and not bool(mine[live:].any())):
            raise AssertionError(f"tenancy: the compacted {name} is not a "
                                 "rebuild of the surviving codes")
    owners = torch.arange(TENANTS, device=dev, dtype=torch.int32)
    if not (torch.equal(arena.owner[:live], owners.repeat_interleave(
            TENANT_DOCS - TENANT_DELETES))
            and bool((arena.owner[live:] == -1).all())):
        raise AssertionError("tenancy: the compacted owner map is wrong")
    log("tenancy compact: every tenant one contiguous run; planes, sign "
        "plane, norms and owner equal BitPlanarDB.from_quantized of the "
        "surviving codes in tenant order (online ingest = a rebuild)")
    moved = np.full(N, -1, np.int64)
    moved[mapping[mapping >= 0]] = doc_of[mapping >= 0]
    doc_of[:] = moved
    gold_slots = mapping[gold_slots]

    lat, outs = run.path(lambda: _serve_index(
        run, index, "windowed", "windowed", q_codes, tids))
    if index.last_plan.rows_scanned != TENANT_DOCS:
        raise AssertionError(f"tenancy: window {index.last_plan.rows_scanned}"
                             f", not {TENANT_DOCS}")
    for i, res in enumerate(outs):
        want = index.engine.retrieve(q_codes[i], arena.db(), MaskedPolicy(
            owner=arena.owner,
            tenant_ids=torch.from_numpy(tids[i]).to(dev)))
        for field in ("indices", "scores", "candidate_indices"):
            if not torch.equal(getattr(res, field), getattr(want, field)):
                raise AssertionError(f"tenancy windowed batch {i}: {field} "
                                     "differs from the masked scan")
    recall = _check_served(index, "windowed", outs, tids, gold_slots, q_codes,
                           slot_codes, ~lost)
    _report(index, f"windowed ({TENANT_DOCS}) after compact", lat, recall,
            q_codes, tids)
    log("tenancy windowed: bit-identical to the masked scan over the same "
        f"arena; arena rebuilds {arena.stats.rebuilds}")
    del index, codes, flat, survivors, rebuilt, arena, dead
    torch.cuda.empty_cache()


def _clustered_arena(run, dev, gen, rng):
    """The clustered index: returned, with the serving phase's session
    traces, for that phase to serve."""
    centres = _unit(torch.randn(T_CLUSTERS, D, generator=gen, device=dev))
    docs, pick = _tenant_docs(gen, dev, centres)
    tids, gold, q_codes = _tenant_queries(docs, gen, rng)
    index = MultiTenantIndex(
        N, D, RetrievalConfig(k=K), device=dev,
        clusters=clustering.ClusterParams(T_CLUSTERS, nprobe=T_NPROBE,
                                          block_rows=T_BLOCK_ROWS))
    slots = run.path(lambda: _ingest(run, index, docs, "clustered"))
    codes = index.arena.quantize(docs.reshape(-1, D)).reshape(
        TENANTS, TENANT_DOCS, D)
    del centres
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapping = run.path(lambda: run.span("compact", index.compact))
    log(f"tenancy clustered compact: {(time.perf_counter() - t0) * 1e3:.3f} "
        f"ms; codebook generation {index.clusters.generation}")
    traces = _serving_traces(docs, pick, mapping[slots], gen, rng)
    del docs
    doc_of = np.full(N, -1, np.int64)
    doc_of[mapping[slots.reshape(-1)]] = np.arange(TENANTS * TENANT_DOCS)
    flat = codes.reshape(-1, D)

    def slot_codes(idx):
        return flat[torch.from_numpy(doc_of).to(dev)[idx]]

    gold_slots = mapping[slots[tids, gold]]
    base = index.cfg
    for label, cfg in (("cluster_cosine", base),
                       ("cluster_mips", dataclasses.replace(base,
                                                            metric="mips")),
                       (f"cluster_prescreen_{T_PRESCREEN_C0}",
                        dataclasses.replace(base,
                                            prescreen_c0=T_PRESCREEN_C0))):
        index.cfg = cfg
        lat, outs = run.path(lambda: _serve_index(run, index, label,
                                                  "cluster", q_codes, tids))
        view = index.last_plan.rows_scanned
        recall = _check_served(index, label, outs, tids, gold_slots, q_codes,
                               slot_codes)
        _report(index, f"{label} ({view} stage-1 rows per lane)", lat,
                recall, q_codes, tids)
    # The host work a batch of new tenant ids costs before any launch:
    # the per-lane block tables and the labels upload (a rolled tuple
    # misses the index's layout cache).
    lay = []
    for i in range(BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.cluster_layout(np.roll(tids[i], 1))
        torch.cuda.synchronize()
        lay.append(time.perf_counter() - t0)
    log(f"tenancy cluster layout: p50 {statistics.median(lay) * 1e3:.3f} ms "
        f"per batch of {B} new tenant ids (block tables + labels upload, "
        "host clock)")
    index.cfg = base
    del codes, flat
    torch.cuda.empty_cache()
    return index, traces


def _check_obs(run) -> None:
    """The Prometheus export parses back to the registry's counters, the
    byte counters add up to the plans', and the trace is written; then the
    host cost of publishing one batch's plan and energy, on and off."""
    text = obs.prometheus_text(run.registry)
    parsed = obs.parse_prometheus(text)
    counters = [m for kind, m in run.registry.metrics() if kind == "counter"]
    for m in counters:
        if (dict((k, str(v)) for k, v in m.labels), float(m.value)) not in \
                parsed.get(m.name, []):
            raise AssertionError(f"obs: counter {m.name}{m.labels} did not "
                                 "round-trip through the Prometheus text")
    want: dict[str, int] = {}
    for plan in run.plans:
        for st in plan.stages:
            want[st.name] = want.get(st.name, 0) + st.bytes_hbm
    got = {dict(m.labels)["stage"]: m.value for m in counters
           if m.name == "stage_bytes_hbm"}
    if got != want:
        raise AssertionError(f"obs: stage_bytes_hbm {got} != the plans' "
                             f"{want}")
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "tenancy_trace.json")
    events = obs.write_chrome_trace(path, run.tracer)
    spans = {}
    for ev in run.tracer.spans():
        spans.setdefault(ev.name, []).append(ev.dur)
    summary = ", ".join(f"{name} {len(d)} spans p50 "
                        f"{statistics.median(d) * 1e3:.3f} ms"
                        for name, d in spans.items())
    log(f"obs: {len(counters)} counters round-trip through the Prometheus "
        f"text ({len(text.splitlines())} lines); stage_bytes_hbm equals the "
        f"{len(run.plans)} plans' bytes {want}; {events} trace events "
        f"written to build/tenancy_trace.json ({summary})")
    us = {}
    plans = run.plans[:BATCHES]
    for label, reg in (("enabled", obs.MetricsRegistry()),
                       ("null", obs.NULL_REGISTRY)):
        t0 = time.perf_counter()
        for _ in range(PUBLISH_REPS):
            for plan in plans:
                plan.publish(reg)
                energy.observe_cost(reg, energy.cost_cascade(
                    plan.stages, D, batch=plan.batch), queries=B)
        us[label] = round((time.perf_counter() - t0)
                          / (PUBLISH_REPS * len(plans)) * 1e6, 2)
    log(f"obs: host us per batch of publish + observe_cost: registry "
        f"enabled {us['enabled']}, NULL_REGISTRY {us['null']}")


def phase_tenancy(dev, serving):
    """The multi-tenant streaming index at full width through its entry
    points (`MultiTenantIndex.ingest`, `delete`, `compact`, `retrieve`):
    Masked, Windowed and Cluster policies, the obs layer around them.
    Returns the path's launches and, for the serving phase, the clustered
    index and its session traces."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    run = _Tenancy(dev)
    _masked_arena(run, dev, gen, rng, serving)
    served = _clustered_arena(run, dev, gen, rng)
    _check_obs(run)
    log(f"tenancy path launches: {run.launches}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    for key in TENANCY_KERNELS:
        if run.launches.get(key, 0) <= 0:
            raise AssertionError(f"kernel {key} was not launched by the "
                                 "tenancy path")
    for key in ("stage2_exact", "stage1_gather_dp4a", "stage2_by_id"):
        if run.launches.get(key, 0):
            raise AssertionError(f"kernel {key} was launched by the tenancy "
                                 "path, which should not take it")
    return run.launches, served


# -- the serving phase ---------------------------------------------------
# The session trace of the reference bench (`_session_trace`): each turn,
# SERVE_TENANTS session tenants each send one query, a noisy re-encoding of
# one of their own docs around their focus centre; a focus is kept with
# probability STICKY per turn, else redrawn from a Zipf(ZIPF_S) over the
# T_CLUSTERS centres.
SERVE_TENANTS, SERVE_TURNS, OPEN_TURNS = 32, 48, 3
ZIPF_S, STICKY = 1.1, 0.8
FACADE_FLUSHES = 12
OPEN_WAIT, OPEN_DEPTH = 0.005, 2
FIELDS = ("indices", "scores", "candidate_indices")
SERVING_KERNELS = ("stage1_gather", "stage0_sign_gather",
                   "stage2_rerank_by_id", "stage1_gather_resident",
                   "stage0_sign_gather_resident")
SERVING_OFF_PATH = ("stage1_gather_dp4a", "stage2_exact", "stage2_by_id")


PLANE_GATHERS = ("stage1_gather", "stage0_sign_gather")
RESIDENT_GATHERS = ("stage1_gather_resident", "stage0_sign_gather_resident")


class _Serving:
    """The serving phase's launch counts: each segment driven with the
    counts set to 0 just before it and read just after. The resident
    wrappers count their own launches (`stage1_gather_resident`,
    `stage0_sign_gather_resident`), so a segment's counts say which route
    its gathers took: a cached (slab) segment must launch only the
    resident gathers, an uncached one only the plane gathers."""

    def __init__(self):
        self.launches: dict[str, int] = {}
        self.last: dict[str, int] = {}

    def path(self, fn, cached: bool = False):
        ops.reset_launch_counts()
        out = fn()
        counts = ops.launch_counts()
        wrong = [k for k in (PLANE_GATHERS if cached else RESIDENT_GATHERS)
                 if counts[k]]
        if wrong:
            raise AssertionError(
                f"serving: a{' cached' if cached else 'n uncached'} segment "
                f"launched {', '.join(f'{k} x{counts[k]}' for k in wrong)}")
        self.last = counts
        for key, n in counts.items():
            self.launches[key] = self.launches.get(key, 0) + n
        return out

    def facade(self, index, q_codes, tids) -> None:
        """Run 5: `CrossTenantBatchScheduler(max_batch=B)` over the tenancy
        phase's Masked arena, FACADE_FLUSHES flushes of B requests, each
        equal to `index.retrieve` of the same batch."""
        sched = CrossTenantBatchScheduler(index, max_batch=B)
        hosts = [q.cpu().numpy() for q in q_codes[:FACADE_FLUSHES]]

        def drive():
            outs, lat = [], []
            for i, q in enumerate(hosts):
                t0 = time.perf_counter()
                rids = [sched.submit(int(t), q[j])
                        for j, t in enumerate(tids[i])]
                out = sched.flush()
                lat.append(time.perf_counter() - t0)
                outs.append([out[r] for r in rids])
            return outs, lat

        outs, lat = self.path(drive)
        if sched.launches != FACADE_FLUSHES or sched.pending():
            raise AssertionError(f"serving facade: {sched.launches} launches "
                                 f"for {FACADE_FLUSHES} flushes")
        for i, lanes in enumerate(outs):
            want = index.retrieve(q_codes[i], tids[i])
            for f in FIELDS:
                got = torch.stack([getattr(r, f) for r in lanes])
                if not torch.equal(got, getattr(want, f).cpu()):
                    raise AssertionError(f"serving facade flush {i}: {f} "
                                         "differs from index.retrieve")
        log(f"serving facade: CrossTenantBatchScheduler(max_batch={B}) over "
            f"the Masked arena, {FACADE_FLUSHES} flushes of {B} tenants "
            f"equal index.retrieve bit for bit; p50_flush_ms "
            f"{statistics.median(lat) * 1e3:.3f}; stage1_bytes_streamed "
            f"{sched.stage1_bytes_streamed}")


def _zipf_turns(rng, n, turns):
    """Each turn's focus centre per tenant (the reference's
    `_session_trace`)."""
    ranks = np.arange(1, T_CLUSTERS + 1, dtype=np.float64)
    pops = 1.0 / ranks ** ZIPF_S
    pops /= pops.sum()
    focus = rng.choice(T_CLUSTERS, size=n, p=pops)
    out = []
    for _ in range(turns):
        redraw = rng.random(n) >= STICKY
        focus = np.where(redraw, rng.choice(T_CLUSTERS, size=n, p=pops),
                         focus)
        out.append(focus.copy())
    return out


def _serving_traces(docs, pick, gold_slots, gen, rng):
    """(closed-loop turns, open-loop requests): each turn (tenant ids,
    int8 query codes on the host, gold slots). The closed loop: the same
    SERVE_TENANTS tenants for SERVE_TURNS turns. The open loop: all TENANTS
    tenants for OPEN_TURNS turns, each turn's arrivals in a random order.
    Queries are a doc plus relative noise NOISE, as the tenancy phase's."""
    def turn(tenants, focus):
        js = []
        for t, f in zip(tenants, focus):
            mine = np.flatnonzero(pick[t] == f)
            js.append(int(rng.choice(mine)) if mine.size
                      else int(rng.integers(TENANT_DOCS)))
        js = np.asarray(js)
        t_dev, j_dev = (torch.from_numpy(a).to(docs.device)
                        for a in (tenants, js))
        noise = _unit(torch.randn(len(tenants), D, generator=gen,
                                  device=docs.device))
        q, _ = quantization.quantize_int8(
            _unit(docs[t_dev, j_dev] + NOISE * noise), per_vector=True)
        return (tenants.astype(np.int32), q.cpu().numpy(),
                gold_slots[tenants, js])

    session = np.sort(rng.permutation(TENANTS)[:SERVE_TENANTS])
    closed = [turn(session, f) for f in _zipf_turns(rng, SERVE_TENANTS,
                                                    SERVE_TURNS)]
    everyone = np.arange(TENANTS)
    open_loop = []
    for f in _zipf_turns(rng, TENANTS, OPEN_TURNS):
        order = rng.permutation(TENANTS)
        tids, q, gold = turn(everyone[order], f[order])
        open_loop += list(zip(tids.tolist(), q, gold.tolist()))
    return closed, open_loop


def _one_turn(rt, turn):
    tids, q, _ = turn
    hs = [rt.submit(int(t), q[i]) for i, t in enumerate(tids)]
    rt.flush()
    return [h.result() for h in hs]


def _closed_loop(serving, index, turns, cached, **cfg):
    """Drive `turns` through a new runtime: submit every request of a turn,
    flush(), then block on the results; host clock around each turn.
    On the "cuda" backend each launch runs one gather (the sign gather
    with the prescreen, else the stage-1 gather), on its resident route
    iff `cached`; the plain backend launches none. Returns
    (runtime, per-turn seconds, per-turn stacked results, each turn's
    (plan, prefetch bytes))."""
    rt = ServingRuntime(index, RuntimeConfig(max_batch=SERVE_TENANTS, **cfg))

    def drive():
        lat, outs, plans = [], [], []
        prefetched = 0
        for tids, q, _ in turns:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hs = [rt.submit(int(t), q[i]) for i, t in enumerate(tids)]
            t1 = time.perf_counter()
            rt.flush()
            res = [h.result() for h in hs]
            t2 = time.perf_counter()
            lat.append((t2 - t0, t1 - t0))
            plans.append((rt.last_plan, rt.prefetch_bytes - prefetched))
            prefetched = rt.prefetch_bytes
            outs.append(tuple(torch.stack([getattr(r, f) for r in res])
                              for f in FIELDS))
        return lat, outs, plans

    lat, outs, plans = serving.path(drive, cached=cached)
    if rt.launches != len(turns):
        raise AssertionError(f"serving: {rt.launches} launches for "
                             f"{len(turns)} turns")
    key = (RESIDENT_GATHERS if cached else PLANE_GATHERS)[
        index.cfg.prescreen_c0 is not None]
    want = rt.launches if index.cfg.backend == "cuda" else 0
    if serving.last[key] != want:
        raise AssertionError(f"serving: {serving.last[key]} {key} launches "
                             f"for {rt.launches} runtime launches on the "
                             f"{index.cfg.backend} backend")
    return rt, lat, outs, plans


def _same_outs(label, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for f, a, b in zip(FIELDS, g, w):
            if not torch.equal(a, b):
                raise AssertionError(f"serving {label} turn {i}: {f} is not "
                                     "bit-identical to the cold run")


def _no_leak(label, owner, turns, outs) -> None:
    for i, ((tids, _, _), res) in enumerate(zip(turns, outs)):
        for ids in (res[0].numpy(), res[2].numpy()):
            bad = (ids >= 0) & (owner[np.maximum(ids, 0)]
                                != tids[:, None])
            if bad.any():
                raise AssertionError(f"serving {label} turn {i}: a lane "
                                     "shows another tenant's row")


def _reconcile(label, rt, plans) -> None:
    """The runtime's stage-1 ledgers are the sum of its launches'
    `cache_split_plan` ledgers, and each plan's approx stage carries them;
    its prescreen (stage-0 sign) ledgers are the sum of the plans'
    prescreen stages."""
    plans = [p for p, _ in plans]
    hbm = sum(p.stage1_bytes for p in plans)
    sram = sum(p.stage1_bytes_sram for p in plans)
    approx = [s for p in plans for s in p.stages if s.name == "approx"]
    pre = [s for p in plans for s in p.stages if s.name == "prescreen"]
    if ((rt.stage1_bytes_streamed, rt.stage1_bytes_sram) != (hbm, sram)
            or sum(s.bytes_hbm for s in approx) != hbm
            or sum(s.bytes_sram for s in approx) != sram
            or rt.stage_bytes.get("approx", 0) != hbm
            or rt.stage_bytes_sram.get("approx", 0) != sram
            or rt.stage_bytes.get("prescreen", 0)
            != sum(s.bytes_hbm for s in pre)
            or rt.stage_bytes_sram.get("prescreen", 0)
            != sum(s.bytes_sram for s in pre)):
        raise AssertionError(f"serving {label}: stage-0 and stage-1 bytes "
                             "do not reconcile with the launches' plans")


def _split_check(label, index, turns, plans, all_hits) -> None:
    """Each cached launch's hit/miss byte split against an account that
    the runtime's `book` does not make: the lanes' probed clusters from
    the cold path's own prune (`select_clusters` of the index's
    `ClusterPolicy`, on the plain functions), a hit charged its packed
    slab blocks (`HotClusterCache.entry_blocks` of the cluster's rows), a
    miss its plane blocks in the host table. SRAM + (HBM - prefetch) of a
    launch lies between the all-hit and the all-miss sums, and SRAM is at
    most the all-hit sum; with `all_hits` (a preload that holds every
    view) HBM - prefetch is 0 and SRAM is the all-hit sum exactly. For
    launches without the prescreen, whose split is not prorated."""
    fns = stage_fns("torch")
    block_bytes = T_BLOCK_ROWS * (D // 2)
    for i, ((tids, q, _), (plan, prefetched)) in enumerate(
            zip(turns, plans, strict=True)):
        policy, table = index.cluster_layout(tids)
        q_msb = quantization.msb_nibble(torch.from_numpy(q).to(index.device))
        probes = select_clusters(q_msb, policy, index.cfg,
                                 fns).cpu().numpy()
        packed = plane = 0
        for lane, t in enumerate(tids.tolist()):
            rows = index.cluster_rows(t)
            for c in probes[lane].tolist():
                packed += HotClusterCache.entry_blocks(
                    rows.get(c, ()), T_BLOCK_ROWS) * block_bytes
                plane += int((table[lane, c] >= 0).sum()) * block_bytes
        sram, streamed = plan.stage1_bytes_sram, plan.stage1_bytes - prefetched
        if all_hits:
            ok = streamed == 0 and sram == packed
        else:
            ok = streamed >= 0 and sram <= packed <= sram + streamed <= plane
        if not ok:
            raise AssertionError(
                f"serving {label} turn {i}: slab bytes {sram} and streamed "
                f"bytes {streamed} (prefetch {prefetched} apart) do not fit "
                f"the probed clusters' {packed} packed / {plane} plane bytes")


def _syncs_per_dispatch(rt, turn) -> tuple[int, str]:
    """Host syncs in one dispatch: the turn's submits (the last one
    launches the full batch) under torch.cuda.set_sync_debug_mode; returns
    their count and, for each, the innermost Python frames that made it."""
    tids, q, _ = turn
    before = rt.launches
    sites = []
    probing = [False]     # not the warning switching the mode on may give

    def record(message, category, filename, lineno, file=None, line=None):
        if probing[0] and "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if os.path.basename(f.filename) != "warnings.py"][-4:]
            sites.append(" <- ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in reversed(frames)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        probing[0] = True
        try:
            for i, t in enumerate(tids):
                rt.submit(int(t), q[i])
        finally:
            probing[0] = False
            torch.cuda.set_sync_debug_mode(0)
    if rt.launches != before + 1:
        raise AssertionError("serving: the sync probe did not dispatch")
    rt.flush()
    return len(sites), "; ".join(sites)


def _host_top(rt, turn, n=6) -> str:
    """The functions with the most own host time over 4 more turns
    (cProfile), as `name ms per turn`."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(4):
        _one_turn(rt, turn)
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return ", ".join(f"{os.path.basename(fn)}:{line} {name} "
                     f"{tt / 4 * 1e3:.2f}"
                     for (fn, line, name), (_, _, tt, _, _) in top)


def _report_run(label, rt, lat, turns, recall=None) -> dict:
    """Print one closed-loop run's line: its ledgers first, then host syncs
    of one more dispatch, device busy of one more profiled turn and the
    host's own time by function over four more. Returns the run's p50,
    queries/s, host syncs per dispatch, stage-0 + stage-1 device-memory
    bytes per query and hit rate (the bytes and rate over `turns` only)."""
    lat, dispatch = [t for t, _ in lat], [d for _, d in lat]
    stats = rt.cache_stats()
    hits, misses = stats.get("hits", 0), stats.get("misses", 0)
    hit_rate = hits / (hits + misses) if hits + misses else float("nan")
    counters = {k: stats[k] for k in ("entries", "bytes_used", "evictions",
                                      "stale_evictions", "rejected",
                                      "fill_bytes", "fill_dispatches",
                                      "demotions", "promotions",
                                      "sign_entries", "full_entries")
                if k in stats}
    bpq = ((rt.stage1_bytes_streamed + rt.stage_bytes.get("prescreen", 0))
           / rt.queries_served)
    ledger = (f"hbm_stage1_bytes {rt.stage1_bytes_streamed} "
              f"sram_stage1_bytes {rt.stage1_bytes_sram} prefetch_bytes "
              f"{rt.prefetch_bytes} launches_per_turn "
              f"{rt.launches / len(lat):.2f}")
    syncs, sites = _syncs_per_dispatch(rt, turns[-1])
    kernels = device_profile(lambda: _one_turn(rt, turns[-1]))
    host = _host_top(rt, turns[-1])
    busy = sum(t for _, t, _ in kernels) * 1e-6
    launched = sum(n for _, _, n in kernels)
    p50 = statistics.median(lat)
    qps = SERVE_TENANTS * len(lat) / sum(lat)
    log(f"serving {label}: p50_turn_ms {p50 * 1e3:.3f} max_turn_ms "
        f"{max(lat) * 1e3:.3f} (submits and dispatch p50_ms "
        f"{statistics.median(dispatch) * 1e3:.3f}) queries_per_s {qps:.1f} "
        f"hit_rate "
        f"{hit_rate:.4f} (hits {hits}, misses {misses}) cache {counters} "
        f"{ledger} device_busy_ms {busy * 1e3:.3f} idle_share "
        f"{1 - busy / p50:.3f} kernel_launches_per_turn {launched:.0f} "
        f"host_syncs_per_dispatch {syncs}"
        + (f" (at {sites})" if syncs else "")
        + ("" if recall is None else f" recall@{K} {recall:.4f}")
        + f" ({len(lat)} turns of {SERVE_TENANTS} session tenants); host "
        f"own ms per turn: {host}")
    return dict(p50=p50, qps=qps, max=max(lat), syncs=syncs, bpq=bpq,
                hit_rate=hit_rate, stats=counters)


def _in_turns(cold_rt, warm_rt, turns) -> None:
    """The cold and the warm runtime serving the same turns alternately in
    this one process (cold, warm, warm, cold, ...): per-turn p50 of each
    and the rounds in which the warm turn was the faster."""
    times = {"cold": [], "warm": []}
    for i, turn in enumerate(turns):
        order = (("cold", cold_rt), ("warm", warm_rt))
        for label, rt in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _one_turn(rt, turn)
            times[label].append(time.perf_counter() - t0)
    faster = sum(w < c for c, w in zip(times["cold"], times["warm"]))
    log(f"serving cold/warm in turns: p50_turn_ms cold "
        f"{statistics.median(times['cold']) * 1e3:.3f} warm "
        f"{statistics.median(times['warm']) * 1e3:.3f}; warm faster in "
        f"{faster} of {len(turns)} rounds (same process, alternating)")


def _recall(turns, outs) -> float:
    hits = sum(int((res[0].numpy() == gold[:, None]).any(axis=1).sum())
               for (_, _, gold), res in zip(turns, outs))
    return hits / sum(len(t[0]) for t in turns)


def _open_loop(serving, index, requests, rate, label, **cfg) -> None:
    """Run 6: `requests` arrive at `rate` per second on the host clock;
    `submit(now=...)`, then `poll(now=...)` until the next arrival is due,
    then poll until everything resolved. A request's latency runs from
    its arrival to the first poll that finds it resolved."""
    reg = obs.MetricsRegistry()
    rt = ServingRuntime(index, RuntimeConfig(
        max_batch=SERVE_TENANTS, max_wait=OPEN_WAIT,
        async_depth=OPEN_DEPTH, **cfg), registry=reg)
    resolved_ctr = reg.counter("serve_requests_resolved")
    arrive, done_at, handles = {}, {}, []
    outstanding: list = []
    seen = [0]

    def harvest(now):
        if resolved_ctr.value == seen[0]:
            return
        seen[0] = resolved_ctr.value
        keep = []
        for h in outstanding:
            if h.state == "resolved":
                if h.request_id in done_at:
                    raise AssertionError(f"serving {label}: request "
                                         f"{h.request_id} resolved twice")
                done_at[h.request_id] = now
            else:
                keep.append(h)
        outstanding[:] = keep

    def drive():
        t_start = time.monotonic()
        for i, (t, q, _) in enumerate(requests):
            due = t_start + i / rate
            now = time.monotonic()
            while now < due:
                rt.poll(now=now)
                harvest(time.monotonic())
                now = time.monotonic()
            h = rt.submit(t, q, now=now)
            arrive[h.request_id] = now
            outstanding.append(h)
            handles.append(h)
            harvest(time.monotonic())
        while outstanding:
            rt.poll(now=time.monotonic())
            harvest(time.monotonic())
        return time.monotonic() - t_start

    secs = serving.path(drive, cached=cfg.get("cache_bytes", 0) > 0)
    n = len(requests)
    if (len(done_at) != n or rt.queries_served != n or rt.pending()
            or rt.in_flight() or resolved_ctr.value != n
            or any(h.state != "resolved" for h in handles)):
        raise AssertionError(f"serving {label}: {len(done_at)} of {n} "
                             "requests resolved")
    owner = index.arena.owner.cpu().numpy()
    hits = 0
    for h, (t, _, gold) in zip(handles, requests, strict=True):
        ids = h.result().indices.numpy()
        if ((ids >= 0) & (owner[np.maximum(ids, 0)] != t)).any():
            raise AssertionError(f"serving {label}: a request shows another "
                                 "tenant's row")
        hits += int(gold in ids)
    lat = sorted(done_at[h.request_id] - arrive[h.request_id]
                 for h in handles)
    p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1,
                                          int(len(lat) * 0.99))]
    log(f"serving {label}: {n} requests from {TENANTS} tenants at "
        f"{rate:.1f}/s (host clock), max_wait {OPEN_WAIT * 1e3:.0f} ms, "
        f"max_batch {SERVE_TENANTS}, async_depth {OPEN_DEPTH}: latency "
        f"p50_ms {p50 * 1e3:.3f} p99_ms {p99 * 1e3:.3f} max_ms "
        f"{lat[-1] * 1e3:.3f}; {rt.launches} launches, mean occupancy "
        f"{n / rt.launches:.2f}; served in {secs:.3f} s "
        f"({n / secs:.1f} queries/s); recall@{K} {hits / n:.4f}; every "
        "request resolved once, 0 leaks")


def _resident_kernels(dev, cache, arena) -> list[dict]:
    """The resident routes of #6 and #8 against their plain versions on the
    warm run's combined plane (N + S * T_BLOCK_ROWS rows) and its sign
    plane, B = 32 lanes of T_NPROBE * 4 blocks, half in the arena region
    and half in the slab region; timed beside the same kernels over the
    arena plane alone."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    comb = cache.slab_plane
    sign_comb = cache.sign_plane
    br = T_BLOCK_ROWS
    nb, s = N // br, cache.num_slab_blocks
    j = T_NPROBE * 4
    ids = _resident_ids(gen, dev, nb, s)
    plane_ids = torch.randint(0, nb, (B, j), generator=gen, device=dev,
                              dtype=torch.int32)
    q = torch.randint(-128, 128, (B, D), generator=gen, device=dev,
                      dtype=torch.int8)
    q_msb = quantization.msb_nibble(q)
    q_eo = ops.pack_queries_even_odd(q_msb)
    q_sign = ops.pack_query_signs(q)
    d2, d8, r_view = D // 2, D // 8, j * br
    view = bitplanar.expand_block_rows(ids, br)
    uniq = int(torch.unique(view).numel())
    rows = []

    def gather(qm, plane, block_ids):
        return ops.stage1_scores_gather_resident(qm, plane, block_ids,
                                                 block_rows=br)

    def gather_plain(qm, plane, block_ids):
        return ref.stage1_gather_resident_ref(ops.pack_queries_even_odd(qm),
                                              plane, block_ids, br)

    def sign(qs, plane, block_ids):
        return ops.stage0_sign_scores_gather_resident(qs, plane, block_ids,
                                                      block_rows=br)

    def sign_plain(qs, plane, block_ids):
        return ref.stage0_sign_gather_resident_ref(qs, plane, block_ids, br)

    for name, fn, plain, args, kernel_src, replaces, symbol in (
            ("stage1_gather_resident", gather, gather_plain,
             (q_msb, comb, ids), "src/repro_torch/csrc/stage1_gather.cu",
             "src/repro/kernels/stage1_gather.py:65", "gather_tma_kernel"),
            ("stage0_sign_gather_resident", sign, sign_plain,
             (q_sign, sign_comb, ids), "src/repro_torch/csrc/stage0_sign.cu",
             "src/repro/kernels/stage0_sign.py:113", SIGN_POPC)):
        err = _check_kernel(name, fn, plain, args,
                            f"B={B} J={j} BR={br} D={D} on {comb.shape[0]} "
                            "combined rows")
        plane = args[1]
        gathered = plane[view.long()]
        if name == "stage1_gather_resident":
            operand = bitplanar.unpack_nibble_plane_signed(
                gathered.reshape(B * r_view, d2)).reshape(B, r_view, D)
            col = q_msb.float()[:, :, None]
            t_bound, by = bound_ms(2 * B * d2 + B * j * 4 + uniq * d2
                                   + B * r_view * 4, 2 * B * r_view * D)
            arena_args = (q_msb, arena.msb_plane, plane_ids)
        else:
            operand = bitplanar.unpack_sign_pm1(gathered)
            col = q_sign.float()[:, :, None]
            t_bound, by = bound_ms(B * D + B * j * 4 + uniq * d8
                                   + B * r_view * 4, 2 * B * r_view * D)
            arena_args = (q_sign, arena.sign_plane, plane_ids)
        operand = operand.float()
        lib_ms = _library_ms(name, lambda: torch.bmm(operand, col),
                             fn(*args))
        turns = ""
        if name == "stage1_gather_resident":
            turns = _turns_note(lambda: fn(*args),
                                lambda: torch.bmm(operand, col))
        del gathered, operand
        ms = time_ms(lambda: fn(*args))
        dev_us = kernel_device_us(lambda: fn(*args), symbol)
        arena_ms = time_ms(lambda: fn(*arena_args))
        arena_us = kernel_device_us(lambda: fn(*arena_args), symbol)
        rows.append(dict(
            name=name, route="cuda", source=kernel_src, replaces=replaces,
            max_abs_err=err, ms=ms,
            plain_ms=time_ms(lambda: plain(*args)), bound_ms=t_bound,
            bound_by=by, library_ms=lib_ms))
        log(f"kernel {name}: kernel_ms {ms:.4f} device_only_us {dev_us}"
            f"{_share(t_bound, dev_us)} on "
            f"the combined plane ({comb.shape[0]} rows, {s} slab slots, ids "
            f"in both regions), beside the plane gather over the arena "
            f"plane alone: kernel_ms {arena_ms:.4f} device_only_us "
            f"{arena_us}; plain_ms {rows[-1]['plain_ms']:.4f} bound_us "
            f"{t_bound * 1e3:.2f} ({by}) library_ms {lib_ms:.4f} (one "
            f"torch.bmm on the pre-gathered, pre-unpacked operand){turns}; "
            "bit-exact")
        if name == "stage1_gather_resident":
            split = _resident_split(q_msb, comb, ids, br)
            log(f"kernel {name} host split (us per call, {HOST_CALLS} "
                f"calls, median of 3 rounds): {split}")
        if name == "stage0_sign_gather_resident":
            # The bulk-copy kernel at the same shape (the route keeps the
            # popcount one here: its launcher answers 1), held to it.
            if _sign_answer(sign_comb, br) != 1:
                raise AssertionError("the resident shape is not the bulk "
                                     "route's only (answer 1)")

            def bulk(*a):
                return stage0_sign_gather(
                    *a, block_rows=br, route="bulk",
                    counter="stage0_sign_gather_resident")
            _check_kernel(f"{name} (bulk)", bulk, fn, args,
                          f"B={B} J={j} BR={br} D={D}, bulk against popcount")
            bulk_us = kernel_device_us(lambda: bulk(*args), SIGN_BULK)
            log(f"kernel {name} bulk route: kernel_ms "
                f"{time_ms(lambda: bulk(*args)):.4f} device_only_us "
                f"{bulk_us}{_share(t_bound, bulk_us)} on the combined "
                f"plane; equal to the popcount route")
    return rows


def _count_against_profile(label, fn, counter, symbol, reps=20,
                           traces=8) -> None:
    """ROADMAP C6: `reps` calls of a wrapper with its launch counter read
    before and after and the calls traced: in one window opened at the
    first call (printed), then after a warm-up step (`_traced`). Every
    window must count `reps` launches per step, and no trace may hold more
    kernel instances than that. The trace can drop kernel records even
    after a warm-up step, so up to `traces` of them are taken and one must
    hold exactly `reps`."""
    from torch.profiler import ProfilerActivity, profile

    def instances(prof):
        events = [e for e in prof.key_averages() if symbol in e.key]
        return (sum(e.count for e in events),
                sum(e.self_device_time_total for e in events))
    fn()
    torch.cuda.synchronize()
    before = ops.launch_counts().get(counter, 0)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    single, single_us = instances(prof)
    counted = [ops.launch_counts().get(counter, 0) - before]
    kept = []
    while len(kept) < traces and reps not in kept:
        mid = ops.launch_counts().get(counter, 0)
        warmed, warmed_us = instances(_traced(fn, reps))
        counted.append((ops.launch_counts().get(counter, 0) - mid) // 2)
        kept.append(warmed)
    log(f"serving c6 {label}: {reps} calls per window; one window opened "
        f"at the first call: {counted[0]} {counter} launches counted, "
        f"{single} {symbol} instances traced "
        f"({single_us / max(single, 1):.3f} us each); after a warm-up step: "
        f"{counted[1:]} counted in the kept steps, {kept} traced "
        f"({warmed_us / max(warmed, 1):.3f} us each in the last)")
    if (any(c != reps for c in counted) or max(kept + [single]) > reps
            or reps not in kept):
        raise AssertionError(f"serving c6 {label}: launches counted "
                             f"{counted}, kernel instances traced after a "
                             f"warm-up step {kept}, for {reps} calls")


def _tiered_runs(serving, index, closed, pcold, demand, runs, owner) -> None:
    """The precision tiers on the session trace with the prescreen on (the
    index's config): (a) the pressured budget at full precision, (b) the
    same budget with `precision_tiers`. Both bit-identical to the
    prescreen cold run; (b) must demote and promote, hold more residents
    than the slab has slots, reconcile, and dispatch without a host sync.
    Their stage-1 plane bytes are printed, not checked: on a session trace
    the reference's tiers stream more of them than full precision
    (tests/test_torch_serve_runtime.py::
    test_precision_tiers_on_a_session_trace_trade_stage1_for_stage0 holds
    the reference's ledgers so). Then ROADMAP C6 on #8's resident route."""
    pressured = dict(cache_bytes=demand // 4, preload=True, prior_clusters=8)
    done = {}
    for label, cfg in (("prescreen_pressured", pressured),
                       ("tiered", dict(pressured, precision_tiers=True))):
        rt, lat, outs, plans = _closed_loop(serving, index, closed, True,
                                            **cfg)
        _same_outs(label, outs, pcold)
        _no_leak(label, owner, closed, outs)
        _reconcile(label, rt, plans)
        streamed = rt.stage1_bytes_streamed
        stats = rt.cache_stats()
        runs[label] = _report_run(
            f"{label} (cache_bytes {cfg['cache_bytes']}, preload, prescreen "
            f"C0 {T_PRESCREEN_C0}"
            + (", precision_tiers)" if label == "tiered" else ")"),
            rt, lat, closed)
        if runs[label]["syncs"]:
            raise AssertionError(f"serving {label}: {runs[label]['syncs']} "
                                 "host syncs per dispatch")
        done[label] = (rt, streamed, stats)
    (a_rt, a_streamed, _), (b_rt, b_streamed, b_stats) = (
        done["prescreen_pressured"], done["tiered"])
    tiers = b_stats["sign_entries"] + b_stats["full_entries"]
    if not (b_stats["demotions"] > 0 and b_stats["promotions"] > 0):
        raise AssertionError(f"serving tiered: demotions "
                             f"{b_stats['demotions']}, promotions "
                             f"{b_stats['promotions']}")
    if not tiers > b_rt.cache.num_slab_blocks:
        raise AssertionError(f"serving tiered: {tiers} residents for "
                             f"{b_rt.cache.num_slab_blocks} slab blocks")
    a, b = runs["prescreen_pressured"], runs["tiered"]
    log(f"serving tiers: stage-0+1 device-memory bytes per query: no "
        f"prescreen, full precision (pressured) {runs['pressured']['bpq']:.1f}"
        f"; (a) prescreen, full precision {a['bpq']:.1f}; (b) prescreen, "
        f"tiers {b['bpq']:.1f}; no-prescreen full precision / (b) "
        f"{runs['pressured']['bpq'] / b['bpq']:.3f} (the reference bench "
        f"holds 1.2; printed, not checked); stage-1 plane bytes from device "
        f"memory (a) {a_streamed} (b) {b_streamed}, (b) / (a) "
        f"{b_streamed / max(a_streamed, 1):.3f} (printed, not checked); "
        f"p50_turn_ms (a) {a['p50'] * 1e3:.3f}"
        f" (b) {b['p50'] * 1e3:.3f}; max_turn_ms (a) {a['max'] * 1e3:.3f} "
        f"(b) {b['max'] * 1e3:.3f}; hit_rate (a) {a['hit_rate']:.4f} (b) "
        f"{b['hit_rate']:.4f}; (b) tiers {b['stats']}, {tiers} residents "
        f"for {b_rt.cache.num_slab_blocks} slab blocks; both bit-identical "
        "to the prescreen cold run, 0 syncs per dispatch")
    del a_rt
    # ROADMAP C6: #8's resident route, on the tiered cache's combined sign
    # plane and on the arena's sign plane alone.
    gen = torch.Generator(device=index.device).manual_seed(SEED + 6)
    q_sign = ops.pack_query_signs(torch.randint(
        -128, 128, (B, D), generator=gen, device=index.device,
        dtype=torch.int8))
    cache, br = b_rt.cache, T_BLOCK_ROWS
    nb = N // br
    for label, plane, hi in (
            ("combined sign plane", cache.sign_plane,
             nb + cache.num_slab_blocks),
            ("arena sign plane", index.arena.sign_plane, nb)):
        ids = torch.randint(0, hi, (B, T_NPROBE * 4), generator=gen,
                            device=index.device, dtype=torch.int32)
        _count_against_profile(
            label, lambda: ops.stage0_sign_scores_gather_resident(
                q_sign, plane, ids, block_rows=br),
            "stage0_sign_gather_resident", SIGN_POPC)
    del b_rt


def phase_serving(dev, serving, index, traces) -> list[dict]:
    """The serving runtime at full width: the tenancy phase's clustered
    index (512 tenants x 2048 docs, K = 64, nprobe 8, 64-row blocks,
    compacted, cosine, k = 5) served through `ServingRuntime` on the
    session trace, cold, warm, under pressure, warm synchronous, with the
    sign prescreen cold and warm, then open loop; plus the resident gather
    kernels on the warm run's combined plane. Returns those kernels'
    rows."""
    t0 = time.perf_counter()
    closed, open_requests = traces
    owner = index.arena.owner.cpu().numpy()
    br, d2 = T_BLOCK_ROWS, D // 2
    session = closed[0][0]
    slots = sum(HotClusterCache.entry_blocks(rows, br)
                for t in session.tolist()
                for rows in index.cluster_rows(t).values())
    demand = slots * br * d2
    log(f"serving demand: the {SERVE_TENANTS} session tenants' packed views "
        f"take {slots} slots of {br * d2} bytes = {demand} bytes "
        f"({demand / SERVE_TENANTS / 2 ** 20:.3f} MiB per tenant)")
    base = index.cfg
    warm_cfg = dict(cache_bytes=demand, preload=True)

    cold_rt, lat, cold, plans = _closed_loop(serving, index, closed, False)
    recall = _recall(closed, cold)
    for i, (tids, q, _) in enumerate(closed):
        want = index.retrieve(torch.from_numpy(q).to(dev), tids)
        _same_outs("cold against index.retrieve", [cold[i]],
                   [tuple(getattr(want, f).cpu() for f in FIELDS)])
    index.cfg = dataclasses.replace(base, backend="torch")
    try:
        _, _, plain, _ = _closed_loop(serving, index, closed, False)
    finally:
        index.cfg = base
    _same_outs("cold on the plain backend", plain, cold)
    _no_leak("cold", owner, closed, cold)
    _reconcile("cold", cold_rt, plans)
    cold_bytes = cold_rt.stage1_bytes_streamed
    _report_run("cold (cache_bytes 0)", cold_rt, lat, closed, recall)
    log("serving cold: bit-identical, lane for lane, to index.retrieve of "
        "the same batch and to the runtime on the plain backend")

    runs = {}
    for label, cfg in (
            ("warm", warm_cfg),
            ("pressured", dict(cache_bytes=demand // 4, preload=True)),
            ("warm_sync", dict(warm_cfg, async_depth=0))):
        rt, lat, outs, plans = _closed_loop(serving, index, closed, True,
                                            **cfg)
        _same_outs(label, outs, cold)
        _no_leak(label, owner, closed, outs)
        _reconcile(label, rt, plans)
        _split_check(label, index, closed, plans, label != "pressured")
        if label == "warm" and not rt.stage1_bytes_streamed < cold_bytes:
            raise AssertionError("serving warm: stage1_bytes_streamed "
                                 f"{rt.stage1_bytes_streamed} not below the "
                                 f"cold run's {cold_bytes}")
        runs[label] = _report_run(f"{label} (cache_bytes {cfg['cache_bytes']}"
                                  f", preload, async_depth "
                                  f"{rt.cfg.async_depth})", rt, lat, closed)
        if label == "warm":
            warm_rt = rt
        else:
            del rt
    log("serving warm, pressured, warm_sync: bit-identical to the cold run; "
        "0 leaks; stage-1 bytes reconcile with every launch's plan; every "
        "launch's hit/miss split fits its probed clusters (warm and "
        "warm_sync: all hits)")
    _in_turns(cold_rt, warm_rt, closed)

    index.cfg = dataclasses.replace(base, prescreen_c0=T_PRESCREEN_C0)
    try:
        pc_rt, lat_c, pcold, plans = _closed_loop(serving, index, closed,
                                                  False)
        for i, (tids, q, _) in enumerate(closed):
            want = index.retrieve(torch.from_numpy(q).to(dev), tids)
            _same_outs("prescreen cold against index.retrieve", [pcold[i]],
                       [tuple(getattr(want, f).cpu() for f in FIELDS)])
        _reconcile("prescreen cold", pc_rt, plans)
        pw_rt, lat_w, pwarm, plans = _closed_loop(serving, index, closed,
                                                  True, **warm_cfg)
        _same_outs("prescreen warm", pwarm, pcold)
        _no_leak("prescreen warm", owner, closed, pwarm)
        _reconcile("prescreen warm", pw_rt, plans)
        _report_run(f"prescreen_{T_PRESCREEN_C0} cold", pc_rt, lat_c, closed)
        _report_run(f"prescreen_{T_PRESCREEN_C0} warm", pw_rt, lat_w, closed)
        del pc_rt, pw_rt
        _tiered_runs(serving, index, closed, pcold, demand, runs, owner)
    finally:
        index.cfg = base

    rate = runs["warm"]["qps"] / 2
    _open_loop(serving, index, open_requests, rate, "open_loop cold")
    _open_loop(serving, index, open_requests, rate,
               "open_loop cached (prior warming)", cache_bytes=demand)

    rows = _resident_kernels(dev, warm_rt.cache, index.arena)
    del warm_rt
    log(f"serving path launches: {serving.launches}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    for key in SERVING_KERNELS:
        if serving.launches.get(key, 0) <= 0:
            raise AssertionError(f"kernel {key} was not launched by the "
                                 "serving path")
    for key in SERVING_OFF_PATH:
        if serving.launches.get(key, 0):
            raise AssertionError(f"kernel {key} was launched by the serving "
                                 "path, which should not take it")
    return rows


# -- the decode phase ----------------------------------------------------
# qwen2-0.5b's attention widths (src/repro/configs/qwen2_0_5b.py): 24
# layers, 14 query heads over 2 KV heads (G = 7), head dim 896 / 14 = 64.
# B = 8 sequences over a T = 32768-position cache (the T of the reference
# bench's decode ledger), top_k 256, 16-row pages; npages 256 is the
# bench's T // 16 // 8, C0 1024 a quarter of its 4096-position view. The
# wide check: minitron-4b's (src/repro/configs/minitron_4b.py), one layer.
DEC_LAYERS, DEC_H, DEC_KH, DEC_HD = 24, 14, 2, 64
DEC_B, DEC_T, DEC_TOPK, DEC_PR = 8, 32768, 256, 16
DEC_NPAGES, DEC_C0, DEC_STEPS = DEC_T // DEC_PR // 8, 1024, 20
DEC_SCHEDULES = (("flat", {}), ("paged", dict(npages=DEC_NPAGES)),
                 ("paged_prescreen", dict(npages=DEC_NPAGES,
                                          prescreen_c0=DEC_C0)),
                 ("full_coverage", dict(npages=DEC_T // DEC_PR)))
WIDE_H, WIDE_KH, WIDE_HD, WIDE_B = 24, 8, 128, 4
DEC_KERNELS = ("stage1_rows", "stage0_sign_gather")


def _decode_lengths(gen, dev, b):
    """One empty sequence, one below top_k, the rest in [T/2, T]."""
    rest = torch.randint(DEC_T // 2, DEC_T + 1, (b - 2,), generator=gen,
                         device=dev)
    return torch.cat([torch.tensor([0, 100], device=dev),
                      rest]).to(torch.int32)


def _decode_layer(gen, dev, b, kh, hd, length, dense=False):
    """One layer's cache from the generator: K in f32 quantized to nibble
    planes with page centroids, V in bf16; with `dense`, also K and V as
    (B, KH, T, hd) bf16 for the dense yardstick."""
    k = torch.randn(b, DEC_T, kh, hd, generator=gen, device=dev)
    v = torch.randn(b, DEC_T, kh, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    cache = sparse_kv.build_page_centroids(
        sparse_kv.build_quant_cache(k, v), length, DEC_PR)
    if not dense:
        return cache, None
    return cache, (k.to(torch.bfloat16).transpose(1, 2).contiguous(),
                   v.transpose(1, 2).contiguous())


def _decode_step(caches, qs, length, backend, top_k=DEC_TOPK, **kw):
    """One decode step: the cascade of every layer, on `backend`."""
    return [sparse_kv.sparse_decode_attention(q, c, length, top_k,
                                              page_rows=DEC_PR,
                                              backend=backend, **kw)
            for q, c in zip(qs, caches, strict=True)]


def _dense_step(qs, dense, length, scale):
    """Dense attention over bf16 K and V in plain PyTorch (the yardstick):
    every position streamed, softmax in f32."""
    outs = []
    valid = (torch.arange(DEC_T, device=length.device)[None, None, None, :]
             < length[:, None, None, None])
    for q, (k, v) in zip(qs, dense, strict=True):
        qg = q.reshape(DEC_B, DEC_KH, -1, DEC_HD).to(torch.bfloat16)
        s = torch.matmul(qg, k.transpose(-1, -2)).float() * scale
        p = torch.softmax(s.masked_fill(~valid, -1e30), dim=-1)
        outs.append(torch.matmul(p.to(torch.bfloat16), v))
    return outs


def _median_step_s(fn, steps: int) -> float:
    """Median seconds of `fn` on the host clock, each call synchronized."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _same_layers(label, got, want) -> None:
    for layer, (g, w) in enumerate(zip(got, want, strict=True)):
        if not torch.equal(g, w):
            raise AssertionError(f"decode {label}: layer {layer} differs")


def _capture(name):
    """Patch `ops.<name>` to record its first call's arguments."""
    real = getattr(ops, name)
    seen = []

    def spy(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return real(*args, **kw)
    return mock.patch.object(ops, name, spy), seen


def _decode_kernel_rows(caches, qs, length, counts) -> list[dict]:
    """#2 and #8 at the operands one paged + prescreen step gives them at
    hd = 64 (the first layer's: 112 lanes x 2048 centroid rows of 32 bytes;
    112 lanes in groups of G = 7 over a (16, 256) table of 16-row pages of
    the flat 8-byte sign plane), against their plain versions, timed, with
    their byte bounds and a torch.bmm f32 yardstick on the pre-unpacked
    operand. #8 runs on both routes over the grouped table and on the
    popcount route over the per-lane table the port passed before."""
    rows_patch, rows_seen = _capture("stage1_scores_rows")
    sign_patch, sign_seen = _capture("stage0_sign_scores_gather")
    with rows_patch, sign_patch:
        _decode_step(caches[:1], qs[:1], length, "cuda",
                     **dict(DEC_SCHEDULES)["paged_prescreen"])
    (q_nib, cent_rows), _ = rows_seen[0]
    (q_sign, flat_sign, blk), kw = sign_seen[0]
    group = kw["group"]
    if (blk.shape[0] * group != q_sign.shape[0] or group != DEC_H // DEC_KH
            or _sign_answer(flat_sign, DEC_PR, group) != 2):
        raise AssertionError(f"decode: the prescreen passed a "
                             f"{tuple(blk.shape)} table in groups of "
                             f"{group} for {q_sign.shape[0]} lanes")
    lanes, p, d2 = cent_rows.shape
    d = 2 * d2
    q_eo = ops.pack_queries_even_odd(q_nib)
    r_view = blk.shape[1] * DEC_PR
    out = []
    view = bitplanar.expand_block_rows(blk, DEC_PR)
    uniq = int(torch.unique(view).numel())
    lane_blk = blk.repeat_interleave(group, 0)

    def sign(a, b_, c, route="auto", g=group):
        return stage0_sign_gather(a, b_, c, block_rows=DEC_PR, group=g,
                                  route=route)

    for name, fn, plain, args, lib_args, bytes_moved, macs, src, repl, \
            symbol in (
            ("stage1_rows@decode_hd64", stage1_int4_rows,
             ref.stage1_rows_batched_ref, (q_eo, cent_rows),
             (bitplanar.unpack_nibble_plane_signed(cent_rows).float(),
              q_nib.float()[:, :, None]),
             2 * lanes * d2 + lanes * p * d2 + lanes * p * 4, lanes * p * d,
             "src/repro_torch/csrc/stage1_rows.cu",
             "src/repro/kernels/stage1_int4.py:120", "rows_kernel"),
            ("stage0_sign_gather@decode_hd64", sign,
             lambda a, b_, c: ref.stage0_sign_gather_ref(a, b_, c, DEC_PR,
                                                         group=group),
             (q_sign, flat_sign, blk),
             (bitplanar.unpack_sign_pm1(
                 flat_sign[bitplanar.expand_block_rows(lane_blk, DEC_PR)
                           .long()]).float(),
              q_sign.float()[:, :, None]),
             lanes * d + blk.numel() * 4 + uniq * (d // 8)
             + lanes * r_view * 4, lanes * r_view * d,
             "src/repro_torch/csrc/stage0_sign_gather.cu",
             "src/repro/kernels/stage0_sign.py:113", SIGN_BULK)):
        err = _check_kernel(name, fn, plain, args,
                            f"{lanes} lanes, D = {d} (decode)")
        lib_ms = _library_ms(name, lambda: torch.bmm(*lib_args), fn(*args))
        t_bound, by = bound_ms(bytes_moved, 2 * macs)
        row = dict(name=name, route="cuda", source=src, replaces=repl,
                   launches=counts[name.split("@")[0]], max_abs_err=err,
                   ms=time_ms(lambda: fn(*args)),
                   plain_ms=time_ms(lambda: plain(*args)), bound_ms=t_bound,
                   bound_by=by, library_ms=lib_ms)
        dev_us = kernel_device_us(lambda: fn(*args), symbol)
        log(f"kernel {name}: kernel_ms {row['ms']:.4f} device_only_us "
            f"{dev_us}{_share(t_bound, dev_us)} plain_ms "
            f"{row['plain_ms']:.4f} bound_us "
            f"{t_bound * 1e3:.2f} ({by}) library_ms {lib_ms:.4f} (one "
            f"torch.bmm f32 on the pre-unpacked operand); launches per "
            f"decode step {DEC_LAYERS}; bit-exact")
        out.append(row)
        del lib_args
    # #8's other forms at the same operands: the popcount kernel over the
    # grouped table, and over the per-lane (112, 256) table, the form the
    # prescreen passed before the grouped one (its ids counted 7 times).
    want = sign(q_sign, flat_sign, blk)
    for label, fn in (
            ("popc route, grouped table",
             lambda: sign(q_sign, flat_sign, blk, "popc")),
            ("popc route, per-lane table",
             lambda: sign(q_sign, flat_sign, lane_blk, "popc", 1))):
        if not torch.equal(fn(), want):
            raise AssertionError(f"decode #8 {label} disagrees with the "
                                 "bulk route")
        log(f"kernel stage0_sign_gather@decode_hd64 {label}: kernel_ms "
            f"{time_ms(fn):.4f} device_only_us "
            f"{kernel_device_us(fn, SIGN_POPC)}; equal to the bulk route")
    _sign_floor(torch.Generator(device=flat_sign.device).manual_seed(SEED),
                flat_sign.device, d, DEC_PR, "decode")
    return out


def phase_decode(dev) -> tuple[list[dict], dict[str, int]]:
    """The decode path at qwen2-0.5b's attention widths over a 32k cache:
    four schedules (flat, paged, paged + prescreen, paged at full
    coverage), each a 24-layer step on the "cuda" and the "torch"
    backend. Returns the decode-shape kernel rows and the path's
    launches (one driven step per schedule)."""
    t0 = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("decode: TF32 is on for float32 products")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    length = _decode_lengths(gen, dev, DEC_B)
    torch.cuda.reset_peak_memory_stats()
    layers = [_decode_layer(gen, dev, DEC_B, DEC_KH, DEC_HD, length,
                            dense=True) for _ in range(DEC_LAYERS)]
    caches = [c for c, _ in layers]
    dense = [d for _, d in layers]
    del layers
    qs = [torch.randn(DEC_B, 1, DEC_H, DEC_HD, generator=gen, device=dev)
          for _ in range(DEC_LAYERS)]
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in (c.k_msb, c.k_lsb, c.k_scale, c.v, c.cent_msb,
                                c.cent_scale))
    log(f"decode cache: {DEC_LAYERS} layers x B={DEC_B} x T={DEC_T} x "
        f"KH={DEC_KH} x hd={DEC_HD} (H={DEC_H}), lengths "
        f"{length.tolist()}: {cache_bytes} bytes on the card "
        f"({cache_bytes / DEC_LAYERS / 1e6:.1f} MB per layer; the dense "
        f"yardstick's bf16 K and V beside it); built in "
        f"{time.perf_counter() - t0:.1f} s")
    launches: dict[str, int] = {}
    outs = {}
    index = MultiTenantIndex(64, 64, RetrievalConfig(), device=dev)
    dense_all = sparse_kv.dense_bytes_per_step(DEC_T, DEC_HD) * (
        DEC_B * DEC_KH * DEC_LAYERS)
    for label, kw in DEC_SCHEDULES:
        ops.reset_launch_counts()
        got = _decode_step(caches, qs, length, "cuda", **kw)
        counts = ops.launch_counts()
        want = {"stage1_rows": DEC_LAYERS if "npages" in kw else 0,
                "stage0_sign_gather": (DEC_LAYERS if "prescreen_c0" in kw
                                       else 0)}
        if {k: n for k, n in counts.items() if n} != {
                k: n for k, n in want.items() if n}:
            raise AssertionError(f"decode {label}: one step launched "
                                 f"{counts}, expected {want}")
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
        ops.reset_launch_counts()
        plain = _decode_step(caches, qs, length, "torch", **kw)
        if any(ops.launch_counts().values()):
            raise AssertionError(f"decode {label}: the torch backend "
                                 "launched a kernel")
        _same_layers(f"{label} cuda against torch", got, plain)
        for layer, o in enumerate(got):
            if o.isnan().any() or o[0].any():
                raise AssertionError(f"decode {label}: layer {layer} has a "
                                     "NaN or a nonzero empty sequence")
        outs[label] = got
        cfg = engine.KVCascadeConfig(top_k=DEC_TOPK, page_rows=DEC_PR, **kw)
        plan = engine.kv_plan(cfg, batch=DEC_B, kv_heads=DEC_KH,
                              q_heads=DEC_H, seq_len=DEC_T,
                              head_dim=DEC_HD, layers=DEC_LAYERS)
        plan_bytes = sum(st.bytes_hbm for st in plan.stages)
        if label == "flat" and plan_bytes / (
                DEC_B * DEC_KH * DEC_LAYERS) != sparse_kv.sparse_bytes_per_step(
                DEC_T, DEC_HD, DEC_TOPK):
            raise AssertionError("decode: the flat kv_plan does not equal "
                                 "sparse_bytes_per_step per lane")
        rt = ServingRuntime(index, RuntimeConfig())
        rt.account_decode(plan, dim=DEC_HD, tokens=DEC_STEPS)
        if (rt.decode_steps != DEC_STEPS
                or rt.decode_bytes_hbm != DEC_STEPS * plan_bytes):
            raise AssertionError(f"decode {label}: account_decode gave "
                                 f"{rt.decode_steps} steps, "
                                 f"{rt.decode_bytes_hbm} bytes")
        step_s = _median_step_s(
            lambda: _decode_step(caches, qs, length, "cuda", **kw),
            DEC_STEPS)
        kernels = device_profile(
            lambda: _decode_step(caches, qs, length, "cuda", **kw), reps=1)
        busy = sum(t for _, t, _ in kernels) * 1e-3
        launched = sum(n for _, _, n in kernels)
        top = "; ".join(f"{name[:60]} {t * 1e-3:.3f} ms x{n:.0f}"
                        for name, t, n in kernels[:5])
        log(f"decode {label}: p50_step_ms {step_s * 1e3:.3f} tokens_per_s "
            f"{DEC_B / step_s:.1f} device_busy_ms {busy:.3f} idle_share "
            f"{1 - busy / (step_s * 1e3):.3f} kernel_launches_per_step "
            f"{launched:.0f}; kv_plan bytes per step {plan_bytes} "
            f"({dense_all / plan_bytes:.2f}x below dense bf16 K + V, "
            f"{dense_all}); #2 launches {counts.get('stage1_rows', 0)}, "
            f"#8 {counts.get('stage0_sign_gather', 0)} per step; cuda = "
            f"torch bit for bit on every layer; busiest kernels per step: "
            f"{top}")
    _same_layers("full coverage against flat", outs["full_coverage"],
                 outs["flat"])
    legacy = [sparse_kv.sparse_decode_attention_ref(q, c, length, DEC_TOPK)
              for q, c in zip(qs, caches)]
    _same_layers("flat against sparse_decode_attention_ref", outs["flat"],
                 legacy)
    del outs, legacy
    log("decode: full-coverage paged = flat = sparse_decode_attention_ref "
        "bit for bit on every layer; the empty sequence reads exact zeros; "
        "account_decode and the flat ledger hold")

    # top_k = T on one layer: the flat schedule against dense f32 attention
    # over the same dequantized INT8 keys.
    c0, q0 = caches[0], qs[0]
    got = sparse_kv.sparse_decode_attention(q0, c0, length, DEC_T)
    k_deq = (bitplanar.reconstruct_int8(
        c0.k_msb.reshape(-1, DEC_HD // 2), c0.k_lsb.reshape(-1, DEC_HD // 2))
        .reshape(DEC_B, DEC_T, DEC_KH, DEC_HD).float()
        * c0.k_scale[..., None]).transpose(1, 2)
    qg = q0.reshape(DEC_B, DEC_KH, -1, DEC_HD)
    sc = torch.matmul(qg, k_deq.transpose(-1, -2)) * DEC_HD ** -0.5
    valid = (torch.arange(DEC_T, device=dev)[None, None, None, :]
             < length[:, None, None, None])
    e = torch.where(valid, torch.exp(sc.masked_fill(~valid, -1e30)
                                     - sc.masked_fill(~valid, -1e30).amax(
                                         -1, keepdim=True)), 0.0)
    denom = e.sum(-1, keepdim=True)
    want = torch.matmul(e / torch.where(denom > 0, denom, 1.0),
                        c0.v.transpose(1, 2).float()).reshape(got.shape)
    err = float((got - want).abs().max())
    del k_deq, sc, e, want
    if not err <= 1e-4:
        raise AssertionError(f"decode: top_k = T differs from dense f32 "
                             f"attention by {err}")
    log(f"decode: top_k = T (flat, one layer) against dense f32 attention "
        f"over the same INT8 keys: max abs err {err:.3g} (limit 1e-4)")

    # The flat-plane copies the prescreen and the gathered approx stage
    # make (`engine._kv_flat`, as the reference's transpose + reshape).
    d2 = DEC_HD // 2
    plane_b = DEC_B * DEC_T * DEC_KH * d2
    scale_b = DEC_B * DEC_T * DEC_KH * 4
    for label, fn, nbytes in (
            ("k_msb flat copy", lambda: engine._kv_flat(c0.k_msb),
             2 * plane_b),
            ("k_scale flat copy", lambda: engine._kv_flat(c0.k_scale),
             2 * scale_b),
            ("sign plane from the flat k_msb",
             lambda: bitplanar.sign_plane_from_msb(engine._kv_flat(c0.k_msb)),
             2 * plane_b + plane_b // 4)):
        us = sum(t for _, t, _ in device_profile(fn, reps=5))
        log(f"decode flat copies: {label}: {nbytes} bytes per layer "
            f"(read + write), device_us {us:.2f} per layer, "
            f"{us * DEC_LAYERS / 1e3:.3f} ms per {DEC_LAYERS}-layer step "
            f"per use "
            f"(paged: k_msb and k_scale copies once each; paged + "
            f"prescreen: also the sign plane)")

    scale = DEC_HD ** -0.5
    dense_s = _median_step_s(lambda: _dense_step(qs, dense, length, scale),
                             DEC_STEPS)
    log(f"decode dense yardstick (bf16 K and V, plain torch matmul + f32 "
        f"softmax, {DEC_LAYERS} layers; not checked): p50_step_ms "
        f"{dense_s * 1e3:.3f} tokens_per_s {DEC_B / dense_s:.1f}")
    ops.reset_launch_counts()
    rows = _decode_kernel_rows(caches, qs, length, launches)
    del dense, caches, qs
    torch.cuda.empty_cache()

    # Head width 128 (minitron-4b's attention widths), one layer, paged +
    # prescreen: #8 takes its 16-byte loads, #2 reads 64-byte rows.
    wlen = _decode_lengths(gen, dev, WIDE_B)
    wcache, _ = _decode_layer(gen, dev, WIDE_B, WIDE_KH, WIDE_HD, wlen)
    wq = torch.randn(WIDE_B, 1, WIDE_H, WIDE_HD, generator=gen, device=dev)
    kw = dict(DEC_SCHEDULES)["paged_prescreen"]
    ops.reset_launch_counts()
    a = _decode_step([wcache], [wq], wlen, "cuda", **kw)
    counts = ops.launch_counts()
    for key, n in counts.items():
        launches[key] = launches.get(key, 0) + n
    b = _decode_step([wcache], [wq], wlen, "torch", **kw)
    _same_layers("hd 128 cuda against torch", a, b)
    if counts["stage1_rows"] != 1 or counts["stage0_sign_gather"] != 1:
        raise AssertionError(f"decode hd 128: launched {counts}")
    log(f"decode hd 128 (H={WIDE_H}, KH={WIDE_KH}, B={WIDE_B}, "
        f"T={DEC_T}, one layer, paged + prescreen): cuda = torch bit for "
        f"bit; #2 and #8 one launch each")
    del wcache
    torch.cuda.empty_cache()
    log(f"decode path launches: "
        f"{ {k: n for k, n in launches.items() if n} }; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; the phase "
        f"took {time.perf_counter() - t0:.1f} s")
    for key in DEC_KERNELS:
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"kernel {key} was not launched by the "
                                 "decode path")
    return rows, launches


# -- the sharded phase -----------------------------------------------------
# ROADMAP A2's serving half on the card: S logical shard slots on cuda:0
# (the routing, tournament, placement and failover logic of S cards; no
# multi-card scaling is measured). (a) `ShardedIndex` over the arena
# corpus at 1, 3 (2^20 mod 3 = 1: 2 pad rows) and 8 slots (the reference's
# (4, 2) test mesh); (b) `ShardedServingRuntime` with the arena corpus's
# 512 users as 512 tenants over 4 shards of 2^19 rows, a 1536-request
# trace (3 per tenant) driven as the reference launcher's `drive` does
# (a poll every 32 submits), each run against a 1-shard baseline of 2^20
# rows; (c) `RAGPipeline.build(mesh=)` and the two launchers, from the
# rag phase.
SHARD_SHAPES = ((1, 1), (3, 1), (4, 2))
SHARD_KERNELS = ("stage1_plane_mma", "stage2_by_id")
SHARD_OFF_PATH = ("stage1_plane", "stage2_exact")
# ShardedServingRuntime: a MultiTenantIndex per shard, each batch through
# the engine's one-launch exact stage; the merge runs on the host.
SRV_KERNELS = ("stage1_plane_mma", "stage2_rerank_by_id")
SRV_OFF_PATH = SHARD_OFF_PATH + ("stage2_by_id", "stage2_rerank")
SRV_SHARDS, SRV_CAPACITY, SRV_PER_TENANT, SRV_ROUNDS = 4, 1 << 19, 3, 2
SRV_FAIL_AT = 768       # request 768 is tenant 256's second
SRV_RUNS = (            # (label, metric, spread, fail at)
    ("mips", "mips", 1, -1), ("mips_spread2", "mips", 2, -1),
    ("cosine", "cosine", 1, -1), ("mips_failover", "mips", 1, SRV_FAIL_AT))


def _add_counts(total: dict[str, int], counts: dict[str, int]) -> None:
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n


def _plane_at_shard(card, q_msb, plane) -> dict:
    """#1 at one shard's shape: CUDA-event time, device-only time (per
    call from one trace, and per launch over three), bound and
    `torch._int_mm` (its column count padded to a
    multiple of 8, as `_int_mm` requires) on the same operands, the
    kernel's result equal to the plain version's. Returns the kernels-line
    row (launches left to the caller)."""
    n, d2 = plane.shape
    panel = ops.pack_query_panel(q_msb)

    def fn():
        return stage1_int4_batched(panel, plane)
    want = fn()
    err = _check_kernel("stage1_plane_mma@shard", lambda: want,
                        lambda: ref.stage1_scores_batched_ref(panel, plane),
                        (), f"n_local={n}")
    n8 = -(-n // 8) * 8
    unpacked = torch.zeros((n8, D), dtype=torch.int8, device=plane.device)
    unpacked[:n] = bitplanar.unpack_nibble_plane_signed(plane)
    unpacked_t = unpacked.t()
    q8 = q_msb.contiguous()
    if not torch.equal(torch._int_mm(q8, unpacked_t)[:, :n], want):
        raise AssertionError("sharded: torch._int_mm disagrees with #1 at "
                             f"n_local={n}")
    lib_ms = time_ms(lambda: torch._int_mm(q8, unpacked_t))
    turns = _turns_note(fn, lambda: torch._int_mm(q8, unpacked_t))
    del unpacked, unpacked_t
    moved = 2 * B * d2 + n * d2 + B * n * 4
    t_bound, by = bound_ms(moved, 2 * B * n * D)
    dev_us = kernel_device_us(fn, "::plane_mma_kernel<")
    floor = t_bound * 1e3 if moved > L2_BYTES else 0.0
    per_launch = f"{_device_us(fn, '::plane_mma_kernel<', floor):.3f}"
    ms = time_ms(fn)
    log(f"kernel stage1_plane_mma@shard n_local={n} ({card}): kernel_ms "
        f"{ms:.4f} device_only_us {dev_us}, per launch {per_launch} "
        f"bound_us {t_bound * 1e3:.2f} ({by}){_share(t_bound, per_launch)} "
        f"library_ms {lib_ms:.4f} (torch._int_mm on the pre-unpacked int8 "
        f"rows, {n8} columns){turns}")
    return dict(name="stage1_plane_mma@shard", route="cuda",
                source="src/repro_torch/csrc/stage1_mma.cu",
                replaces="src/repro/kernels/stage1_int4.py:79",
                max_abs_err=err, ms=ms,
                plain_ms=time_ms(lambda: ref.stage1_scores_batched_ref(
                    panel, plane)),
                bound_ms=t_bound, bound_by=by, library_ms=lib_ms)


def _pad_rows_on_card(dev) -> None:
    """tests/test_sharded_serving.py:106-135 on the card: six docs
    anti-correlated with the query, padded to 4 slots."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    q = torch.randn(64, generator=gen, device=dev)
    emb = -q[None, :] + 0.05 * torch.randn(6, 64, generator=gen, device=dev)
    bp = bitplanar.BitPlanarDB.from_quantized(
        quantization.build_database(emb, device=dev))
    mesh = make_test_mesh(4, 1)
    index = ShardedIndex(db=shard_database(pad_database(bp, 4), mesh),
                         mesh=mesh, n_global=6)
    qc = quantization.quantize_int8_fixed(q, float(bp.scale))
    res = index.retrieve_fn(RetrievalConfig(k=3, metric="mips"))(qc)
    if bool((res.indices >= 6).any()) or bool((res.scores >= 0).any()):
        raise AssertionError(f"sharded pad rows: ids {res.indices.tolist()} "
                             f"scores {res.scores.tolist()}")


def phase_sharded_index(db, q_codes, gold, dev,
                        card) -> tuple[dict[str, int], dict]:
    """(a): B = 32 batches through `ShardedIndex.retrieve_fn` at 1, 3 and 8
    shard slots on this card, cosine and MIPS, with the launch counts set
    to 0 just before each metric's batches and read just after. Returns
    the path's launches and the kernels-line row of #1 at the 8-slot
    shard's rows (its launches those of the 8-slot batches)."""
    total: dict[str, int] = {}
    q_all = q_codes[:B * BATCHES]
    for shape in SHARD_SHAPES:
        s = shape[0] * shape[1]
        mesh = make_test_mesh(*shape)
        index = ShardedIndex(db=shard_database(pad_database(db, s), mesh),
                             mesh=mesh, n_global=N)
        n_local = index.db[0].num_docs
        for metric in ("cosine", "mips"):
            cfg = RetrievalConfig(k=K, metric=metric)
            fn = index.retrieve_fn(cfg)
            fn(q_all[:B])
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            lat, outs = [], []
            for i in range(BATCHES):
                sl = slice(i * B, (i + 1) * B)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(fn(q_all[sl]))
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
            counts = ops.launch_counts()
            _add_counts(total, counts)
            shard_launches = (counts["stage1_plane_mma"] if metric == "cosine"
                              else shard_launches
                              + counts["stage1_plane_mma"])
            label = f"sharded index S={s} {metric}"
            for key in SHARD_KERNELS:
                if counts[key] != s * BATCHES:
                    raise AssertionError(f"{label}: {key} launched "
                                         f"{counts[key]} times, not {s} per "
                                         f"batch")
            if counts["stage2_rerank"] != BATCHES:
                raise AssertionError(f"{label}: the final rerank launched "
                                     f"{counts['stage2_rerank']} times, not "
                                     "once per batch")
            for key in SHARD_OFF_PATH:
                if counts[key]:
                    raise AssertionError(f"{label}: {key} launched")
            plain = index.retrieve_fn(dataclasses.replace(cfg,
                                                          backend="torch"))
            engine_ = RetrievalEngine(cfg, dev)
            hits = 0
            for i, res in enumerate(outs):
                sl = slice(i * B, (i + 1) * B)
                want = plain(q_all[sl])
                whole = engine_.retrieve(q_all[sl], db, PlainPolicy())
                for field in ("indices", "scores", "candidate_indices"):
                    if not torch.equal(getattr(res, field),
                                       getattr(want, field)):
                        raise AssertionError(f"{label} batch {i}: {field} "
                                             "differs from the plain backend")
                    if not torch.equal(getattr(res, field),
                                       getattr(whole, field)):
                        raise AssertionError(f"{label} batch {i}: {field} "
                                             "differs from the unsharded "
                                             "engine")
                if bool((res.indices >= N).any()):
                    raise AssertionError(f"{label}: a pad row was returned")
                hits += int((res.indices.long() == gold[sl][:, None]).any(
                    dim=1).sum())
            recall = hits / (B * BATCHES)
            if recall < 0.95:
                raise AssertionError(f"{label}: recall@{K} {recall} < 0.95")
            p50 = statistics.median(lat)
            kernels = device_profile(lambda: fn(q_all[:B]))
            busy = sum(t for _, t, _ in kernels) * 1e-6
            launched = sum(n for _, _, n in kernels)
            log(f"{label} ({card}): n_local {n_local} "
                f"({n_local * s - N} pad rows); recall@{K} {recall:.4f} "
                f"p50_batch_ms {p50 * 1e3:.3f} queries_per_s "
                f"{B / p50:.1f}; device_busy_ms {busy * 1e3:.3f} (idle "
                f"share {1 - busy / p50:.3f}); {launched:.0f} kernel "
                f"launches per batch, #1 and #3-by-id {s} each, the final "
                f"rerank 1; equal to "
                f"the plain backend and to the unsharded engine bit for bit")
        if s > 1:
            q_msb = quantization.msb_nibble(q_all[:B])
            row = _plane_at_shard(card, q_msb, index.db[0].msb_plane)
            row["launches"] = shard_launches
        if s == max(a * b for a, b in SHARD_SHAPES):
            split = _plane_split(ops.pack_query_panel(q_msb),
                                 index.db[0].msb_plane[:1024])
            log(f"kernel stage1_plane_mma host split ({card}, 1024 rows, us "
                f"per call): {split}")
            _plane_sweep(card, q_msb)
        del index
        torch.cuda.empty_cache()
    _pad_rows_on_card(dev)
    log(f"sharded index: the all-negative six-document MIPS corpus padded "
        f"to 4 slots returns no pad id and only negative scores")
    return total, row


def _srv_cfg(metric, spread, shards, capacity, backend="cuda"):
    budget = (dict(candidate_frac=1.0, max_candidates=DOCS_PER_USER)
              if metric == "mips" else {})
    return ShardedRuntimeConfig(
        num_shards=shards, capacity_per_shard=capacity, dim=D, spread=spread,
        retrieval=RetrievalConfig(k=K, metric=metric, backend=backend,
                                  **budget),
        runtime=RuntimeConfig(max_batch=B, max_wait=1.0, cache_bytes=0,
                              auto_flush=False))


def _srv_build(cfg, codes) -> tuple[ShardedServingRuntime, float]:
    """Every user's 2048 codes ingested in SRV_ROUNDS rounds, so each
    tenant is that many runs of its shard's arena and batches take the
    Masked policy (#1 over the arena, the one-launch exact stage)."""
    rt = ShardedServingRuntime(cfg)
    per = DOCS_PER_USER // SRV_ROUNDS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(SRV_ROUNDS):
        for t in range(USERS):
            lo = t * DOCS_PER_USER + r * per
            rt.ingest_codes(t, codes[lo:lo + per])
    torch.cuda.synchronize()
    return rt, time.perf_counter() - t0


def _srv_drive(rt, trace, fail_at=-1):
    """The reference launcher's drive: submit in order on a simulated
    clock, poll every 32 submits, flush; `fail_at` kills the shard owning
    that request's tenant first. Per 32-request turn: host clock around
    its submits and poll, the card synchronized at its end."""
    handles, turns, report, fail_ms = [], [], None, None
    now = 0.0
    torch.cuda.synchronize()
    t_start = t_turn = time.perf_counter()
    for i, (t, q) in enumerate(trace):
        if i == fail_at:
            t0 = time.perf_counter()
            report = rt.fail_shard(rt.placement.shard_of(t), now=now)
            torch.cuda.synchronize()
            fail_ms = (time.perf_counter() - t0) * 1e3
        now += 1e-3
        handles.append(rt.submit(t, q, now=now))
        if i % B == B - 1:
            rt.poll(now=now)
            torch.cuda.synchronize()
            turns.append(time.perf_counter() - t_turn)
            t_turn = time.perf_counter()
    rt.flush(now=now + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    return handles, turns, wall, report, fail_ms


def _srv_check(label, rt, handles, base, codes, trace, gold_ord,
               fail_at) -> float:
    """Every result against its baseline (indices too unless a failover
    ran) and the exact oracle, the ledger, no foreign row; returns
    recall@k against the planted gold."""
    hits = 0
    for i, (h, (t, q)) in enumerate(zip(handles, trace)):
        r = h.result()
        idx, sc = np.asarray(r.indices), np.asarray(r.scores)
        bi, bs = base[i]
        if not np.array_equal(sc, bs) or (fail_at < 0
                                          and not np.array_equal(idx, bi)):
            raise AssertionError(f"sharded serving {label}: request {i} "
                                 f"({idx}, {sc}) != 1-shard ({bi}, {bs})")
        if ((idx < 0) | (idx >= DOCS_PER_USER)).any():
            raise AssertionError(f"sharded serving {label}: request {i} "
                                 f"holds ordinals {idx}")
        rows = codes[t * DOCS_PER_USER + idx].astype(np.int64)
        if not np.array_equal(rows @ q.astype(np.int64), sc):
            raise AssertionError(f"sharded serving {label}: request {i} "
                                 "scores are not its tenant's exact dots")
        hits += int(gold_ord[i] in idx)
    led = rt.ledger()
    fails = int(fail_at >= 0)
    if not (led["submitted"] == led["resolved"] == len(trace)
            and led["dropped"] == led["duplicated"] == 0
            and led["failovers"] == fails):
        raise AssertionError(f"sharded serving {label}: ledger {led}")
    return hits / len(trace)


def phase_sharded_serving(qdb, dev, card) -> dict[str, int]:
    """(b): the arena corpus's users as tenants of a ShardedServingRuntime
    (see SRV_* above). Returns the path's launches."""
    codes = qdb.values.cpu().numpy()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    tenants = torch.arange(USERS, device=dev).repeat(SRV_PER_TENANT)
    pick = torch.randint(0, DOCS_PER_USER, (tenants.numel(),),
                         generator=gen, device=dev)
    noise = _unit(torch.randn(tenants.numel(), D, generator=gen, device=dev))
    q = _unit(_unit(qdb.values[tenants * DOCS_PER_USER + pick].float())
              + NOISE * noise)
    q_codes, _ = quantization.quantize_int8(q, per_vector=True)
    trace = list(zip(tenants.tolist(), q_codes.cpu().numpy()))
    gold_ord = pick.cpu().numpy()
    total: dict[str, int] = {}
    bases = {}
    for metric in ("mips", "cosine"):
        rt, ingest_s = _srv_build(_srv_cfg(metric, 1, 1, 1 << 20), codes)
        handles, turns, wall, _, _ = _srv_drive(rt, trace)
        bases[metric] = [(np.asarray(h.result().indices),
                          np.asarray(h.result().scores)) for h in handles]
        log(f"sharded serving baseline {metric} ({card}): 1 shard of 2^20 "
            f"rows, {N} docs ingested in {ingest_s:.2f} s; "
            f"{len(trace)} requests p50_turn_ms "
            f"{statistics.median(turns) * 1e3:.3f} max_turn_ms "
            f"{max(turns) * 1e3:.3f} queries_per_s {len(trace) / wall:.1f} "
            f"launches {rt.ledger()['launches']}")
        del rt, handles
    for label, metric, spread, fail_at in SRV_RUNS:
        rt, ingest_s = _srv_build(_srv_cfg(metric, spread, SRV_SHARDS,
                                           SRV_CAPACITY), codes)
        ops.reset_launch_counts()
        handles, turns, wall, report, fail_ms = _srv_drive(rt, trace, fail_at)
        counts = ops.launch_counts()
        _add_counts(total, counts)
        for key in SRV_KERNELS:
            if counts[key] <= 0:
                raise AssertionError(f"sharded serving {label}: {key} was "
                                     "not launched")
        for key in SRV_OFF_PATH:
            if counts[key]:
                raise AssertionError(f"sharded serving {label}: {key} was "
                                     "launched")
        recall = _srv_check(label, rt, handles, bases[metric], codes, trace,
                            gold_ord, fail_at)
        led = rt.ledger()
        msg = (f"sharded serving {label} ({card}): {SRV_SHARDS} shards x "
               f"2^19 rows on one card, spread {spread}, {N} docs ingested "
               f"in {ingest_s:.2f} s; {len(trace)} requests p50_turn_ms "
               f"{statistics.median(turns) * 1e3:.3f} max_turn_ms "
               f"{max(turns) * 1e3:.3f} queries_per_s "
               f"{len(trace) / wall:.1f} recall@{K} {recall:.4f}; lanes per "
               f"shard {led['shard_lanes_served']}; stage-1 bytes "
               f"{led['stage1_bytes_hbm']:,}; launches {led['launches']} "
               f"({ {k: n for k, n in counts.items() if n} }); equal to the "
               f"1-shard run")
        if report is not None:
            moved = report["moved_tenants"]
            if report["docs_restored"] != DOCS_PER_USER * len(moved) or \
                    led["docs_restored"] != report["docs_restored"]:
                raise AssertionError(f"sharded serving {label}: {report}")
            msg += (f" (scores; indices to the exact oracle); fail_shard "
                    f"{report['shard']} at request {fail_at}: "
                    f"{fail_ms:.1f} ms, {len(moved)} tenants moved, "
                    f"{report['docs_restored']} docs restored, "
                    f"{report['requests_resubmitted']} requests resubmitted, "
                    f"live shards {report['live_shards']}")
        log(msg)
        if label == "cosine":
            plain, _ = _srv_build(_srv_cfg(metric, spread, SRV_SHARDS,
                                           SRV_CAPACITY, backend="torch"),
                                  codes)
            want, _, _, _, _ = _srv_drive(plain, trace)
            for i, (h, w) in enumerate(zip(handles, want)):
                for field in ("indices", "scores", "candidate_indices"):
                    if not np.array_equal(getattr(h.result(), field),
                                          getattr(w.result(), field)):
                        raise AssertionError(f"sharded serving cosine: "
                                             f"request {i} {field} differs "
                                             "from the plain backend")
            log("sharded serving cosine: the kernel backend equals the "
                "plain backend bit for bit (indices, scores, candidates)")
            del plain, want
        del rt, handles
        torch.cuda.empty_cache()
    return total


def _rag_sharded(card, pipe, q, ecfg, eparams, gen_api, gparams
                 ) -> dict[str, int]:
    """(c): the single user's pipeline rebuilt over a (4, 2) mesh of slots
    on this card: the same retrieved ids and greedy tokens as the
    unsharded pipeline; one retrieve launches #1 and #3-by-id 8 times.
    Returns that retrieve's launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spipe = RAGPipeline.build(ecfg, eparams, gen_api, gparams,
                              pipe.doc_tokens, pipe.retrieval_cfg,
                              mesh=make_test_mesh(4, 2))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    res, ledger = spipe.retrieve(q)
    counts = ops.launch_counts()
    want, want_ledger = pipe.retrieve(q)
    for key in SHARD_KERNELS:
        if counts[key] != 8:
            raise AssertionError(f"rag sharded: {key} launched {counts[key]} "
                                 "times, not once per slot")
    if counts["stage2_rerank"] != 1:
        raise AssertionError(f"rag sharded: the final rerank launched "
                             f"{counts['stage2_rerank']} times, not once")
    if not (torch.equal(res.indices, want.indices)
            and torch.equal(res.scores, want.scores)
            and ledger.total_uj == want_ledger.total_uj):
        raise AssertionError("rag sharded: retrieve differs from the "
                             "unsharded pipeline")
    out, ids, _ = spipe.answer(q, max_new=RAG_MAX_NEW)
    wout, wids, _ = pipe.answer(q, max_new=RAG_MAX_NEW)
    if not (torch.equal(ids, wids) and torch.equal(out, wout)):
        raise AssertionError("rag sharded: answer differs from the "
                             "unsharded pipeline")
    log(f"rag sharded ({card}): RAGPipeline.build(mesh=make_test_mesh(4, "
        f"2)) over {RAG_DOCS} docs in {build_s * 1e3:.1f} ms, 8 slots of "
        f"{spipe.index.db[0].num_docs} rows on one card; retrieve and "
        f"greedy answer ({RAG_MAX_NEW} tokens) equal to the unsharded "
        f"pipeline; one retrieve of B = {RAG_B}: "
        f"{ {k: n for k, n in counts.items() if n} }")
    return counts


def _sharded_launchers(card) -> None:
    """(c): the two launchers with a mesh and with shards, on this card,
    run side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = (
        (["repro_torch.launch.serve", "--requests", "4", "--num-docs", "64",
          "--max-new", "4", "--data", "2", "--model", "2"],
         ("top-1 hit 4/4", "mesh={'data': 2, 'model': 2}")),
        (["repro_torch.launch.serve_tenants", "--tenants", "8",
          "--capacity", "1024", "--steps", "40", "--shards", "4",
          "--fail-at", "20"],
         ("cross-tenant leaks 0", "parity vs single shard: True",
          "exactly-once: True")))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, _ in runs]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (argv, must), (out, err) in zip(procs, runs, outs):
        if p.returncode != 0 or not all(m in out for m in must):
            raise AssertionError(f"{argv[0]}: rc {p.returncode}\n{out}\n"
                                 f"{err[-4000:]}")
        keep = [line for line in out.splitlines()
                if line.startswith(("[offline]", "[online]", "[trace]",
                                    "[query ]", "[shard ]"))]
        log(f"sharded launcher ({card}): python -m {' '.join(argv)}: rc 0 "
            f"(both in {time.perf_counter() - t0:.1f} s); "
            + " | ".join(keep))


# -- the rag phase -------------------------------------------------------
# The models and the RAG pipeline at both models' full widths:
# qwen2-0.5b (src/repro_torch/configs/qwen2_0_5b.py: 24 layers x 896, 14
# query heads over 2 KV heads, d_ff 4864, vocab 151936, QKV bias, tied
# embeddings; bf16 compute over f32 weights) and the paper's MiniLM
# embedder (6 layers x 384, 12 heads, d_ff 1536, vocab 30522, pooled 512;
# f32), random weights from a seeded generator on the card. One wearable
# user's unit is 2048 docs (1 MB of INT8 codes at D = 512); docs are 64
# tokens, retrieval keeps k = 5, so a prompt is 5 x 64 + 64 = 384 tokens
# and 32 new tokens make a 416-position cache (26 pages of 16 rows).
RAG_DOCS, RAG_DOC_LEN, RAG_B, RAG_TENANTS, RAG_K = 2048, 64, 8, 32, 5
RAG_MAX_NEW, RAG_STEPS = 32, 20
RAG_AGENT = dict(top_k=32, npages=8, prescreen_c0=64, page_rows=16)
# Teacher forcing at f32 compute: 376 prompt tokens, 8 decode steps,
# against `forward` on 384, within the reference's own 1e-4.
RAG_TF_PROMPT, RAG_TF_STEPS, RAG_TF_ATOL = 376, 8, 1e-4
RAG_QUANT_ATOL = 0.1        # decode_step_quant at top_k >= T vs decode_step
RAG_KERNELS = ("stage1_plane_mma", "stage1_rows", "stage2_rerank_by_id",
               "stage0_sign_gather")


class _PrefillClock:
    """A ModelApi's prefill with the card synchronized and the host clock
    read before and after it: splits a turn into retrieval, prefill and
    decode."""

    def __init__(self, api):
        self.api, self.marks = api, []

    def __call__(self, params, batch, max_len=None):
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        out = self.api.prefill(params, batch, max_len=max_len)
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        return out


def _timed_turn(agent, clock, tids, q):
    """One agent turn; returns (report, (retrieve, prefill, decode) ms)."""
    torch.cuda.synchronize()
    clock.marks.clear()
    t0 = time.perf_counter()
    rep = agent.turn(tids, q, max_new=RAG_MAX_NEW)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    t1, t2 = clock.marks
    return rep, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3)


def _copy_cache(cache):
    """A decode cache whose tensors are copies (decode writes in place)."""
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone()
        for f in dataclasses.fields(cache)
        if isinstance(getattr(cache, f.name), torch.Tensor)})


def _rag_single_user(card, ecfg, eparams, gen_api, gparams, rng, dev):
    """RAGPipeline over one user's 2048 docs: B = 8 queries that copy
    docs, retrieve and answer. Returns (pipeline, queries)."""
    docs = rng.integers(0, ecfg.vocab_size,
                        (RAG_DOCS, RAG_DOC_LEN)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = RAGPipeline.build(ecfg, eparams, gen_api, gparams, docs,
                             RetrievalConfig(k=RAG_K), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gold = rng.choice(RAG_DOCS, RAG_B, replace=False)
    q = docs[gold]
    res, ledger = pipe.retrieve(q)
    hits = int((res.indices[:, 0].cpu().numpy() == gold).sum())
    if hits != RAG_B:
        raise AssertionError(f"rag single user: top-1 hit {hits}/{RAG_B}")
    plan = engine.plan(pipe.retrieval_cfg, num_docs=RAG_DOCS,
                       dim=ecfg.pooled_dim, batch=RAG_B, kind="plain")
    want = energy.cost_cascade(plan.stages, ecfg.pooled_dim, batch=RAG_B)
    full = energy.cost_hierarchical(RAG_DOCS, ecfg.pooled_dim)
    if not (ledger.total_uj == want.total_uj < full.total_uj):
        raise AssertionError(f"rag single user: ledger {ledger.total_uj} uJ, "
                             f"plan {want.total_uj}, full scan "
                             f"{full.total_uj}")
    out, ids, _ = pipe.answer(q, max_new=RAG_MAX_NEW)
    if (tuple(out.shape) != (RAG_B, RAG_MAX_NEW) or int(out.min()) < 0
            or int(out.max()) >= gen_api.cfg.vocab_size
            or not torch.equal(ids, res.indices)):
        raise AssertionError("rag single user: answer gave "
                             f"{tuple(out.shape)} tokens or other ids")
    log(f"rag single user ({card}): RAGPipeline over {RAG_DOCS} docs x "
        f"{RAG_DOC_LEN} tokens, built (MiniLM embed + INT8) in "
        f"{build_s * 1e3:.1f} ms ({RAG_DOCS / build_s:.0f} docs/s); B = "
        f"{RAG_B}: top-1 hit {hits}/{RAG_B}; ledger {ledger.total_uj:.4f} "
        f"uJ/query = cost_cascade of the plain plan, below the full scan's "
        f"{full.total_uj:.4f}; answer (B, {RAG_MAX_NEW}) tokens")
    return pipe, q


def _rag_tenants(card, ecfg, eparams, gen_api, gparams, rng, dev):
    """32 tenants x 2048 docs ingested online into one arena, a
    ServingRuntime (max_batch 32) and a RAGAgent over it. Returns the
    agent, its prefill clock, the registry, the tenants' queries and
    their gold slots and slot sets."""
    mpipe = MultiTenantRAGPipeline.create(
        ecfg, eparams, gen_api, gparams, capacity=RAG_TENANTS * RAG_DOCS,
        doc_len=RAG_DOC_LEN, retrieval_cfg=RetrievalConfig(k=RAG_K),
        device=dev)
    docs = rng.integers(0, ecfg.vocab_size, (RAG_TENANTS, RAG_DOCS,
                                             RAG_DOC_LEN)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [mpipe.ingest(t, docs[t]) for t in range(RAG_TENANTS)]
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    log(f"rag ingest ({card}): {RAG_TENANTS} tenants x {RAG_DOCS} docs x "
        f"{RAG_DOC_LEN} tokens online through the MiniLM embedder: "
        f"{ingest_s:.3f} s, {RAG_TENANTS * RAG_DOCS / ingest_s:.0f} docs/s")
    reg = obs.MetricsRegistry()
    rt = ServingRuntime(mpipe.index, RuntimeConfig(max_batch=RAG_TENANTS),
                        registry=reg)
    clock = _PrefillClock(gen_api)
    mpipe.gen_api = dataclasses.replace(gen_api, prefill=clock)
    agent = RAGAgent(pipeline=mpipe, runtime=rt, **RAG_AGENT)
    pick = rng.integers(0, RAG_DOCS, RAG_TENANTS)
    q = docs[np.arange(RAG_TENANTS), pick]
    gold = np.array([slots[t][pick[t]] for t in range(RAG_TENANTS)])
    return agent, clock, reg, q, gold, slots


def _check_turns(reps, gold, slots, rt, reg, counts, layers) -> None:
    rep = reps[0]
    hits = int((rep.retrieved[:, 0] == gold).sum())
    leaks = sum(int(i) not in set(slots[t].tolist())
                for t in range(RAG_TENANTS) for i in rep.retrieved[t]
                if i >= 0)
    steps = 2 * (RAG_MAX_NEW - 1) * layers
    problems = []
    if hits != RAG_TENANTS or leaks:
        problems.append(f"top-1 hit {hits}/{RAG_TENANTS}, {leaks} ids of "
                        "another tenant")
    if not (torch.equal(reps[0].tokens, reps[1].tokens)
            and np.array_equal(reps[0].retrieved, reps[1].retrieved)):
        problems.append("the two turns differ")
    hist = reg.snapshot()["histograms"]
    if (rt.decode_steps != 2 * RAG_MAX_NEW
            or hist["energy_uj_per_token"]["count"] != 2 * RAG_MAX_NEW):
        problems.append(f"decode_steps {rt.decode_steps}, "
                        f"{hist['energy_uj_per_token']['count']} token "
                        "observations")
    if not (rep.uj_per_query > 0 and rep.uj_per_token > 0
            and rep.decode_bytes_per_token < rep.dense_bytes_per_token):
        problems.append(f"ledger {rep.uj_per_query} uJ/query "
                        f"{rep.uj_per_token} uJ/token, "
                        f"{rep.decode_bytes_per_token} bytes per step "
                        f"against dense {rep.dense_bytes_per_token}")
    # Each quantized step launches #2 (page prune) and #8 (prescreen) once
    # per layer; each retrieval launch #2 (windowed scan) and #3 once.
    if (counts["stage0_sign_gather"] != steps
            or counts["stage1_rows"] != steps + rt.launches
            or counts["stage2_rerank_by_id"] < rt.launches
            or counts["stage1_plane_mma"] < 1):
        problems.append(f"launches {counts}, expected #8 {steps}, #2 "
                        f"{steps} + {rt.launches} retrieval launches")
    if problems:
        raise AssertionError("rag tenants: " + "; ".join(problems))


def _rag_kernel_equals_plain(pipe, q1, agent, q, gparams, gcfg) -> None:
    """The kernel backend against the plain one on the card, bit for bit:
    the single user's ids, the tenants' ids, and the logits (and cache) of
    one paged + prescreen decode_step_quant from the same QuantCache."""
    mpipe = agent.pipeline
    cfg = pipe.retrieval_cfg
    want = pipe.retrieve(q1)[0].indices
    pipe.retrieval_cfg = dataclasses.replace(cfg, backend="torch")
    plain = pipe.retrieve(q1)[0].indices
    pipe.retrieval_cfg = cfg
    codes, _ = quantization.quantize_int8(mpipe._embed(q), per_vector=True)
    tids = np.arange(RAG_TENANTS, dtype=np.int32)
    got = mpipe.index.retrieve(codes, tids).indices
    icfg = mpipe.index.cfg
    mpipe.index.cfg = dataclasses.replace(icfg, backend="torch")
    plain_t = mpipe.index.retrieve(codes, tids).indices
    mpipe.index.cfg = icfg
    if not (torch.equal(want, plain) and torch.equal(got, plain_t)):
        raise AssertionError("rag: retrieval on the kernel backend differs "
                             "from the plain backend")
    prompt = mpipe._prompt(got.cpu().numpy(), q)
    _, cache = mpipe.gen_api.prefill(
        gparams, {"tokens": prompt},
        max_len=agent._total_len(prompt.shape[1], RAG_MAX_NEW))
    base = dense.quantize_cache(cache, page_rows=RAG_AGENT["page_rows"])
    del cache
    knobs = {k: v for k, v in RAG_AGENT.items() if k != "page_rows"}
    tok = prompt[:, -1:]
    outs = [dense.decode_step_quant(gparams, _copy_cache(base), tok, gcfg,
                                    backend=be, **knobs)
            for be in ("cuda", "torch")]
    (lg_c, c_c), (lg_t, c_t) = outs
    same = torch.equal(lg_c, lg_t) and all(
        torch.equal(getattr(c_c, f), getattr(c_t, f))
        for f in ("k_msb", "k_lsb", "k_scale", "v", "cent_msb",
                  "cent_scale", "length"))
    if not same:
        raise AssertionError("rag: decode_step_quant on the kernel backend "
                             "differs from the plain backend")
    log(f"rag: kernel backend = plain backend bit for bit: retrieved ids "
        f"(single user, {RAG_TENANTS} tenants), one paged + prescreen "
        f"decode_step_quant's logits and cache")


def _rag_step_times(card, agent, q, gparams, gcfg) -> None:
    """p50 of a 24-layer step at B = 32 over the turn's 416-position
    cache: decode_step_quant (paged + prescreen) and the bf16
    decode_step; the prefill's p50; each profiled once; the tied head's
    cast."""
    mpipe = agent.pipeline
    ids = mpipe.index.retrieve(
        quantization.quantize_int8(mpipe._embed(q), per_vector=True)[0],
        np.arange(RAG_TENANTS, dtype=np.int32)).indices.cpu().numpy()
    prompt = mpipe._prompt(ids, q)
    total = agent._total_len(prompt.shape[1], RAG_MAX_NEW)
    _, base = mpipe.gen_api.prefill(gparams, {"tokens": prompt},
                                    max_len=total)
    tok = prompt[:, -1:]
    knobs = {k: v for k, v in RAG_AGENT.items() if k != "page_rows"}

    def stepper(cache, fn):
        box = [cache]

        def step():
            box[0] = fn(gparams, box[0], tok, gcfg)[1]
        return step
    quant = stepper(dense.quantize_cache(base, RAG_AGENT["page_rows"]),
                    lambda *a: dense.decode_step_quant(*a, **knobs))
    dense_step = stepper(_copy_cache(base), dense.decode_step)
    q_s = _median_step_s(quant, RAG_STEPS)
    d_s = _median_step_s(dense_step, RAG_STEPS)
    p_s = _median_step_s(lambda: mpipe.gen_api.prefill(
        gparams, {"tokens": prompt}, max_len=total), 5)
    for label, fn, wall_s in (
            ("quant step", stepper(
                dense.quantize_cache(base, RAG_AGENT["page_rows"]),
                lambda *a: dense.decode_step_quant(*a, **knobs)), q_s),
            ("bf16 step", stepper(_copy_cache(base), dense.decode_step),
             d_s),
            ("prefill", lambda: mpipe.gen_api.prefill(
                gparams, {"tokens": prompt}, max_len=total), p_s)):
        kernels = device_profile(fn, reps=1)
        busy = sum(t for _, t, _ in kernels) * 1e-3
        top = "; ".join(f"{name[:60]} {t * 1e-3:.3f} ms x{n:.0f}"
                        for name, t, n in kernels[:4])
        log(f"rag profile {label} ({card}): one call after a warm-up call: "
            f"p50_ms {wall_s * 1e3:.3f} device_busy_ms {busy:.3f} "
            f"idle_share {1 - busy / (wall_s * 1e3):.3f} kernel_launches "
            f"{sum(n for _, _, n in kernels):.0f}; busiest: {top}")
    cast_ms = time_ms(lambda: gparams["embed"].to(torch.bfloat16))
    log(f"rag decode ({card}): B = {RAG_TENANTS}, T = {total}, "
        f"{gcfg.num_layers} layers: decode_step_quant (paged npages "
        f"{RAG_AGENT['npages']} + prescreen C0 {RAG_AGENT['prescreen_c0']}, "
        f"top_k {RAG_AGENT['top_k']}) p50_step_ms {q_s * 1e3:.3f} "
        f"tokens_per_s {RAG_TENANTS / q_s:.1f}; bf16 decode_step p50_step_ms "
        f"{d_s * 1e3:.3f} tokens_per_s {RAG_TENANTS / d_s:.1f}")
    log(f"rag tied head ({card}): the {tuple(gparams['embed'].shape)} f32 "
        f"table cast to bf16 "
        f"per step {cast_ms:.4f} ms (CUDA events, median of 20): "
        f"{cast_ms / (d_s * 1e3):.3f} of the bf16 decode_step, "
        f"{cast_ms / (q_s * 1e3):.3f} of the quant step")


def _rag_models_at_f32(card, gparams, gcfg, rng, dev) -> None:
    """The reference's own model checks at full width, f32 compute:
    prefill + decode equals teacher forcing, and decode_step_quant at
    top_k >= T stays within RAG_QUANT_ATOL of decode_step."""
    cfg = gcfg.with_(compute_dtype="float32")
    n = RAG_TF_PROMPT + RAG_TF_STEPS
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n)).astype(
        np.int32)).to(dev)
    full = dense.forward(gparams, toks, cfg)[:, RAG_TF_PROMPT:]
    _, cache = dense.prefill(gparams, toks[:, :RAG_TF_PROMPT], cfg,
                             max_len=n)
    qcache = dense.quantize_cache(cache)
    outs = []
    for i in range(RAG_TF_PROMPT, n):
        lg, cache = dense.decode_step(gparams, cache, toks[:, i:i + 1], cfg)
        outs.append(lg)
    tf_err = float((torch.cat(outs, 1) - full).abs().max())
    scale = float(full.abs().max())
    _, cache = dense.prefill(gparams, toks[:, :RAG_TF_PROMPT], cfg,
                             max_len=n)
    q_err = 0.0
    for i in range(RAG_TF_PROMPT, RAG_TF_PROMPT + 2):
        lg_d, cache = dense.decode_step(gparams, cache, toks[:, i:i + 1], cfg)
        lg_q, qcache = dense.decode_step_quant(gparams, qcache,
                                               toks[:, i:i + 1], cfg,
                                               top_k=n)
        q_err = max(q_err, float((lg_d - lg_q).abs().max()))
    log(f"rag models at f32 ({card}): prefill {RAG_TF_PROMPT} + "
        f"{RAG_TF_STEPS} decode_steps against forward on {n}: max abs err "
        f"{tf_err:.3g} (limit {RAG_TF_ATOL}; logits up to {scale:.3g}); "
        f"decode_step_quant (top_k {n} >= T) against decode_step, two "
        f"steps: max abs err {q_err:.3g} (limit {RAG_QUANT_ATOL})")
    if not (tf_err <= RAG_TF_ATOL and q_err < RAG_QUANT_ATOL):
        raise AssertionError(f"rag models at f32: teacher forcing {tf_err}, "
                             f"quant against dense {q_err}")


def _rag_launcher(card) -> None:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests",
         "4", "--num-docs", "64", "--max-new", "4"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or "top-1 hit 4/4" not in out.stdout:
        raise AssertionError(f"rag launcher: rc {out.returncode}\n"
                             f"{out.stdout}\n{out.stderr[-4000:]}")
    log(f"rag launcher ({card}): python -m repro_torch.launch.serve "
        f"--requests 4 --num-docs 64 --max-new 4: rc 0 in "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(lines))


def phase_rag(dev, card: str) -> tuple[dict[str, int], dict[str, int]]:
    """The models and the RAG pipeline at full width (see RAG_* above).
    Returns the path's launches (the single user's RAGPipeline and the
    tenants' two agent turns, driven with the counts set to 0 before) and
    the sharded pipeline's (`_rag_sharded`)."""
    t0 = time.perf_counter()
    gcfg = get_config("qwen2-0.5b")
    ecfg = get_config("minilm-embedder")
    gen_api = get_model(gcfg)
    rng = np.random.default_rng(SEED + 11)
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        gparams = gen_api.init(gen, device=dev)
        eparams = embedder.init_params(ecfg, gen, device=dev)
        log(f"rag models: {gcfg.name} {param_count(gparams)} parameters "
            f"(f32 weights, {gcfg.compute_dtype} compute), {ecfg.name} "
            f"{param_count(eparams)} ({ecfg.compute_dtype}); drawn on the "
            f"card in {time.perf_counter() - t0:.1f} s")
        ops.reset_launch_counts()
        pipe, q1 = _rag_single_user(card, ecfg, eparams, gen_api, gparams,
                                    rng, dev)
        agent, clock, reg, q, gold, slots = _rag_tenants(
            card, ecfg, eparams, gen_api, gparams, rng, dev)
        tids = np.arange(RAG_TENANTS, dtype=np.int32)
        turns = [_timed_turn(agent, clock, tids, q) for _ in range(2)]
        launches = ops.launch_counts()
        reps = [rep for rep, _ in turns]
        _check_turns(reps, gold, slots, agent.runtime, reg, launches,
                     gcfg.num_layers)
        for i, (rep, (r_ms, p_ms, d_ms)) in enumerate(turns):
            log(f"rag turn {i + 1} ({card}): B = {RAG_TENANTS} tenants, "
                f"prompt {(RAG_K + 1) * RAG_DOC_LEN} "
                f"tokens, {RAG_MAX_NEW} new: embed + retrieve {r_ms:.1f} "
                f"ms, prefill {p_ms:.1f} ms, decode {d_ms:.1f} ms "
                f"({d_ms / (RAG_MAX_NEW - 1):.2f} ms per quant step, "
                f"quantize_cache included); top-1 hit "
                f"{int((rep.retrieved[:, 0] == gold).sum())}/{RAG_TENANTS}, "
                f"0 ids of another tenant; {rep.uj_per_query:.4f} uJ/query, "
                f"{rep.uj_per_token:.4f} uJ/token; kv_plan "
                f"{rep.decode_bytes_per_token} bytes per step against dense "
                f"{rep.dense_bytes_per_token} "
                f"({rep.dense_bytes_per_token / rep.decode_bytes_per_token:.2f}x)")
        log(f"rag path launches: { {k: n for k, n in launches.items() if n} }"
            f"; #2 and #8 {gcfg.num_layers} per quant step "
            f"({2 * (RAG_MAX_NEW - 1)} steps), #2 and #3 once per "
            f"retrieval launch ({agent.runtime.launches}); decode_steps "
            f"{agent.runtime.decode_steps}, energy_uj_per_token count "
            f"{reg.snapshot()['histograms']['energy_uj_per_token']['count']}")
        _rag_kernel_equals_plain(pipe, q1, agent, q, gparams, gcfg)
        sharded = _rag_sharded(card, pipe, q1, ecfg, eparams, gen_api,
                               gparams)
        del pipe
        _rag_step_times(card, agent, q, gparams, gcfg)
        del agent
        torch.cuda.empty_cache()
        _rag_models_at_f32(card, gparams, gcfg, rng, dev)
        del gparams, eparams
    torch.cuda.empty_cache()
    _rag_launcher(card)
    _sharded_launchers(card)
    log(f"rag ({card}): peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; the phase "
        f"took {time.perf_counter() - t0:.1f} s")
    for key in RAG_KERNELS:
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"kernel {key} was not launched by the rag "
                                 "path")
    return launches, sharded


# -- the train phase -----------------------------------------------------
# Training and its state (ROADMAP A3's training half) at qwen2-0.5b's full
# width (24 layers x 896, vocab 151936; f32 weights, bf16 compute, remat on)
# with the reference launcher's batch: B = 8 sequences of 64 tokens of the
# synthetic LM stream, AdamW at lr 3e-4; checkpoints of the whole state
# (params, mu, nu: ~5.9 GB) to a directory under build/ that the phase
# removes. Then the trained weights are served through RAGPipeline.
TRAIN_B, TRAIN_S, TRAIN_LR = 8, 64, 3e-4
TRAIN_STEPS, TRAIN_SAVE_EVERY, TRAIN_KEEP, TRAIN_FAIL_AT = 10, 5, 2, 7
TRAIN_TIMED_STEPS = 20
# (a) the card against the port's CPU, at f32 compute over 2 layers: the
# loss within a relative 1e-5; each grad leaf within 1e-4 of its largest
# |grad| (f32 sums in other orders, over K up to 151936); AdamW and
# Adafactor fed the same grads within 1e-6 absolute on the parameters
# (their state within a relative 1e-5); grad_accum 2 against 1 on the card
# within the same bounds; the INT8 error feedback bit for bit.
TRAIN_CHECK_LAYERS = 2
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_OPT_ATOL = 1e-5, 1e-4, 1e-6
# (b) the first loss within 0.5 of ln V (random logits); the last at least
# 0.5 below the first (the batch repeats, so its own tokens are learned).
TRAIN_LN_V_TOL, TRAIN_MIN_DROP = 0.5, 0.5
TRAIN_KERNELS = ("stage1_plane_mma", "stage2_rerank_by_id")


def _leaf_rel_err(got, want) -> float:
    """Largest |got - want| over each leaf's largest |want|, on the CPU."""
    worst = 0.0
    for (name, a), (_, b) in zip(_tree.named_leaves(got),
                                 _tree.named_leaves(want), strict=True):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        worst = max(worst, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
    return worst


def _leaf_abs_err(got, want) -> float:
    return max(float((a.detach().cpu().double() - b.detach().cpu().double())
                     .abs().max())
               for a, b in zip(_tree.leaves(got), _tree.leaves(want),
                               strict=True))


def _bitwise(got, want) -> bool:
    return all(torch.equal(a.detach().cpu(), b.detach().cpu())
               for a, b in zip(_tree.leaves(got), _tree.leaves(want),
                               strict=True))


def _train_card_vs_cpu(card, dev) -> None:
    """(a) qwen2-0.5b at full width and 2 layers, f32 compute, one batch:
    the card against the port's plain path on the CPU."""
    t0 = time.perf_counter()
    cfg = get_config("qwen2-0.5b").with_(num_layers=TRAIN_CHECK_LAYERS,
                                         compute_dtype="float32")
    api = get_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED + 12),
                      device=dev)
    cparams = _tree.tree_map(lambda t: t.cpu(), params)
    host = next(lm_batches(LMTaskConfig(cfg.vocab_size, TRAIN_S, TRAIN_B)))
    batch, cbatch = shard_batch(host, dev), shard_batch(host, "cpu")
    loss, grads = value_and_grad(api.loss_fn, params, batch)
    closs, cgrads = value_and_grad(api.loss_fn, cparams, cbatch)
    loss_err = abs(float(loss) - float(closs)) / abs(float(closs))
    grad_err = _leaf_rel_err(grads, cgrads)
    ghost = _tree.tree_map(lambda t: t.cpu(), grads)
    opt_errs = {}
    for name, opt in (("adamw", adamw(lr=TRAIN_LR, weight_decay=0.1)),
                      ("adafactor", adafactor(lr=TRAIN_LR))):
        p1, s1 = opt.update(grads, opt.init(params), params)
        cp1, cs1 = opt.update(ghost, opt.init(cparams), cparams)
        opt_errs[name] = (_leaf_abs_err(p1, cp1), _leaf_rel_err(s1, cs1))
        del p1, s1, cp1, cs1
    seen, accum_loss = {}, {}
    for ga in (1, 2):
        opt = adamw(lr=TRAIN_LR)
        step = make_train_step(api.loss_fn, opt, grad_accum=ga,
                               clip_norm=None,
                               grad_transform=lambda g, ga=ga: seen.setdefault(
                                   ga, g))
        metrics = step(params, opt.init(params), batch)[2]
        accum_loss[ga] = float(metrics["loss"])
    accum_err = (abs(accum_loss[2] - accum_loss[1]) / abs(accum_loss[1]),
                 _leaf_rel_err(seen[2], seen[1]))
    del seen
    # two error-feedback rounds from the card's grads, card against CPU
    err, cerr = (compression.init_error_state(g) for g in (grads, ghost))
    same_ef = True
    for _ in range(2):
        out, err = compression.apply_error_feedback(grads, err)
        cout, cerr = compression.apply_error_feedback(ghost, cerr)
        same_ef &= _bitwise(out, cout) and _bitwise(err, cerr)
    codes = all(
        _bitwise(compression.quantize_int8_tensor(g.float()),
                 compression.quantize_int8_tensor(c.float()))
        for g, c in zip(_tree.leaves(grads), _tree.leaves(ghost)))
    log(f"train card vs cpu ({card}): {cfg.name} at full width, "
        f"{cfg.num_layers} layers, f32 compute, B = {TRAIN_B} x "
        f"{TRAIN_S}: loss {float(loss):.6f} (CPU {float(closs):.6f}, rel "
        f"err {loss_err:.3g}, limit {TRAIN_LOSS_RTOL}); grads max err "
        f"{grad_err:.3g} of each leaf's max (limit {TRAIN_GRAD_RTOL}); one "
        f"step from the same grads: AdamW params {opt_errs['adamw'][0]:.3g} "
        f"state {opt_errs['adamw'][1]:.3g}, Adafactor params "
        f"{opt_errs['adafactor'][0]:.3g} state {opt_errs['adafactor'][1]:.3g}"
        f" (limits {TRAIN_OPT_ATOL} abs, {TRAIN_LOSS_RTOL} rel); grad_accum "
        f"2 vs 1 on the card: loss {accum_err[0]:.3g}, grads "
        f"{accum_err[1]:.3g}; INT8 error feedback card = CPU bit for bit: "
        f"codes and scales {codes}, outputs and residuals {same_ef}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL
            and all(p <= TRAIN_OPT_ATOL and s <= TRAIN_LOSS_RTOL
                    for p, s in opt_errs.values())
            and accum_err[0] <= TRAIN_LOSS_RTOL
            and accum_err[1] <= TRAIN_GRAD_RTOL and codes and same_ef):
        raise AssertionError("train card vs cpu: a check failed (above)")


class _Recording(CheckpointManager):
    """A CheckpointManager that keeps a host copy of the state it is asked
    to save at `hold` (taken apart from its own snapshot), checks each
    restore of that step against it bit for bit, and times its calls."""

    def __init__(self, directory, keep, hold):
        super().__init__(directory, keep=keep)
        self.hold, self.held, self.checked = hold, None, []
        self.snapshot_ms, self.restore_ms = [], []

    def save_async(self, step, tree):
        if step == self.hold:
            self.held = _tree.tree_map(
                lambda t: t.detach().to("cpu", copy=True), tree)
        self.wait()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super().save_async(step, tree)
        self.snapshot_ms.append((step, (time.perf_counter() - t0) * 1e3))

    def restore_latest(self, like, device=None):
        self.wait()
        t0 = time.perf_counter()
        tree, step = super().restore_latest(like, device)
        torch.cuda.synchronize()
        self.restore_ms.append((step, (time.perf_counter() - t0) * 1e3))
        if step == self.hold:
            self.checked.append(_bitwise(tree, self.held))
        return tree, step


def _rounded(pairs) -> list:
    return [(step, round(ms, 1)) for step, ms in pairs]


def _state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree))


def _train_elastic(card, dev, root) -> tuple:
    """(b) the full-width model through ElasticTrainer on 2 slots of the
    card, a worker lost at step 7. Returns (api, optimizer, train step,
    batch, manager)."""
    cfg = get_config("qwen2-0.5b")
    api = get_model(cfg)
    opt = adamw(lr=TRAIN_LR)
    raw = make_train_step(api.loss_fn, opt)
    batch = shard_batch(next(lm_batches(LMTaskConfig(
        cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED))), dev)

    def make_state(mesh):
        slot = mesh.slots()[0]
        params = api.init(torch.Generator(device=slot).manual_seed(SEED + 13),
                          device=slot)
        return (params, opt.init(params),
                lambda p, o, b, mesh: raw(p, o, b), None)

    ckpt = _Recording(os.path.join(root, "elastic"), TRAIN_KEEP,
                      TRAIN_SAVE_EVERY)
    trainer = ElasticTrainer(make_state=make_state, ckpt=ckpt,
                             save_every=TRAIN_SAVE_EVERY)
    t0 = time.perf_counter()
    out = trainer.run(itertools.repeat(batch), num_steps=TRAIN_STEPS,
                      injector=FailureInjector({TRAIN_FAIL_AT: 1}),
                      devices=[dev, dev])
    run_s = time.perf_counter() - t0
    losses = out["losses"]
    ln_v = math.log(cfg.vocab_size)
    log(f"train elastic ({card}): {cfg.name} full width ({cfg.num_layers} "
        f"layers, {param_count(ckpt.held[0])} parameters, f32 weights, "
        f"{cfg.compute_dtype} compute, remat {cfg.remat}), AdamW lr "
        f"{TRAIN_LR}, B = {TRAIN_B} x {TRAIN_S} repeated, 2 slots of the "
        f"card, worker lost at step {TRAIN_FAIL_AT}: {TRAIN_STEPS} steps in "
        f"{run_s:.1f} s, restarts {out['restarts']}, final_devices "
        f"{out['final_devices']}, monitored {out['monitored']}; losses "
        f"{[round(x, 4) for x in losses]} (ln V = {ln_v:.4f}); async save "
        f"snapshots (step, ms) {_rounded(ckpt.snapshot_ms)}, restores "
        f"(step, ms) {_rounded(ckpt.restore_ms)}; step "
        f"{TRAIN_SAVE_EVERY}'s restore = its save bit for bit: "
        f"{ckpt.checked}")
    problems = []
    if (out["restarts"], out["final_devices"], len(losses)) != (
            1, 1, TRAIN_STEPS) or not all(map(math.isfinite, losses)):
        problems.append("restarts, devices or losses")
    if abs(losses[0] - ln_v) > TRAIN_LN_V_TOL:
        problems.append(f"first loss {losses[0]} not within "
                        f"{TRAIN_LN_V_TOL} of ln V")
    if losses[-1] > losses[0] - TRAIN_MIN_DROP:
        problems.append(f"last loss {losses[-1]} not {TRAIN_MIN_DROP} below "
                        "the first")
    if ckpt.checked != [True]:
        problems.append(f"restore of step {TRAIN_SAVE_EVERY}: {ckpt.checked}")
    if problems:
        raise AssertionError("train elastic: " + "; ".join(problems))
    return api, opt, raw, batch, ckpt


def _train_then_serve(card, dev, api, state, rng) -> dict[str, int]:
    """(d) the trained parameters served through RAGPipeline with the
    full-width MiniLM over one user's 2048 docs of 64 tokens. Returns the
    path's launches."""
    ecfg = get_config("minilm-embedder")
    with torch.inference_mode():
        eparams = embedder.init_params(
            ecfg, torch.Generator(device=dev).manual_seed(SEED + 14),
            device=dev)
        ops.reset_launch_counts()
        _rag_single_user(card, ecfg, eparams, api, state[0], rng, dev)
        launches = ops.launch_counts()
    log(f"train serve ({card}): the restored step-{TRAIN_STEPS} weights "
        f"behind RAGPipeline (top-1 {RAG_B}/{RAG_B} above); launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    for key in TRAIN_KERNELS:
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"kernel {key} was not launched by the "
                                 "train-then-serve path")
    return launches


def _train_step_times(card, dev, api, opt, raw, batch, state, root) -> None:
    """(c) the p50 step, one profiled step, the optimizer's share, peak
    device memory, and a synchronous save and restore of the state."""
    box = list(state)

    def one():
        box[0], box[1], _ = raw(box[0], box[1], batch)
    torch.cuda.reset_peak_memory_stats()
    p50 = _median_step_s(one, TRAIN_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    kernels = device_profile(one, reps=1)
    busy = sum(t for _, t, _ in kernels) * 1e-3
    top = "; ".join(f"{name[:50]} {t * 1e-3:.3f} ms x{n:.0f}"
                    for name, t, n in kernels[:5])
    _, grads = value_and_grad(api.loss_fn, box[0], batch)
    opt_kernels = device_profile(lambda: opt.update(grads, box[1], box[0]),
                                 reps=1)
    opt_busy = sum(t for _, t, _ in opt_kernels) * 1e-3
    del grads
    tokens = TRAIN_B * TRAIN_S
    log(f"train step ({card}): p50 of {TRAIN_TIMED_STEPS} steps "
        f"{p50 * 1e3:.3f} ms (host clock + synchronize), "
        f"{tokens / p50:.1f} tokens/s; one profiled step after a warm-up: "
        f"device_busy_ms {busy:.3f} idle_share {1 - busy / (p50 * 1e3):.3f} "
        f"kernel_launches {sum(n for _, _, n in kernels):.0f}; the AdamW "
        f"update alone busy {opt_busy:.3f} ms "
        f"({sum(n for _, _, n in opt_kernels):.0f} launches), "
        f"{opt_busy / busy:.3f} of the step; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; busiest: {top}")
    nbytes = _state_bytes(box)
    path = os.path.join(root, "sync")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, 1, tuple(box))
    save_s = time.perf_counter() - t0
    like = _tree.tree_map(lambda t: torch.empty_like(t, device="meta"),
                          tuple(box))
    t0 = time.perf_counter()
    got, _ = restore_checkpoint(path, like, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = _bitwise(got, tuple(box))
    log(f"train checkpoint ({card}): the state ({nbytes} bytes) saved in "
        f"{save_s * 1e3:.1f} ms ({nbytes / save_s / 1e9:.2f} GB/s, device to "
        f"host copy and .npy files), restored to the card in "
        f"{restore_s * 1e3:.1f} ms ({nbytes / restore_s / 1e9:.2f} GB/s); "
        f"bit for bit: {same}")
    if not same:
        raise AssertionError("train checkpoint: the restore differs")


def _train_launchers(card, root) -> None:
    """(e) the launcher at full width and at the smoke widths with
    --grad-accum 2 --compress-grads, on this card, side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = (["--arch", "qwen2-0.5b", "--steps", "4", "--save-every", "4",
             "--ckpt-dir", os.path.join(root, "launch_full")],
            ["--smoke", "--grad-accum", "2", "--compress-grads", "--steps",
             "4", "--ckpt-dir", os.path.join(root, "launch_smoke")])
    line = re.compile(r"^qwen2-0\.5b: 4 steps in [0-9.]+s; loss [0-9.]+ -> "
                      r"[0-9.]+; restarts 0$", re.M)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m",
                               "repro_torch.launch.train", *argv], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in runs]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, argv, (out, err) in zip(procs, runs, outs):
        if p.returncode != 0 or not line.search(out):
            raise AssertionError(f"train launcher {argv}: rc {p.returncode}"
                                 f"\n{out}\n{err[-4000:]}")
        log(f"train launcher ({card}): python -m repro_torch.launch.train "
            f"{' '.join(argv[:-2])}: rc 0 (both in "
            f"{time.perf_counter() - t0:.1f} s); {out.strip()}")


def phase_train(dev, card: str) -> dict[str, int]:
    """Training and its state at full width (see TRAIN_* above): (a) the
    card against the CPU, (b) the elastic trainer with a lost worker, (d)
    the trained weights served, (c) step time, memory and checkpoint I/O,
    (e) the launcher. Returns the launches of (d)'s serving path, driven
    with the counts set to 0 before it."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT, "build"))
    free = shutil.disk_usage(root).free
    log(f"train ({card}): checkpoints under {root}, {free / 2 ** 30:.1f} GiB "
        "free")
    try:
        _train_card_vs_cpu(card, dev)
        torch.cuda.empty_cache()
        api, opt, raw, batch, ckpt = _train_elastic(card, dev, root)
        like = ckpt.held
        del ckpt
        t1 = time.perf_counter()
        state, step = restore_checkpoint(os.path.join(root, "elastic"), like,
                                         device=dev)
        torch.cuda.synchronize()
        log(f"train restore ({card}): step {step} ({_state_bytes(state)} "
            f"bytes) to the card in {(time.perf_counter() - t1) * 1e3:.1f} "
            "ms")
        del like
        shutil.rmtree(os.path.join(root, "elastic"))
        launches = _train_then_serve(card, dev, api, state,
                                     np.random.default_rng(SEED + 14))
        torch.cuda.empty_cache()
        _train_step_times(card, dev, api, opt, raw, batch, state, root)
        del state, batch
        shutil.rmtree(os.path.join(root, "sync"))
        torch.cuda.empty_cache()
        _train_launchers(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"train ({card}): the phase took {time.perf_counter() - t0:.1f} s")
    return launches


# -- the models phase ------------------------------------------------------
# The families the port gained in ROADMAP A3a-A3b, each at its published
# width (random weights from a seeded generator on the card), depth cut to
# fit one 80 GB card:
#   (a) llama4-scout at full width (d 5120, 40 heads over 8 KV heads, d_ff
#       8192, 16 experts + a shared one, vocab 202048), 1 layer, f32
#       compute: a prefill of B = 2 x 32 tokens and 4 decode steps on the
#       card and on the port's plain path on the CPU from the same weights.
#       Routing (each token's expert, kept or dropped, its buffer slot)
#       must be equal, except tokens whose top-2 router probabilities lie
#       within MD_TIE_ULPS ulp on either side, and every later token of
#       their chunk routed to either of their experts (exempted and
#       counted); the logits of the other positions within MD_LOGITS_ATOL;
#       the MoE FFN bit-identical across two runs on the card, at f32 and
#       at bf16 compute.
#   (b) each of MD_SERVE behind RAGPipeline (the rag phase's corpus: the
#       full-width MiniLM over 2048 docs of 64 tokens, k = 5, so 384-token
#       prompts), B = 8 queries that copy docs, `answer` with 16 new
#       tokens: top-1 8/8, finite prefill and decode logits, #1 and #3 by
#       id counted; the dense and vlm configs also at f32 compute: a
#       64-token prompt (after 1024 patch embeddings for the vlm) + 4
#       decode steps against `forward`, within MD_TF_ATOL. One config at a
#       time, each freed before the next.
#   (c) llama4-scout at full width, 1 layer, B = 8 x 64 of the LM stream
#       (one batch, repeated) through ElasticTrainer for 6 steps with
#       Adafactor (lr 3e-4; a cut: AdamW's f32 state for 4.27 B
#       parameters does not fit the card beside its grads), one
#       checkpoint at step 6 restored bit for bit; the losses must fall.
#   (d) the launchers: `launch.serve --arch llama4-scout-17b-a16e
#       --smoke`, `launch.train --arch internvl2-26b --smoke --steps 4`
#       and `launch.train --arch llama4-maverick-400b-a17b --smoke --data
#       2 --model 2 --steps 4`, started with the phase and collected
#       before (b): rc 0 and their closing lines.
MD_CHECK_B, MD_CHECK_S, MD_CHECK_STEPS = 2, 32, 4
MD_TIE_ULPS = 2
MD_LOGITS_ATOL = 1e-3
MD_B, MD_MAX_NEW, MD_STEPS = 8, 16, 20
MD_TF_PROMPT, MD_TF_STEPS, MD_TF_ATOL = 64, 4, 1e-3
# (arch, layers kept: None = all)
MD_SERVE = (("llama4-scout-17b-a16e", 4),
            ("llama4-maverick-400b-a17b", 2),
            ("minitron-4b", None),
            ("internvl2-26b", 8),
            ("deepseek-coder-33b", 4),
            ("deepseek-67b", 4))
MD_TRAIN_B, MD_TRAIN_S, MD_TRAIN_STEPS = 8, 64, 6
MD_KERNELS = ("stage1_plane_mma", "stage2_rerank_by_id")


class _RouteLog:
    """Records every `moe.route` call: (probs, eidx, keep, slot) on the
    CPU, and the chunk size."""

    def __init__(self):
        self.calls = []
        self._route = moe.route

    def __call__(self, p, xt, cfg, chunk):
        out = self._route(p, xt, cfg, chunk)
        probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
        eidx, _, keep, slot, _ = out
        self.calls.append((probs.cpu(), eidx.cpu(), keep.cpu(), slot.cpu(),
                           chunk))
        return out


def _exempt(probs_a, probs_b, e_a, e_b, chunk) -> np.ndarray:
    """Tokens whose top-2 router probabilities lie within MD_TIE_ULPS ulp
    on either side, and every later token of their chunk routed (on
    either side) to one of their experts."""
    out = np.zeros(len(e_a), bool)
    e_a, e_b = e_a.numpy(), e_b.numpy()
    for probs in (probs_a.numpy(), probs_b.numpy()):
        top = np.sort(probs, axis=-1)[:, -2:]
        tie = top[:, 1] - top[:, 0] <= MD_TIE_ULPS * np.spacing(top[:, 1])
        for t in np.flatnonzero(tie):
            experts = list({int(e_a[t]), int(e_b[t]),
                            *np.argsort(probs[t])[-2:].tolist()})
            later = np.arange(t, (t // chunk + 1) * chunk)
            out[later[np.isin(e_a[later], experts)
                      | np.isin(e_b[later], experts)]] = True
    return out


def _scout_run(params, cfg, toks, dev):
    """Prefill MD_CHECK_S tokens, then MD_CHECK_STEPS decode steps of the
    given tokens: (logits (B, S + steps, V) on the CPU, route calls)."""
    log_ = _RouteLog()
    t = toks.to(dev)
    with mock.patch.object(moe, "route", log_):
        lg, cache = moe.prefill(params, t[:, :MD_CHECK_S], cfg,
                                max_len=MD_CHECK_S + MD_CHECK_STEPS)
        outs = [lg.cpu()]
        for i in range(MD_CHECK_S, MD_CHECK_S + MD_CHECK_STEPS):
            lg, cache = moe.decode_step(params, cache, t[:, i:i + 1], cfg)
            outs.append(lg.cpu())
    return torch.cat(outs, 1), log_.calls


def _models_card_vs_cpu(card, dev) -> None:
    """(a) llama4-scout at full width, 1 layer, f32 compute: card against
    the CPU."""
    t0 = time.perf_counter()
    cfg = get_config("llama4-scout-17b-a16e").with_(
        num_layers=1, compute_dtype="float32")
    api = get_model(cfg)
    b, s = MD_CHECK_B, MD_CHECK_S
    with torch.inference_mode():
        params = api.init(torch.Generator(device=dev).manual_seed(SEED + 16),
                          device=dev)
        cparams = _tree.tree_map(lambda t: t.cpu(), params)
        toks = torch.from_numpy(np.random.default_rng(SEED + 16).integers(
            0, cfg.vocab_size, (b, s + MD_CHECK_STEPS)).astype(np.int32))
        t1 = time.perf_counter()
        got, calls = _scout_run(params, cfg, toks, dev)
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        want, ccalls = _scout_run(cparams, cfg, toks, "cpu")
        cpu_s = time.perf_counter() - t1
        del cparams
        # positions of each call's tokens in the (B, S + steps) logits
        where = [np.stack(np.unravel_index(np.arange(b * s), (b, s)), 1)]
        where += [np.stack([np.arange(b), np.full(b, s + i)], 1)
                  for i in range(MD_CHECK_STEPS)]
        skip = np.zeros((b, s + MD_CHECK_STEPS), bool)
        routing_equal, exempted, dropped = True, 0, 0
        for (pa, ea, ka, sa, chunk), (pb, eb, kb, sb, _), pos in zip(
                calls, ccalls, where, strict=True):
            ex = _exempt(pa, pb, ea, eb, chunk)
            exempted += int(ex.sum())
            dropped += int((~ka).sum())
            ok = torch.from_numpy(~ex)
            routing_equal &= (torch.equal(ea[ok], eb[ok])
                              and torch.equal(ka[ok], kb[ok])
                              and torch.equal(sa[ok], sb[ok]))
            skip[pos[ex, 0], pos[ex, 1]] = True
        keep = torch.from_numpy(~skip)
        err = float((got - want)[keep].abs().max())
        scale = float(want.abs().max())
        # the dispatch twice on the card, at f32 and at bf16 compute
        mp = {k: v[0] for k, v in params["moe"].items()}
        h = torch.randn((MD_B, 416, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 17))
        same = []
        for c, x in ((cfg, h), (cfg.with_(compute_dtype="bfloat16"),
                               h.to(torch.bfloat16))):
            ys = [moe.moe_ffn(mp, x, c) for _ in range(2)]
            same.append(torch.equal(ys[0], ys[1]))
        again, _ = _scout_run(params, cfg, toks, dev)
        same_logits = torch.equal(again, got)
        del params, mp, h, ys
    log(f"models card vs cpu ({card}): {cfg.name} at full width, 1 layer, "
        f"f32 compute: prefill B = {b} x {s} + {MD_CHECK_STEPS} decode "
        f"steps on the card ({card_s:.2f} s) and on the CPU ({cpu_s:.2f} "
        f"s); routing equal: {routing_equal} ({len(calls)} route calls, "
        f"{exempted} tokens exempted as near-ties within {MD_TIE_ULPS} ulp,"
        f" {dropped} dropped by capacity on the card); logits max abs err "
        f"{err:.3g} over the positions not exempted (limit "
        f"{MD_LOGITS_ATOL}; logits up to {scale:.3g}); MoE FFN at B = "
        f"{MD_B} x 416 bit-identical across two runs: f32 {same[0]}, bf16 "
        f"{same[1]}; the whole run's logits again bit for bit: "
        f"{same_logits}; {time.perf_counter() - t0:.1f} s")
    if not (routing_equal and err <= MD_LOGITS_ATOL and all(same)):
        raise AssertionError("models card vs cpu: a check failed (above)")


# the families whose decode is held against `forward` (the MoE's routing
# is held in (a) instead)
TF_MODULES = {"dense": dense, "vlm": dense, "ssm": mamba2, "hybrid": zamba2}


def _models_tf(cfg, params, dev) -> float:
    """Prefill + MD_TF_STEPS decode steps against `forward` at f32 compute
    (a vlm after its patch embeddings): the largest abs difference."""
    mod = TF_MODULES[cfg.family]
    c32 = cfg.with_(compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    n = MD_TF_PROMPT + MD_TF_STEPS
    toks = torch.randint(0, cfg.vocab_size, (2, n), generator=gen,
                         device=dev, dtype=torch.int32)
    prefix, p = None, 0
    if cfg.family == "vlm":
        p = cfg.num_prefix_embeds
        prefix = torch.randn((2, p, cfg.d_model), generator=gen, device=dev)
    full = mod.forward(params, toks, c32, prefix)[:, p + MD_TF_PROMPT:]
    _, cache = mod.prefill(params, toks[:, :MD_TF_PROMPT], c32,
                           max_len=p + n, prefix_embeds=prefix)
    outs = []
    for i in range(MD_TF_PROMPT, n):
        lg, cache = mod.decode_step(params, cache, toks[:, i:i + 1], c32)
        outs.append(lg)
    return float((torch.cat(outs, 1) - full).abs().max())


def _models_serve(card, dev, configs=MD_SERVE,
                  label="models") -> dict[str, int]:
    """(b) every config of `configs` ((arch, layers kept or None)) behind
    RAGPipeline. Returns the launches of the pipelines' `answer` calls
    (counts set to 0 before each)."""
    ecfg = get_config("minilm-embedder")
    rng = np.random.default_rng(SEED + 17)
    docs = rng.integers(0, ecfg.vocab_size,
                        (RAG_DOCS, RAG_DOC_LEN)).astype(np.int32)
    gold = rng.choice(RAG_DOCS, MD_B, replace=False)
    q = torch.from_numpy(docs[gold]).to(dev)
    launches: dict[str, int] = {}
    base = None
    with torch.inference_mode():
        eparams = embedder.init_params(
            ecfg, torch.Generator(device=dev).manual_seed(SEED + 17),
            device=dev)
        for arch, layers in configs:
            full = get_config(arch)
            cfg = full if layers is None else full.with_(num_layers=layers)
            api = get_model(cfg)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = api.init(torch.Generator(device=dev).manual_seed(
                SEED + 18), device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            if base is None:
                base = dataclasses.replace(RAGPipeline.build(
                    ecfg, eparams, api, params, docs,
                    RetrievalConfig(k=RAG_K), device=dev),
                    gen_api=None, gen_params=None)
            pipe = dataclasses.replace(base, gen_api=api, gen_params=params)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out, ids, _ = pipe.answer(q, max_new=MD_MAX_NEW)
            torch.cuda.synchronize()
            answer_s = time.perf_counter() - t0
            counts = ops.launch_counts()
            _add_counts(launches, counts)
            hits = int((ids[:, 0].cpu().numpy() == gold).sum())
            prompt = torch.cat([pipe.doc_tokens[ids.reshape(-1)].reshape(
                MD_B, -1), q], 1).clamp(0, cfg.vocab_size - 1)
            total = prompt.shape[1] + MD_STEPS + 8
            batch = {"tokens": prompt}
            lg, cache = api.prefill(params, batch, max_len=total)
            finite = bool(torch.isfinite(lg).all())
            del lg
            p_s = _median_step_s(lambda: api.prefill(params, batch,
                                                     max_len=total), 3)
            p_kernels = device_profile(
                lambda: api.prefill(params, batch, max_len=total), reps=1)
            p_busy = sum(t for _, t, _ in p_kernels) * 1e-3
            p_top = [(k[:40], round(t * 1e-3, 3)) for k, t, _ in p_kernels[:3]]
            tok = prompt[:, -1:]
            box = [cache]

            def step():
                lg, box[0] = api.decode_step(params, box[0], tok)
                return lg
            d_s = _median_step_s(step, MD_STEPS)
            kernels = device_profile(step, reps=1)
            finite &= bool(torch.isfinite(step()).all())
            busy = sum(t for _, t, _ in kernels) * 1e-3
            del box, cache
            peak = torch.cuda.max_memory_allocated()
            tf = (_models_tf(cfg, params, dev)
                  if cfg.family in TF_MODULES else None)
            cut = ("full depth" if layers is None
                   else f"{layers} of {full.num_layers} layers")
            log(f"{label} serve {arch} ({card}): full width ({cut}, "
                f"{param_count(params)} parameters, {cfg.param_dtype} "
                f"weights, {cfg.compute_dtype} compute), drawn in "
                f"{init_s:.1f} s; RAGPipeline.answer B = {MD_B}, prompt "
                f"{prompt.shape[1]} tokens, {MD_MAX_NEW} new: "
                f"{answer_s * 1e3:.1f} ms, top-1 hit {hits}/{MD_B}; prefill "
                f"p50 {p_s * 1e3:.3f} ms (one profiled: device_busy_ms "
                f"{p_busy:.3f} kernel_launches "
                f"{sum(n for _, _, n in p_kernels):.0f}; busiest ms "
                f"{p_top}); decode step p50 {d_s * 1e3:.3f} ms"
                f" ({MD_B / d_s:.1f} tokens/s); one profiled step: "
                f"device_busy_ms {busy:.3f} idle_share "
                f"{1 - busy / (d_s * 1e3):.3f} kernel_launches "
                f"{sum(n for _, _, n in kernels):.0f}; peak device memory {peak / 2 ** 30:.2f} GiB; finite "
                f"logits {finite}; launches "
                f"{ {k: n for k, n in counts.items() if n} }"
                + ("" if tf is None else
                   f"; decode continues prefill at f32: max abs err "
                   f"{tf:.3g} (limit {MD_TF_ATOL})"))
            if (hits != MD_B or not finite
                    or tuple(out.shape) != (MD_B, MD_MAX_NEW)
                    or (tf is not None and not tf <= MD_TF_ATOL)
                    or any(counts.get(k, 0) <= 0 for k in MD_KERNELS)):
                raise AssertionError(f"{label} serve {arch}: a check failed "
                                     "(above)")
            del pipe, params, out, ids, prompt, batch
        del base, eparams
    torch.cuda.empty_cache()
    return launches


class _TimedSave(CheckpointManager):
    """A CheckpointManager that times each save from its call to the end
    of its write."""

    def __init__(self, directory, keep):
        super().__init__(directory, keep=keep)
        self.t0, self.save_s = None, []

    def save_async(self, step, tree, shardings=None):
        self.wait()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        super().save_async(step, tree, shardings)

    def wait(self):
        busy = self._thread is not None
        super().wait()
        if busy and self.t0 is not None:
            self.save_s.append(time.perf_counter() - self.t0)
            self.t0 = None


def _models_train(card, dev, root, cfg=None, opt_name="adafactor",
                  label="models") -> None:
    """(c) `cfg` (llama4-scout at full width, 1 layer, by default) trained
    MD_TRAIN_STEPS steps through ElasticTrainer with `opt_name`, its last
    state saved and restored bit for bit. An enc-dec batch carries seeded
    frames (B, S, d_model)."""
    t0 = time.perf_counter()
    if cfg is None:
        cfg = get_config("llama4-scout-17b-a16e").with_(num_layers=1)
    full_layers = get_config(cfg.name).num_layers
    api = get_model(cfg)
    opt = {"adamw": adamw, "adafactor": adafactor}[opt_name](lr=TRAIN_LR)
    raw = make_train_step(api.loss_fn, opt)
    batch = shard_batch(next(lm_batches(LMTaskConfig(
        cfg.vocab_size, MD_TRAIN_S, MD_TRAIN_B, seed=SEED))), dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (MD_TRAIN_B, MD_TRAIN_S, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 24))
    times, box = [], [None, None]

    def step_fn(p, o, b, mesh):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        box[0], box[1], m = raw(p, o, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        return box[0], box[1], m

    def make_state(mesh):
        slot = mesh.slots()[0]
        params = api.init(torch.Generator(device=slot).manual_seed(SEED + 19),
                          device=slot)
        return params, opt.init(params), step_fn, None

    where = os.path.join(root, label)
    ckpt = _TimedSave(where, 1)
    torch.cuda.reset_peak_memory_stats()
    out = ElasticTrainer(make_state=make_state, ckpt=ckpt,
                         save_every=MD_TRAIN_STEPS).run(
        itertools.repeat(batch), num_steps=MD_TRAIN_STEPS, devices=[dev])
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    state = tuple(box)
    nbytes = _state_bytes(state)
    like = _tree.tree_map(lambda t: torch.empty_like(t, device="meta"), state)
    t1 = time.perf_counter()
    got, step = restore_checkpoint(where, like, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    same = step == MD_TRAIN_STEPS and _bitwise(got, state)
    n_params = param_count(state[0])
    del got, like, state
    shutil.rmtree(where)

    def one():
        box[0], box[1], _ = raw(box[0], box[1], batch)
    kernels = device_profile(one, reps=1)
    busy = sum(t for _, t, _ in kernels) * 1e-3
    _, grads = value_and_grad(api.loss_fn, box[0], batch)
    opt_kernels = device_profile(lambda: opt.update(grads, box[1], box[0]),
                                 reps=1)
    opt_busy = sum(t for _, t, _ in opt_kernels) * 1e-3
    del grads, box[:]
    p50 = statistics.median(times)
    log(f"{label} train ({card}): {cfg.name} at full width, "
        f"{cfg.num_layers} of {full_layers} layers "
        f"({n_params} parameters, {cfg.param_dtype} weights, "
        f"{cfg.compute_dtype} compute, remat {cfg.remat}), {opt_name} lr "
        f"{TRAIN_LR}, B = {MD_TRAIN_B} x {MD_TRAIN_S} repeated, "
        f"ElasticTrainer {MD_TRAIN_STEPS} steps: losses "
        f"{[round(x, 4) for x in losses]}, restarts {out['restarts']}; step "
        f"p50 {p50 * 1e3:.3f} ms (host clock + synchronize, the "
        f"{len(times)} steps) {MD_TRAIN_B * MD_TRAIN_S / p50:.1f} tokens/s; "
        f"one profiled step after a warm-up: device_busy_ms {busy:.3f} "
        f"idle_share {1 - busy / (p50 * 1e3):.3f} kernel_launches "
        f"{sum(n for _, _, n in kernels):.0f}; the {opt_name} update alone "
        f"busy {opt_busy:.3f} ms ({opt_busy / busy:.3f} of the step); peak "
        f"device memory {peak / 2 ** 30:.2f} GiB; the step-"
        f"{MD_TRAIN_STEPS} save ({nbytes} bytes) {ckpt.save_s[0]:.2f} s "
        f"({nbytes / ckpt.save_s[0] / 1e9:.2f} GB/s, call to written), "
        f"restored to the card in {restore_s:.2f} s "
        f"({nbytes / restore_s / 1e9:.2f} GB/s), bit for bit: {same}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (len(losses) == MD_TRAIN_STEPS and all(map(math.isfinite, losses))
            and losses[-1] < losses[0] and same and out["restarts"] == 0):
        raise AssertionError(f"{label} train: a check failed (above)")


MD_LAUNCHERS = (
    (["repro_torch.launch.serve", "--arch", "llama4-scout-17b-a16e",
      "--smoke"], r"top-1 hit 8/8"),
    (["repro_torch.launch.train", "--arch", "internvl2-26b", "--smoke",
      "--steps", "4"], r"^internvl2-26b: 4 steps in [0-9.]+s; loss "
                       r"[0-9.]+ -> [0-9.]+; restarts 0$"),
    (["repro_torch.launch.train", "--arch", "llama4-maverick-400b-a17b",
      "--smoke", "--data", "2", "--model", "2", "--steps", "4"],
     r"^llama4-maverick-400b-a17b: 4 steps in [0-9.]+s; loss [0-9.]+ -> "
     r"[0-9.]+; restarts 0$"))


def _models_launchers_start(root, launchers=MD_LAUNCHERS):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for i, (argv, _) in enumerate(launchers):
        extra = ([] if argv[0].endswith("serve")
                 else ["--ckpt-dir", os.path.join(root, f"launch_{i}")])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", *argv, *extra], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return time.perf_counter(), procs


def _models_launchers_check(card, started, launchers=MD_LAUNCHERS,
                            label="models") -> None:
    """(d) collect the launchers started with the phase."""
    t0, procs = started
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (argv, want), (out, err) in zip(procs, launchers, outs):
        if p.returncode != 0 or not re.search(want, out, re.M):
            raise AssertionError(f"{label} launcher {argv}: rc "
                                 f"{p.returncode}\n{out}\n{err[-4000:]}")
        log(f"{label} launcher ({card}): python -m {' '.join(argv)}: rc 0 "
            f"(all {len(procs)} in {time.perf_counter() - t0:.1f} s); "
            + " | ".join(out.strip().splitlines()))


def phase_models(dev, card: str) -> dict[str, int]:
    """The dense, vlm and MoE configs at full width (see MD_* above): (a)
    scout on the card against the CPU, (b) six configs served, (c) scout
    trained, (d) the launchers. Returns the launches of (b)'s serving
    path."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="models_", dir=os.path.join(ROOT, "build"))
    try:
        started = _models_launchers_start(root)
        _models_card_vs_cpu(card, dev)
        torch.cuda.empty_cache()
        _models_launchers_check(card, started)
        launches = _models_serve(card, dev)
        _models_train(card, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"models path launches ({card}): "
        f"{ {k: n for k, n in launches.items() if n} }")
    log(f"models ({card}): the phase took {time.perf_counter() - t0:.1f} s")
    return launches


# -- the ssm phase ---------------------------------------------------------
# The SSM and hybrid families (ROADMAP A3c-A3d) at their published widths,
# random weights from a seeded generator on the card:
#   (a) mamba2-2.7b at full width (d 2560, 80 heads x 64, N 128, conv 4,
#       vocab 50280), 2 layers, and zamba2-2.7b at full width, one
#       superblock (6 mamba2 layers and the shared block: 32 heads x 80,
#       d_ff 10240), f32 compute, B = 2: prefills of SSM_CHECK_LENS tokens
#       (512 is two chunks of 256, so the inter-chunk recurrence runs; 384
#       takes the one-chunk fallback), each followed by SSM_CHECK_STEPS
#       decode steps, on the card and on the port's plain path on the CPU
#       from the same weights: the logits within SSM_LOGITS_ATOL, the SSM
#       state, conv tail (and the hybrid's K/V) within SSM_STATE_RTOL of
#       their largest |value|. Then `ssd_chunked` on the card at the full
#       head shape (B 2, L 512, H 80, P 64, N 128, chunk 256; dt-scaled
#       inputs from the configs' A_log) against the token-by-token
#       recurrence in f64: y and the final state within SSM_SCAN_RTOL of
#       their largest |value|.
#   (b) both at full width and FULL DEPTH (mamba2 64 layers, 10.8 GB of f32
#       weights; zamba2 54 layers, 9 applications of the shared block, 9.7
#       GB) behind RAGPipeline.answer one at a time (the models phase's
#       serving code: B = 8 requests, 384-token prompts, 16 new tokens;
#       top-1 8/8, #1 and the exact stage counted, prefill and decode p50, one
#       profiled step, peak memory), and decode against `forward` at f32
#       (MD_TF_PROMPT tokens then MD_TF_STEPS steps, within MD_TF_ATOL).
#   (c) mamba2-2.7b at full width, 16 of 64 layers, and zamba2-2.7b, 12 of
#       54 layers (2 applications), each trained MD_TRAIN_STEPS steps with
#       AdamW (the configs' own optimizer, lr 3e-4) through
#       ElasticTrainer at B = 8 x 64 of the LM stream, the step-6 state
#       saved and restored bit for bit; the losses must fall. Depth is cut
#       because AdamW's state at full depth (43.2 GB for mamba2) leaves no
#       room for a 6.93 GB leaf's optimizer temporaries.
#   (d) the launchers: `launch.serve --arch mamba2-2.7b --smoke`, `launch.
#       serve --arch zamba2-2.7b --smoke`, `launch.train --arch
#       mamba2-2.7b --smoke --steps 4` and `launch.train --arch
#       zamba2-2.7b --smoke --data 2 --model 2 --steps 4`, started with
#       the phase: rc 0 and their closing lines.
SSM_CHECK = (("mamba2-2.7b", 2, (512, 384)), ("zamba2-2.7b", 6, (512,)))
SSM_CHECK_B, SSM_CHECK_STEPS = 2, 4
SSM_LOGITS_ATOL, SSM_STATE_RTOL, SSM_SCAN_RTOL = 1e-3, 1e-4, 1e-4
SSM_SCAN_SHAPE = (2, 512, 80, 64, 128)        # B, L, H, P, N
SSM_SERVE = (("mamba2-2.7b", None), ("zamba2-2.7b", None))
SSM_TRAIN = (("mamba2-2.7b", 16), ("zamba2-2.7b", 12))
SSM_LAUNCHERS = (
    (["repro_torch.launch.serve", "--arch", "mamba2-2.7b", "--smoke"],
     r"top-1 hit 8/8"),
    (["repro_torch.launch.serve", "--arch", "zamba2-2.7b", "--smoke"],
     r"top-1 hit 8/8"),
    (["repro_torch.launch.train", "--arch", "mamba2-2.7b", "--smoke",
      "--steps", "4"], r"^mamba2-2.7b: 4 steps in [0-9.]+s; loss "
                       r"[0-9.]+ -> [0-9.]+; restarts 0$"),
    (["repro_torch.launch.train", "--arch", "zamba2-2.7b", "--smoke",
      "--data", "2", "--model", "2", "--steps", "4"],
     r"^zamba2-2.7b: 4 steps in [0-9.]+s; loss [0-9.]+ -> [0-9.]+; "
     r"restarts 0$"))


def _ssm_run(mod, params, cfg, toks, s, dev):
    """Prefill `s` tokens, then SSM_CHECK_STEPS decode steps of the given
    tokens: (logits (B, s + steps, V), the cache's tensors), on the CPU."""
    t = toks.to(dev)
    lg, cache = mod.prefill(params, t[:, :s], cfg,
                            max_len=s + SSM_CHECK_STEPS)
    outs = [lg.cpu()]
    for i in range(s, s + SSM_CHECK_STEPS):
        lg, cache = mod.decode_step(params, cache, t[:, i:i + 1], cfg)
        outs.append(lg.cpu())
    tensors = {k: v.cpu() for k, v in vars(cache).items() if k != "length"}
    return torch.cat(outs, 1), tensors


def _ssm_scan(dev) -> tuple[float, float, float]:
    """`ssd_chunked` at SSM_SCAN_SHAPE against the f64 recurrence: (y's and
    the final state's largest error over their largest |value|, the
    chunked scan's device ms)."""
    b, l, h, p, n = SSM_SCAN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device=dev))
    x = torch.randn((b, l, h, p), generator=gen, device=dev) * dt[..., None]
    a = -dt * torch.exp(a_log)
    bb = torch.randn((b, l, n), generator=gen, device=dev)
    cc = torch.randn((b, l, n), generator=gen, device=dev)
    y, final = mamba2.ssd_chunked(x, a, bb, cc, 256)
    ms = time_ms(lambda: mamba2.ssd_chunked(x, a, bb, cc, 256), iters=5)
    st = torch.zeros((b, h, p, n), dtype=torch.float64, device=dev)
    ys = []
    x64, a64, b64, c64 = (t.double() for t in (x, a, bb, cc))
    for t in range(l):
        st = (st * torch.exp(a64[:, t])[..., None, None]
              + x64[:, t, :, :, None] * b64[:, t, None, None, :])
        ys.append((st @ c64[:, t, None, :, None])[..., 0])
    want = torch.stack(ys, 1)
    y_err = float((y.double() - want).abs().max() / want.abs().max())
    f_err = float((final.double() - st).abs().max() / st.abs().max())
    return y_err, f_err, ms


def _ssm_card_vs_cpu(card, dev) -> None:
    """(a) each SSM_CHECK config on the card against the CPU, then the
    chunked scan against the recurrence at the full head shape."""
    t0 = time.perf_counter()
    ok = True
    for arch, layers, lens in SSM_CHECK:
        cfg = get_config(arch).with_(num_layers=layers,
                                     compute_dtype="float32")
        mod = TF_MODULES[cfg.family]
        with torch.inference_mode():
            params = get_model(cfg).init(
                torch.Generator(device=dev).manual_seed(SEED + 20),
                device=dev)
            cparams = _tree.tree_map(lambda t: t.cpu(), params)
            toks = torch.from_numpy(np.random.default_rng(SEED + 20).integers(
                0, cfg.vocab_size, (SSM_CHECK_B, max(lens) + SSM_CHECK_STEPS)
            ).astype(np.int32))
            for s in lens:
                t1 = time.perf_counter()
                got, gcache = _ssm_run(mod, params, cfg, toks, s, dev)
                card_s = time.perf_counter() - t1
                t1 = time.perf_counter()
                want, wcache = _ssm_run(mod, cparams, cfg, toks, s, "cpu")
                cpu_s = time.perf_counter() - t1
                err = float((got - want).abs().max())
                cerr = {k: float((gcache[k].float() - w.float()).abs().max()
                                 / w.float().abs().max())
                        for k, w in wcache.items()}
                chunk = min(cfg.ssm_chunk, s)
                chunks = s // chunk if s % chunk == 0 else 1
                ok &= err <= SSM_LOGITS_ATOL and all(
                    e <= SSM_STATE_RTOL for e in cerr.values())
                log(f"ssm card vs cpu ({card}): {arch} at full width, "
                    f"{layers} of {get_config(arch).num_layers} layers, f32 "
                    f"compute: prefill B = {SSM_CHECK_B} x {s} ({chunks} "
                    f"chunk(s) of {s // chunks}) + {SSM_CHECK_STEPS} decode "
                    f"steps on the card ({card_s:.2f} s) and on the CPU "
                    f"({cpu_s:.2f} s): logits max abs err {err:.3g} (limit "
                    f"{SSM_LOGITS_ATOL}; logits up to "
                    f"{float(want.abs().max()):.3g}); cache max err over "
                    f"its largest |value| "
                    f"{ {k: float(f'{e:.3g}') for k, e in cerr.items()} } "
                    f"(limit {SSM_STATE_RTOL})")
            del params, cparams
    y_err, f_err, ms = _ssm_scan(dev)
    ok &= y_err <= SSM_SCAN_RTOL and f_err <= SSM_SCAN_RTOL
    log(f"ssm scan ({card}): ssd_chunked at B, L, H, P, N = "
        f"{SSM_SCAN_SHAPE}, chunk 256 (2 chunks), on the card against the "
        f"token-by-token recurrence in f64: y max err over max |y| "
        f"{y_err:.3g}, final state {f_err:.3g} (limit {SSM_SCAN_RTOL}); the "
        f"chunked scan {ms:.3f} ms (CUDA events, median of 5); "
        f"{time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError("ssm card vs cpu: a check failed (above)")


def phase_ssm(dev, card: str) -> dict[str, int]:
    """The SSM and hybrid configs at full width (see SSM_* above): (a) the
    card against the CPU and the chunked scan against the recurrence, (b)
    both served at full depth, (c) both trained, (d) the launchers.
    Returns the launches of (b)'s serving path."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="ssm_", dir=os.path.join(ROOT, "build"))
    try:
        started = _models_launchers_start(root, SSM_LAUNCHERS)
        _ssm_card_vs_cpu(card, dev)
        torch.cuda.empty_cache()
        _models_launchers_check(card, started, SSM_LAUNCHERS, "ssm")
        launches = _models_serve(card, dev, SSM_SERVE, "ssm")
        for arch, layers in SSM_TRAIN:
            _models_train(card, dev, root,
                          get_config(arch).with_(num_layers=layers),
                          "adamw", "ssm")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"ssm path launches ({card}): "
        f"{ {k: n for k, n in launches.items() if n} }")
    log(f"ssm ({card}): the phase took {time.perf_counter() - t0:.1f} s")
    return launches


# -- the encdec phase ------------------------------------------------------
# The enc-dec family (ROADMAP A3e) at seamless-m4t-medium's published
# widths (12 encoder + 12 decoder layers, d 1024, 16 heads x 64 (kv 16),
# d_ff 4096, vocab 256206, untied head), random weights from a seeded
# generator on the card. The path is plain PyTorch (the reference's model
# is plain jnp: no Pallas kernel), so it launches none of the port's
# kernels; the serving path's launch counts are read and must all be 0.
#   (a) 2 encoder and 2 decoder layers at full width, f32 compute, B = 2:
#       frames of ED_CHECK_SRC positions (4096: the encoder's non-causal
#       chunked path at attn_chunk 2048, two query and two key chunks;
#       1024: its naive path), a 64-token prompt and ED_CHECK_STEPS decode
#       steps, on the card and on the port's CPU path from the same
#       weights: the logits within ED_LOGITS_ATOL, the self and cross K/V
#       within ED_CACHE_RTOL of their largest |value|, and the encoder's
#       path the one the chunk rule names.
#   (b) FULL DEPTH (977,758,208 parameters, 3.91 GB of f32 weights, bf16
#       compute) behind `serve.sampler.generate`: B = 8, seeded frames (8,
#       1024, 1024), a 64-token prompt, 32 new tokens; then at f32 compute
#       the prompt and the generated tokens through prefill + decode
#       against `forward`, within ED_TF_ATOL; prefill p50, decode step p50
#       and tokens/s, one profiled prefill and decode step, peak memory.
#   (c) FULL DEPTH trained MD_TRAIN_STEPS steps with AdamW (the config's
#       optimizer, lr 3e-4) through ElasticTrainer at B = 8 x 64 of the LM
#       stream with seeded frames (8, 64, 1024); the step-6 state (params,
#       m and v: 11.7 GB) saved and restored bit for bit; the losses fall.
#   (d) the launchers, started with the phase: `launch.train --arch
#       seamless-m4t-medium --smoke --steps 2` (rc 0 and its closing line)
#       and `launch.serve --arch seamless-m4t-medium` (refused: a non-zero
#       rc and the reference's message).
ED_ARCH = "seamless-m4t-medium"
ED_CHECK_LAYERS, ED_CHECK_B, ED_CHECK_STEPS = 2, 2, 8
ED_CHECK_SRC = (4096, 1024)
ED_LOGITS_ATOL, ED_CACHE_RTOL = 1e-3, 1e-4
ED_B, ED_SRC, ED_PROMPT, ED_MAX_NEW = 8, 1024, 64, 32
ED_TF_ATOL = 1e-4
ED_REFUSAL = "seamless decodes from frames, not augmented text"
ED_LAUNCHERS = (
    (["repro_torch.launch.train", "--arch", ED_ARCH, "--smoke", "--steps",
      "2"], r"^seamless-m4t-medium: 2 steps in [0-9.]+s; loss [0-9.]+ -> "
            r"[0-9.]+; restarts 0$"),
    (["repro_torch.launch.serve", "--arch", ED_ARCH], re.escape(ED_REFUSAL)))


def _encdec_run(params, cfg, frames, toks, dev):
    """Prefill ED_PROMPT tokens over `frames`, then ED_CHECK_STEPS decode
    steps of the given tokens: (logits (B, prompt + steps, V) and the
    cache's K/V on the CPU, the (query, key) lengths of every naive
    attention call)."""
    seen, naive = [], attention.naive_attention

    def spy(q, k, *args, **kw):
        seen.append((q.shape[1], k.shape[1]))
        return naive(q, k, *args, **kw)
    f, t = frames.to(dev), toks.to(dev)
    with mock.patch.object(attention, "naive_attention", spy):
        lg, cache = encdec.prefill(params, f, t[:, :ED_PROMPT], cfg,
                                   max_len=ED_PROMPT + ED_CHECK_STEPS)
        outs = [lg.cpu()]
        for i in range(ED_PROMPT, ED_PROMPT + ED_CHECK_STEPS):
            lg, cache = encdec.decode_step(params, cache, t[:, i:i + 1], cfg)
            outs.append(lg.cpu())
    tensors = {k: v.cpu() for k, v in vars(cache).items() if k != "length"}
    return torch.cat(outs, 1), tensors, seen


def _encdec_card_vs_cpu(card, dev) -> None:
    """(a) 2 + 2 layers at full width and f32 on the card against the
    CPU, at each ED_CHECK_SRC."""
    t0 = time.perf_counter()
    cfg = get_config(ED_ARCH).with_(num_layers=ED_CHECK_LAYERS,
                                    encoder_layers=ED_CHECK_LAYERS,
                                    compute_dtype="float32")
    ok = True
    with torch.inference_mode():
        params = get_model(cfg).init(
            torch.Generator(device=dev).manual_seed(SEED + 22), device=dev)
        cparams = _tree.tree_map(lambda t: t.cpu(), params)
        rng = np.random.default_rng(SEED + 22)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (ED_CHECK_B, ED_PROMPT + ED_CHECK_STEPS)
        ).astype(np.int32))
        for s_src in ED_CHECK_SRC:
            frames = torch.from_numpy(rng.standard_normal(
                (ED_CHECK_B, s_src, cfg.d_model)).astype(np.float32))
            t1 = time.perf_counter()
            got, gcache, gseen = _encdec_run(params, cfg, frames, toks, dev)
            card_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            want, wcache, wseen = _encdec_run(cparams, cfg, frames, toks,
                                              "cpu")
            cpu_s = time.perf_counter() - t1
            err = float((got - want).abs().max())
            cerr = {k: float((gcache[k] - w).abs().max() / w.abs().max())
                    for k, w in wcache.items()}
            chunked = s_src > cfg.attn_chunk and s_src % cfg.attn_chunk == 0
            path_ok = ((s_src, s_src) in gseen) != chunked and gseen == wseen
            ok &= (err <= ED_LOGITS_ATOL and path_ok
                   and all(e <= ED_CACHE_RTOL for e in cerr.values()))
            path = (f"non-causal chunked, {s_src // cfg.attn_chunk} x "
                    f"{s_src // cfg.attn_chunk} chunks of {cfg.attn_chunk}"
                    if chunked else "naive")
            log(f"encdec card vs cpu ({card}): {ED_ARCH} at full width, "
                f"{ED_CHECK_LAYERS} + {ED_CHECK_LAYERS} of 12 + 12 layers, "
                f"f32 compute: frames B = {ED_CHECK_B} x {s_src} (encoder "
                f"path {path}: as the rule names it {path_ok}), prefill "
                f"{ED_PROMPT} tokens + {ED_CHECK_STEPS} decode steps on the "
                f"card ({card_s:.2f} s) and on the CPU ({cpu_s:.2f} s): "
                f"logits max abs err {err:.3g} (limit {ED_LOGITS_ATOL}; "
                f"logits up to {float(want.abs().max()):.3g}); cache max err "
                f"over its largest |value| "
                f"{ {k: float(f'{e:.3g}') for k, e in cerr.items()} } "
                f"(limit {ED_CACHE_RTOL})")
        del params, cparams
    log(f"encdec card vs cpu ({card}): {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError("encdec card vs cpu: a check failed (above)")


def _encdec_tf(cfg, params, frames, prompt, new) -> float:
    """At f32 compute: prefill of `prompt`, then decode of the generated
    tokens `new` (the last one is never fed), against `forward` over
    them all: the largest abs difference of the logits."""
    c32 = cfg.with_(compute_dtype="float32")
    seq = torch.cat([prompt, new[:, :-1]], 1)
    full = encdec.forward(params, frames, seq, c32)
    lg, cache = encdec.prefill(params, frames, prompt, c32,
                               max_len=seq.shape[1])
    outs = [lg]
    for i in range(prompt.shape[1], seq.shape[1]):
        lg, cache = encdec.decode_step(params, cache, seq[:, i:i + 1], c32)
        outs.append(lg)
    return float((torch.cat(outs, 1) - full).abs().max())


def _encdec_serve(card, dev) -> dict[str, int]:
    """(b) full depth behind `generate`. Returns the launch counts of the
    generate call (set to 0 before it)."""
    cfg = get_config(ED_ARCH)
    api = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device=dev).manual_seed(SEED + 23),
                          device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(SEED + 23)
        frames = torch.randn((ED_B, ED_SRC, cfg.d_model), generator=gen,
                             device=dev)
        prompt = torch.randint(0, cfg.vocab_size, (ED_B, ED_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)
        batch = {"frames": frames, "tokens": prompt}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        new, cache = generate(api, params, batch, max_new=ED_MAX_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        ok = (tuple(new.shape) == (ED_B, ED_MAX_NEW)
              and int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size
              and int(cache.length[0]) == ED_PROMPT + ED_MAX_NEW - 1)
        del cache
        total = ED_PROMPT + MD_STEPS + 8

        def prefill():
            return api.prefill(params, batch, max_len=total)
        p_s = _median_step_s(prefill, 3)
        p_kernels = device_profile(prefill, reps=1)
        p_busy = sum(t for _, t, _ in p_kernels) * 1e-3
        p_top = [(k[:40], round(t * 1e-3, 3)) for k, t, _ in p_kernels[:3]]
        lg, cache = prefill()
        ok &= bool(torch.isfinite(lg).all())
        del lg
        box, tok = [cache], prompt[:, -1:]

        def step():
            lg, box[0] = api.decode_step(params, box[0], tok)
            return lg
        d_s = _median_step_s(step, MD_STEPS)
        kernels = device_profile(step, reps=1)
        ok &= bool(torch.isfinite(step()).all())
        busy = sum(t for _, t, _ in kernels) * 1e-3
        top = [(k[:40], round(t * 1e-3, 3)) for k, t, _ in kernels[:4]]
        del box, cache
        peak = torch.cuda.max_memory_allocated()
        tf = _encdec_tf(cfg, params, frames, prompt, new)
        n_params = param_count(params)
        del params, frames, prompt, batch, new
    log(f"encdec serve {ED_ARCH} ({card}): full width, full depth "
        f"({cfg.encoder_layers} + {cfg.num_layers} layers, {n_params} "
        f"parameters, {cfg.param_dtype} weights, {cfg.compute_dtype} "
        f"compute), drawn in {init_s:.1f} s; generate B = {ED_B}, frames "
        f"{ED_SRC}, prompt {ED_PROMPT} tokens, {ED_MAX_NEW} new: "
        f"{gen_s * 1e3:.1f} ms, launches "
        f"{ {k: n for k, n in counts.items() if n} }; prefill p50 "
        f"{p_s * 1e3:.3f} ms (one profiled: device_busy_ms {p_busy:.3f} "
        f"idle_share {1 - p_busy / (p_s * 1e3):.3f} kernel_launches "
        f"{sum(n for _, _, n in p_kernels):.0f}; busiest ms {p_top}); decode "
        f"step p50 {d_s * 1e3:.3f} ms ({ED_B / d_s:.1f} tokens/s); one "
        f"profiled step: device_busy_ms {busy:.3f} idle_share "
        f"{1 - busy / (d_s * 1e3):.3f} kernel_launches "
        f"{sum(n for _, _, n in kernels):.0f}; busiest ms {top}; peak device "
        f"memory {peak / 2 ** 30:.2f} GiB; finite logits and tokens in "
        f"range {ok}; decode continues prefill at f32 over the prompt and "
        f"the generated tokens: max abs err {tf:.3g} (limit {ED_TF_ATOL})")
    if not (ok and tf <= ED_TF_ATOL and not any(counts.values())):
        raise AssertionError("encdec serve: a check failed (above)")
    torch.cuda.empty_cache()
    return counts


def _encdec_launchers_check(card, started) -> None:
    """(d) the training launcher trains; the serving launcher refuses."""
    t0, procs = started
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    (train, serve), ((t_out, t_err), (s_out, s_err)) = procs, outs
    want_train, want_refusal = (w for _, w in ED_LAUNCHERS)
    if train.returncode != 0 or not re.search(want_train, t_out, re.M):
        raise AssertionError(f"encdec launcher {ED_LAUNCHERS[0][0]}: rc "
                             f"{train.returncode}\n{t_out}\n{t_err[-4000:]}")
    if (serve.returncode == 0 or not re.search(want_refusal, s_err)
            or "top-1" in s_out):
        raise AssertionError(f"encdec launcher {ED_LAUNCHERS[1][0]}: rc "
                             f"{serve.returncode}\n{s_out}\n{s_err[-4000:]}")
    log(f"encdec launcher ({card}): python -m "
        f"{' '.join(ED_LAUNCHERS[0][0])}: rc 0; {t_out.strip()} | python -m "
        f"{' '.join(ED_LAUNCHERS[1][0])}: refused, rc {serve.returncode}: "
        f"{s_err.strip().splitlines()[-1]} (both in "
        f"{time.perf_counter() - t0:.1f} s)")


def phase_encdec(dev, card: str) -> dict[str, int]:
    """seamless-m4t-medium at full width (see ED_* above): (a) the card
    against the CPU, (b) served at full depth, (c) trained at full depth,
    (d) the launchers. Returns the launches of (b)'s serving path."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="encdec_", dir=os.path.join(ROOT, "build"))
    try:
        started = _models_launchers_start(root, ED_LAUNCHERS)
        _encdec_card_vs_cpu(card, dev)
        torch.cuda.empty_cache()
        _encdec_launchers_check(card, started)
        launches = _encdec_serve(card, dev)
        _models_train(card, dev, root, get_config(ED_ARCH), "adamw",
                      "encdec")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"encdec path launches ({card}): "
        f"{ {k: n for k, n in launches.items() if n} } (the path has no "
        f"kernel)")
    log(f"encdec ({card}): the phase took {time.perf_counter() - t0:.1f} s")
    return launches


# -- the dryrun phase -----------------------------------------------------
# The dry run (`launch/dryrun.py`): every (arch x shape) cell of the single
# production mesh, (data 16, model 16), one step of the port on meta
# tensors (host only, in DRY_JOBS worker processes), with its roofline
# (`launch/roofline.py`). Then three steps run on the card at full width
# and the shapes the other phases run them, each held to the dry run of
# the same step at the same shape on meta: dot FLOPs equal to the same
# dispatch count around the real step, the kvq step's kernel launches
# equal to the launch counters, the step's peak (the allocator's, and the
# same dispatch mode's count of live storages on the card) within DRY_BAND
# of the prediction, and its time at least DRY_BOUND_SHARE of the roofline
# bound.
DRY_JOBS = 8
DRY_OK_CELLS = 32                        # 10 archs x 4 shapes - 8 skipped
DRY_BAND = (0.9, 1.1)                    # card peak / predicted peak
DRY_BOUND_SHARE = 0.95
DRY_STEPS = 5


def _dry_sweep(card: str) -> None:
    cells = [(a, s, "single") for a in ARCH_IDS for s in shapes.SHAPES]
    jobs = min(DRY_JOBS, os.cpu_count() or 1)
    t0 = time.perf_counter()
    recs = list(dryrun.sweep(cells, "baseline", jobs))
    host_s = time.perf_counter() - t0
    recs.sort(key=lambda r: (ARCH_IDS.index(r["arch"]),
                             list(shapes.SHAPES).index(r["shape"])))
    for rec in recs:
        head = f"dryrun cell ({card}): {rec['arch']} x {rec['shape']}"
        if rec["status"] != "ok":
            log(f"{head}: {rec['status']} {rec.get('reason') or rec.get('error')}")
            continue
        row = roofline.analyze_cell(rec)
        log(f"{head}: ok, peak {rec['memory']['peak_memory_in_bytes'] / 1e9:.2f}"
            f" GB per rank, fits {rec['fits']} ({rec['card_bytes']} B), dot "
            f"FLOPs {rec['dot_flops']:.4e} {rec['dot_flops_by_dtype']}, "
            f"collective bytes {rec['collectives']['total']}, bound "
            f"{row['bound_s']:.4f} s ({row['dominant']}), trace "
            f"{rec['trace_s']:.2f} s")
    states = [r["status"] for r in recs]
    log(f"dryrun sweep ({card}): {states.count('ok')} ok, "
        f"{states.count('skipped')} skipped, {states.count('error')} errors "
        f"of {len(recs)} cells (single mesh, baseline) in {host_s:.1f} s of "
        f"host time over {jobs} processes; "
        f"{sum(1 for r in recs if r.get('fits'))} fit the card")
    if states.count("error") or states.count("ok") != DRY_OK_CELLS:
        raise AssertionError("dryrun sweep: " + "; ".join(
            f"{r['arch']} x {r['shape']}: {r.get('error')}" for r in recs
            if r["status"] == "error") or f"{states.count('ok')} ok cells")


def _dry_check(card, dev, label, cfg, case, variant, make_args,
               src_len=None) -> dict[str, int]:
    """The real step on the card against its dry run on meta. Returns the
    launch counts of its runs on the card."""
    rec = dryrun.record(cfg, case, None, variant, src_len=src_len)
    row = roofline.analyze_cell(dict(rec, arch=cfg.name, shape=label,
                                     mesh="one"), cfg=cfg)
    scfg = dryrun.serving_config(cfg, case.kind, variant)
    fn, _ = dryrun.step_fn(scfg, case.kind, seq=case.seq, variant=variant,
                           lr=TRAIN_LR)
    args = make_args(scfg)
    fn(*args)                                          # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    _, got = hlo_analysis.analyze(fn, *args)
    torch.cuda.synchronize()
    step_launches = {k: n for k, n in ops.launch_counts().items() if n}
    base = torch.cuda.memory_allocated() - hlo_analysis.storage_bytes(args)
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    step_s = _median_step_s(lambda: fn(*args), DRY_STEPS)
    launches = ops.launch_counts()
    want_peak = rec["memory"]["peak_memory_in_bytes"]
    ratio = peak / want_peak
    counted = got["peak_bytes"] / want_peak
    log(f"dryrun check ({card}): {label} ({cfg.name}, {case.kind}, B = "
        f"{case.batch}, seq {case.seq}{f', src {src_len}' if src_len else ''}"
        f", {scfg.param_dtype} weights, variant {variant}): dot FLOPs card "
        f"{got['dot_flops']:.6e} {got['dot_flops_by_dtype']} vs meta "
        f"{rec['dot_flops']:.6e}; launches card {step_launches} vs meta "
        f"{rec['kernel_launches']}; peak card {peak} B vs predicted "
        f"{want_peak} B (ratio {ratio:.4f}, band {DRY_BAND}); dispatch-count "
        f"peak on the card {got['peak_bytes']} B (ratio {counted:.4f}); step p50 "
        f"{step_s * 1e3:.3f} ms vs bound {row['bound_s'] * 1e3:.4f} ms "
        f"({row['dominant']}; compute {row['compute_s'] * 1e3:.4f}, memory "
        f"{row['memory_s'] * 1e3:.4f}), share "
        f"{row['bound_s'] / step_s:.4f}; trace {rec['trace_s']:.2f} s")
    problems = []
    if (got["dot_flops"], got["dot_flops_by_dtype"]) != (
            rec["dot_flops"], rec["dot_flops_by_dtype"]):
        problems.append("dot FLOPs differ")
    if step_launches != rec["kernel_launches"]:
        problems.append("kernel launches differ")
    if not DRY_BAND[0] <= ratio <= DRY_BAND[1]:
        problems.append(f"peak ratio {ratio:.4f} outside {DRY_BAND}")
    if not DRY_BAND[0] <= counted <= DRY_BAND[1]:
        problems.append(f"dispatch-count peak ratio {counted:.4f} outside "
                        f"{DRY_BAND}")
    if step_s < DRY_BOUND_SHARE * row["bound_s"]:
        problems.append("the step beat its bound: the count is short")
    if problems:
        raise AssertionError(f"dryrun check {label}: " + "; ".join(problems))
    return launches


def _dry_toy(card: str) -> None:
    """The peak counter on this machine's torch, on a toy whose live bytes
    are known (`tests/test_torch_hlo_analysis.py` holds the same toy on
    the CPU's torch): x, a, b and c live at once; a stays (autograd saves
    it) after b dies."""
    mb = 1000 * 1000 * 4
    x = torch.empty((1000, 1000), device="meta", requires_grad=True)

    def step(x):
        a = x * 2.0
        b = torch.sin(a)
        del a
        c = b.sum()
        del b
        return c
    _, rec = hlo_analysis.analyze(step, x)
    got = (rec["peak_bytes"], rec["end_bytes"])
    log(f"dryrun toy ({card}): torch {torch.__version__}, peak and end "
        f"bytes {got}, want {(3 * mb + 4, 2 * mb + 4)}")
    if got != (3 * mb + 4, 2 * mb + 4):
        raise AssertionError(f"dryrun toy: the peak counter gave {got}")


def phase_dryrun(dev, card: str) -> dict[str, int]:
    """The toy, the sweep, then the three card checks (see DRY_* above).
    Returns the launches of the kvq decode step's runs on the card."""
    t0 = time.perf_counter()
    _dry_toy(card)
    _dry_sweep(card)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)

    def params(cfg):
        return get_model(cfg).init(gen, device=dev)

    def train_args(cfg):
        p = params(cfg)
        opt = adamw(lr=TRAIN_LR)
        return p, opt.init(p), shard_batch(next(lm_batches(LMTaskConfig(
            cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED))), dev)

    def tokens(cfg, b):
        return torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                             device=dev, dtype=torch.int32)

    def encdec_args(cfg):
        cache = get_model(cfg).init_cache(ED_B, ED_PROMPT + ED_MAX_NEW,
                                          src_len=ED_SRC, device=dev)
        cache.length.fill_(ED_PROMPT)
        return params(cfg), cache, tokens(cfg, ED_B)

    def kvq_args(cfg):
        cache = dense.init_quant_cache(cfg, DEC_B, DEC_T,
                                       page_rows=dryrun.KVQ["page_rows"],
                                       device=dev)
        cache.length.fill_(DEC_T - 1024)
        return params(cfg), cache, tokens(cfg, DEC_B)

    qwen = get_config("qwen2-0.5b")
    _dry_check(card, dev, "train", qwen,
               shapes.ShapeCase("card_train", "train", TRAIN_S, TRAIN_B),
               "baseline", train_args)
    torch.cuda.empty_cache()
    _dry_check(card, dev, "encdec_decode", get_config(ED_ARCH),
               shapes.ShapeCase("card_decode", "decode",
                                ED_PROMPT + ED_MAX_NEW, ED_B),
               "baseline", encdec_args, src_len=ED_SRC)
    torch.cuda.empty_cache()
    launches = _dry_check(card, dev, "kvq_decode", qwen,
                          shapes.ShapeCase("card_kvq", "decode", DEC_T,
                                           DEC_B), "kvq", kvq_args)
    torch.cuda.empty_cache()
    per_step = {k: launches.get(k, 0) for k in DEC_KERNELS}
    if min(per_step.values()) <= 0:
        raise AssertionError(f"dryrun: the kvq path launched {per_step}")
    log(f"dryrun path launches ({card}): "
        f"{ {k: n for k, n in launches.items() if n} }")
    log(f"dryrun ({card}): the phase took {time.perf_counter() - t0:.1f} s")
    return launches


# -- the train_sharded phase ----------------------------------------------
# A training state sharded over SH_RANKS torch.distributed ranks (ROADMAP
# A2's training half). The machine has one card, so the ranks share cuda:0
# and talk over gloo (NCCL does not place two ranks on one GPU): this is
# the code path of a (data 2, model 2) mesh, not multi-card scaling. Every
# rank is one process (`collectives.spawn`); the run has a time limit and
# so does each process group. In one spawn each rank runs, in order:
#   probe — every gloo collective of the path on CUDA tensors (all_reduce
#           SUM and MAX on f32 and int32, reduce_scatter, all_gather,
#           barrier) against its plain answer;
#   (a)   — qwen2-0.5b at full width, 2 layers, f32 compute, B = 8 x 64, on
#           a (2, 2) mesh against the one-rank port step on the card from
#           the same weights and batch: AdamW (wd 0.1) 2 steps with
#           grad_accum 2 (each data rank's rows are one microbatch) and no
#           clipping, the loss within 1e-6 relative and every parameter
#           within 1e-5 of its leaf's largest |value|; AdamW one step with
#           grad_accum 1 (the batch's halves summed across ranks) and
#           clipping: the loss and the clip norm within 1e-6 and the
#           grads within 1e-5 of each leaf's largest (its parameters are
#           not held: Adam turns last-bit grad differences in near-zero
#           grads, the key bias's, into lr-sized moves, and a clip scale
#           an ulp apart does the same at the next step); Adafactor one
#           step (grad_accum 2, clipping), its parameters within 1e-5;
#   (b)   — `make_two_level_all_reduce` on CUDA tensors at (pod 2, data 2),
#           one (896, 4864) gradient per rank: within scale + 1e-5 of the
#           mean on every rank, with its time;
#   (c)   — qwen2-0.5b FULL (24 layers, f32 weights, bf16 compute, remat)
#           through the SPMD ElasticTrainer on (data 2, model 2), B = 8 x
#           64 repeated, AdamW lr 3e-4, 6 steps, a sharded checkpoint every
#           2 (rank 0 writes, keep 2); 2 ranks dropped at step 3, the
#           survivors re-form (data 1, model 2), restore step 2 and finish.
#           Fails unless the losses fall, the restored state gathered whole
#           equals the checkpoint's files bit for bit, and each rank's
#           resident parameter and optimizer bytes equal its blocks (about
#           a quarter of the whole before the shrink, half after). Prints
#           the p50 step on each mesh, the collectives' share of it (host
#           clock, each collective after a synchronize), the bytes each
#           rank sends per step (ring model), and each rank's peak memory.
# Then (d): `python -m repro_torch.launch.train --smoke --data 2 --model 2`
# on the card, rc 0 and its closing line.
SH_RANKS, SH_RUN_S = 4, 900
SH_STEPS, SH_SAVE_EVERY, SH_FAIL_AT, SH_DROP, SH_KEEP = 6, 2, 3, 2, 2
SH_LOSS_RTOL, SH_PARAM_TOL = 1e-6, 1e-5
SH_TWO_LEVEL_SHAPE = (896, 4864)


def _sharded_state(mesh, cfg, api, opt, seed):
    """Every rank draws the whole state from `seed` on its device and keeps
    its blocks. Returns (params, state, param and state shardings, the
    whole state as meta tensors)."""
    full = api.init(torch.Generator(device=mesh.device).manual_seed(seed),
                    device=mesh.device)
    meta = _tree.tree_map(lambda t: t.to("meta"), full)
    pshard = sh.param_shardings(full, mesh, cfg)
    oshard = sh.opt_state_shardings(opt.init(meta), meta, mesh, cfg)
    params = sh.shard_tree(full, pshard)
    del full
    return params, opt.init(params), pshard, oshard, (meta, opt.init(meta))


def _probe_gloo(mesh) -> dict[str, bool]:
    n, r, dev = mesh.size, mesh.rank, mesh.device
    axes = mesh.axis_names
    base = torch.arange(8 * n, dtype=torch.float32)
    x = (base + r).to(dev)
    total = sum(base + k for k in range(n))
    top = base + n - 1
    out = {
        "all_reduce_sum_f32": torch.equal(
            coll.all_reduce(x, mesh, axes).cpu(), total),
        "all_reduce_max_f32": torch.equal(
            coll.all_reduce(x, mesh, axes, "max").cpu(), top),
        "all_reduce_sum_i32": torch.equal(
            coll.all_reduce(x.to(torch.int32), mesh, axes).cpu(),
            total.to(torch.int32)),
        "all_reduce_max_i32": torch.equal(
            coll.all_reduce(x.to(torch.int32), mesh, axes, "max").cpu(),
            top.to(torch.int32)),
        "reduce_scatter": torch.equal(
            coll.reduce_scatter(x, mesh, axes).cpu(),
            total[r * 8:(r + 1) * 8]),
        "all_gather": torch.equal(
            coll.all_gather(x[:8], mesh, axes).cpu(),
            torch.cat([base[:8] + k for k in range(n)]))}
    coll.barrier(mesh)
    out["barrier"] = True
    return out


def _grab(store: list, shardings):
    """A grad_transform that keeps the first step's grads, whole."""
    def hook(g):
        if not store:
            store.append(sh.gather_tree(g, shardings))
        return g
    return hook


def _sharded_parity(mesh) -> dict | None:
    """(a) on every rank; rank 0 runs the one-rank steps and returns the
    comparison."""
    cfg = get_config("qwen2-0.5b").with_(num_layers=TRAIN_CHECK_LAYERS,
                                         compute_dtype="float32")
    api = get_model(cfg)
    batch = next(lm_batches(LMTaskConfig(cfg.vocab_size, TRAIN_S, TRAIN_B)))
    # (name, optimizer, steps, grad_accum, clip_norm)
    cases = (("adamw_aligned", lambda: adamw(lr=TRAIN_LR, weight_decay=0.1),
              2, 2, None),
             ("adamw_split", lambda: adamw(lr=TRAIN_LR), 1, 1, 1.0),
             ("adafactor", lambda: adafactor(lr=TRAIN_LR), 1, 2, 1.0))
    out = {}
    for name, make_opt, steps, accum, clip in cases:
        opt = make_opt()
        params, state, pshard, _, _ = _sharded_state(mesh, cfg, api, opt,
                                                     SEED + 15)
        grads: list = []
        step = make_sharded_train_step(api.loss_fn, opt, mesh, pshard,
                                       grad_accum=accum, clip_norm=clip,
                                       grad_transform=_grab(grads, pshard))
        losses, norms = [], []
        for _ in range(steps):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        whole = sh.gather_tree(params, pshard)
        del params, state
        if mesh.rank == 0:
            one = api.init(torch.Generator(device=mesh.device).manual_seed(
                SEED + 15), device=mesh.device)
            ograds: list = []
            raw = make_train_step(api.loss_fn, opt, grad_accum=accum,
                                  clip_norm=clip,
                                  grad_transform=lambda g, s=ograds: (
                                      s.append(g) if not s else None) or g)
            ostate = opt.init(one)
            tb = shard_batch(batch, mesh.device)
            olosses, onorms = [], []
            for _ in range(steps):
                one, ostate, m = raw(one, ostate, tb)
                olosses.append(float(m["loss"]))
                onorms.append(float(m["grad_norm"]))
            out[name] = {
                "losses": losses, "one_rank": olosses,
                "loss_err": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, olosses)),
                "norm_err": max(abs(a - b) / max(abs(b), 1e-30)
                                for a, b in zip(norms, onorms)),
                "grad_err": _leaf_rel_err(grads[0], ograds[0]),
                "param_err": (_leaf_rel_err(whole, one) if accum == 2
                              else None)}
            del one, ostate, ograds
        del whole, grads
        torch.cuda.empty_cache()
    return out if mesh.rank == 0 else None


def _two_level(mesh) -> dict:
    """(b) on every rank of a (pod 2, data 2) mesh."""
    def grad(rank):
        gen = torch.Generator(device=mesh.device).manual_seed(SEED + 16 +
                                                              rank)
        return torch.randn(SH_TWO_LEVEL_SHAPE, generator=gen,
                           device=mesh.device)
    fn = compression.make_two_level_all_reduce(mesh)
    g = grad(mesh.rank)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn({"w": g})["w"]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    every = [grad(k) for k in range(mesh.size)]
    mean = sum(every) / mesh.size
    scale = max(float(t.abs().max()) for t in every) / 127.0
    return {"err": float((got - mean).abs().max()), "scale": scale,
            "ms": statistics.median(times) * 1e3}


class _ShardedRecording(CheckpointManager):
    """A sharded CheckpointManager that, when it restores step `hold`,
    gathers the restored state whole and checks it against the step's
    files bit for bit (rank 0 reads them), and times its calls."""

    def __init__(self, directory, keep, hold):
        super().__init__(directory, keep=keep)
        self.hold, self.checked = hold, []
        self.save_s, self.restore_s = [], []

    def save_async(self, step, tree, shardings=None):
        t0 = time.perf_counter()
        super().save_async(step, tree, shardings)
        self.save_s.append((step, round(time.perf_counter() - t0, 2)))

    def restore_latest(self, like, device=None, shardings=None):
        t0 = time.perf_counter()
        tree, step = super().restore_latest(like, device, shardings)
        torch.cuda.synchronize()
        self.restore_s.append((step, round(time.perf_counter() - t0, 2)))
        if step == self.hold:
            path = os.path.join(self.directory, f"step_{step:08d}")
            same = True
            for i, (t, s) in enumerate(zip(_tree.leaves(tree),
                                           _tree.leaves(shardings),
                                           strict=True)):
                whole = sh.gather(t, s)
                if s.mesh.rank == 0:
                    want = np.load(os.path.join(path, f"{i:05d}.npy"),
                                   mmap_mode="r")
                    same &= np.array_equal(whole.cpu().numpy(), want)
                del whole
            self.checked.append(same)
        return tree, step


def _sharded_elastic(world, root) -> dict:
    """(c) on every rank."""
    cfg = get_config("qwen2-0.5b")
    api = get_model(cfg)
    opt = adamw(lr=TRAIN_LR)
    batch = next(lm_batches(LMTaskConfig(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                         seed=SEED)))
    sizes, steps = [], []

    def make_state(mesh):
        params, state, pshard, oshard, whole = _sharded_state(
            mesh, cfg, api, opt, SEED + 17)
        sizes.append({"mesh": dict(mesh.shape),
                      "resident": sh.resident_bytes((params, state)),
                      "blocks": sh.block_bytes(whole, (pshard, oshard)),
                      "whole": _state_bytes(whole)})
        raw = make_sharded_train_step(api.loss_fn, opt, mesh, pshard)

        def step_fn(p, o, b, mesh):
            torch.cuda.synchronize()
            mesh.reset_comm()
            t0 = time.perf_counter()
            out = raw(p, o, b)
            torch.cuda.synchronize()
            steps.append((tuple(mesh.shape.values()),
                          time.perf_counter() - t0, mesh.comm["seconds"],
                          mesh.comm["bytes_sent"], mesh.comm["calls"]))
            return out
        return params, state, step_fn, (pshard, oshard)

    ckpt = _ShardedRecording(root, SH_KEEP, SH_SAVE_EVERY)
    torch.cuda.reset_peak_memory_stats()
    out = ElasticTrainer(make_state=make_state, ckpt=ckpt,
                         save_every=SH_SAVE_EVERY, model_parallel=2).run(
        itertools.repeat(batch), num_steps=SH_STEPS,
        injector=FailureInjector({SH_FAIL_AT: SH_DROP}), world=world)
    out.update(sizes=sizes, steps=steps, checked=ckpt.checked,
               save_s=ckpt.save_s, restore_s=ckpt.restore_s,
               peak=torch.cuda.max_memory_allocated())
    return out


def _train_sharded_rank(world, root) -> dict:
    """One rank of the phase: the probe and (a) on a (data 2, model 2)
    mesh, (b) on (pod 2, data 2), then (c)."""
    t0 = time.perf_counter()
    mesh = world.join(range(world.size), (2, 2), ("data", "model"),
                      "parity")
    out = {"probe": _probe_gloo(mesh), "parity": _sharded_parity(mesh)}
    out["parity_s"] = time.perf_counter() - t0
    mesh = world.join(range(world.size), (2, 2), ("pod", "data"),
                      "two_level")
    out["two_level"] = _two_level(mesh)
    world.leave()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["elastic"] = _sharded_elastic(world, root)
    out["elastic_s"] = time.perf_counter() - t0
    return out


def _sharded_launcher(card, root) -> None:
    """(d) the launcher at --data 2 --model 2 on the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = ["--smoke", "--data", "2", "--model", "2", "--steps", "4",
            "--ckpt-dir", os.path.join(root, "launch_sharded")]
    line = re.compile(r"^qwen2-0\.5b: 4 steps in [0-9.]+s; loss [0-9.]+ -> "
                      r"[0-9.]+; restarts 0$", re.M)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0 or not line.search(out.stdout):
        raise AssertionError(f"sharded launcher {argv}: rc {out.returncode}"
                             f"\n{out.stdout}\n{out.stderr[-4000:]}")
    log(f"train_sharded launcher ({card}): python -m "
        f"repro_torch.launch.train {' '.join(argv[:-2])}: rc 0 in "
        f"{time.perf_counter() - t0:.1f} s; {out.stdout.strip()}")


def _p50(steps, shape) -> tuple[float, float, float, int]:
    """(p50 step s, its collectives' share, bytes sent per step, calls)
    over the steps run on a mesh of `shape`."""
    mine = [s for s in steps if s[0] == shape]
    mid = sorted(mine, key=lambda s: s[1])[len(mine) // 2]
    return mid[1], mid[2] / mid[1], mid[3], mid[4]


def phase_train_sharded(card: str) -> None:
    """The sharded training state on SH_RANKS ranks sharing the card (see
    SH_* above). Fails on any check or a rank's failure."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_sharded_",
                            dir=os.path.join(ROOT, "build"))
    try:
        outs = coll.spawn(_train_sharded_rank, SH_RANKS,
                          os.path.join(root, "elastic"), device="cuda:0",
                          timeout_s=SH_RUN_S)
        problems = []
        probe = outs[0]["probe"]
        log(f"train_sharded probe ({card}): gloo collectives on CUDA "
            f"tensors, {SH_RANKS} ranks on cuda:0: {probe}")
        if not all(all(o["probe"].values()) for o in outs):
            problems.append("a gloo collective on CUDA tensors")
        for name, r in outs[0]["parity"].items():
            log(f"train_sharded parity ({card}): qwen2-0.5b full width, "
                f"{TRAIN_CHECK_LAYERS} layers, f32, B = {TRAIN_B} x "
                f"{TRAIN_S}, (data 2, model 2) against one rank: {name} "
                f"losses {[round(x, 6) for x in r['losses']]} (one rank "
                f"{[round(x, 6) for x in r['one_rank']]}), loss rel err "
                f"{r['loss_err']:.3g} (limit {SH_LOSS_RTOL}), clip norm "
                f"rel err {r['norm_err']:.3g} (limit {SH_LOSS_RTOL}), step-1 "
                f"grads "
                f"{r['grad_err']:.3g} of each leaf's max, params "
                f"{'not held' if r['param_err'] is None else format(r['param_err'], '.3g')}"
                f" (limit {SH_PARAM_TOL})")
            if max(r["loss_err"], r["norm_err"]) > SH_LOSS_RTOL \
                    or r["grad_err"] > SH_PARAM_TOL \
                    or (r["param_err"] or 0.0) > SH_PARAM_TOL:
                problems.append(f"parity {name}")
        log(f"train_sharded parity ({card}): {outs[0]['parity_s']:.1f} s "
            "with the probe")
        two = [o["two_level"] for o in outs]
        log(f"train_sharded two_level ({card}): make_two_level_all_reduce "
            f"at (pod 2, data 2), one {SH_TWO_LEVEL_SHAPE} f32 gradient per "
            f"rank on cuda:0: max err vs the mean per rank "
            f"{[round(t['err'], 6) for t in two]} (limit scale + 1e-5 = "
            f"{two[0]['scale'] + 1e-5:.6f}); median of 3 per rank (ms) "
            f"{[round(t['ms'], 1) for t in two]}")
        if any(t["err"] > t["scale"] + 1e-5 for t in two):
            problems.append("two-level all-reduce")
        el = [o["elastic"] for o in outs]
        kept = [e for e in el if not e["dropped"]]
        for rank, e in enumerate(el):
            sizes = "; ".join(
                f"{z['mesh']} resident {z['resident']} = blocks "
                f"{z['blocks']}: {z['resident'] == z['blocks']}, "
                f"{z['blocks'] / z['whole']:.4f} of the whole "
                f"{z['whole']}" for z in e["sizes"])
            log(f"train_sharded elastic ({card}) rank {rank}: dropped "
                f"{e['dropped']}, restarts {e['restarts']}, final_devices "
                f"{e['final_devices']}, monitored {e['monitored']}; {sizes}; "
                f"peak device memory {e['peak'] / 2 ** 30:.2f} GiB")
            if any(z["resident"] != z["blocks"] for z in e["sizes"]):
                problems.append(f"rank {rank} holds more than its blocks")
        e = kept[0]
        losses = e["losses"]
        log(f"train_sharded elastic ({card}): qwen2-0.5b FULL, "
            f"(data 2, model 2) -> (data 1, model 2) at step {SH_FAIL_AT}, "
            f"{SH_STEPS} steps, B = {TRAIN_B} x {TRAIN_S}: losses "
            f"{[round(x, 4) for x in losses]}; saves (step, s on the "
            f"caller) {e['save_s']}; restores {e['restore_s']}; step "
            f"{SH_SAVE_EVERY}'s restore gathered = its files bit for bit: "
            f"{e['checked']}; the run {outs[0]['elastic_s']:.1f} s")
        for shape in ((2, 2), (1, 2)):
            rows = []
            for rank, ee in enumerate(el):
                if any(st[0] == shape for st in ee["steps"]):
                    p50, share, sent, calls = _p50(ee["steps"], shape)
                    rows.append(f"rank {rank}: p50 {p50 * 1e3:.1f} ms, "
                                f"collectives {share:.3f} of it ({calls} "
                                f"calls), sends {sent / 1e9:.3f} GB/step")
            log(f"train_sharded step ({card}) at (data, model) = {shape}: "
                + "; ".join(rows))
        if len(kept) != SH_RANKS - SH_DROP or any(
                x["restarts"] != 1 or x["final_devices"] != SH_RANKS - SH_DROP
                or x["monitored"] != ["0", "1"] or x["losses"] != losses
                for x in kept):
            problems.append("the survivors' runs")
        if len(losses) != SH_STEPS or not all(map(math.isfinite, losses)) \
                or losses[-1] >= losses[0]:
            problems.append(f"losses {losses}")
        if e["checked"] != [True]:
            problems.append(f"restore of step {SH_SAVE_EVERY}: {e['checked']}")
        shutil.rmtree(os.path.join(root, "elastic"), ignore_errors=True)
        if problems:
            raise AssertionError("train_sharded: " + "; ".join(problems))
        _sharded_launcher(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"train_sharded ({card}): the phase took "
        f"{time.perf_counter() - t0:.1f} s")


# -- the examples phase ---------------------------------------------------
# The five examples (`repro_torch.examples`) as a user runs them, each on
# cuda:0 and again with device "cpu", each through the work function its
# `main` calls (its result holds the retrievals, tokens and losses). The
# weights come from CPU generators in both runs, so the card and the CPU
# run the same model. Held: the logs line for line (wall times masked);
# the retrievals of quickstart (the batched launch and the cascade) and
# of pod (the single-host engine and the tournament) exactly, every
# query's ids, exact INT8 scores and stage-1 shortlist; the greedy tokens of
# the agents (bf16 compute) equal but for rows whose first differing token
# sits where the CPU's top two logits lie within EX_TIE_REL of the larger,
# exempted and counted; the smoke run's losses within EX_LOSS_RTOL (the
# CPU tests' LOSS_RTOL) and the state it saved at its last step (params,
# AdamW's moments and step) within EX_STATE_RTOL leaf by leaf (the CPU
# tests' STATE_RTOL). Then `train_100m` at full width (the ~100M
# model) on the card, EX_FULL_STEPS steps of B = 8 x 128, its checkpoints
# in a directory under build/ that the phase removes.
EX_TIE_REL = 2.0 ** -6
EX_LOSS_RTOL = 2.0 ** -8
EX_STATE_RTOL = 2.0 ** -2
EX_SMOKE = dict(steps=7, batch=2, seq=32)
EX_FULL_STEPS = 12
# quickstart and the agents through the engine, pod through ShardedIndex.
EX_KERNELS = ("stage1_plane_mma", "stage2_rerank_by_id", "stage2_by_id",
              "stage2_rerank", "stage1_gather")


def _ex_lines(fn, *args, **kw):
    """(the log `fn` prints with wall times masked, its result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return [re.sub(r"\d+\.\d+s\b", "<t>s", line)
            for line in buf.getvalue().strip().splitlines()], out


def _ex_counts(before: dict[str, int]) -> dict[str, int]:
    now = ops.launch_counts()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n - before.get(k, 0)}


def _ex_same(label, card_lines, cpu_lines) -> None:
    if card_lines != cpu_lines:
        raise AssertionError(f"examples {label}: the card's lines differ "
                             f"from the CPU's:\n" + "\n".join(card_lines)
                             + "\n--- cpu ---\n" + "\n".join(cpu_lines))


def _ex_tie_rows(gen_api, params, prompts, got, want) -> int:
    """Rows whose card tokens (got) differ from the CPU's (want): each
    first difference must sit at a near tie of the CPU's logits (the
    port's `forward` on the CPU); returns how many rows."""
    rows = np.flatnonzero((got != want).any(axis=1))
    for row in rows:
        pos = int(np.argmax(got[row] != want[row]))
        seq = torch.from_numpy(np.concatenate([prompts[row],
                                               want[row, :pos]])[None])
        logits = dense.forward(params, seq, gen_api.cfg)[0, -1].float()
        top2 = torch.sort(logits).values[-2:].tolist()
        if top2[1] - top2[0] > EX_TIE_REL * abs(top2[1]):
            raise AssertionError(
                f"examples: row {row} token {pos}: card {got[row, pos]}, "
                f"cpu {want[row, pos]}, top-2 {top2}")
    return len(rows)


def _ex_agents(card, dev, cpu) -> None:
    for name, mod, kw in (
            ("multi_user_agent", multi_user_agent, {}),
            ("serve_rag_agent", serve_rag_agent,
             dict(requests=8, num_docs=256, max_new=16))):
        before = ops.launch_counts()
        card_lines, got = _ex_lines(mod.run, *agent_models(dev),
                                    device=dev, **kw)
        counts = _ex_counts(before)
        models = agent_models(cpu)
        cpu_lines, want = _ex_lines(mod.run, *models, device=cpu, **kw)
        _ex_same(name, [x.split(" -> tokens")[0] for x in card_lines],
                 [x.split(" -> tokens")[0] for x in cpu_lines])
        if not np.array_equal(got["ids"], want["ids"]):
            raise AssertionError(f"examples {name}: ids {got['ids']} "
                                 f"against the CPU's {want['ids']}")
        docs = np.asarray(want["pipe"].doc_tokens)
        queries = docs[want["ids"][:, 0]] if name == "multi_user_agent" \
            else docs[want["gold"]]
        prompts = np.concatenate([docs[want["ids"]].reshape(
            len(queries), -1), queries], axis=1)
        ties = _ex_tie_rows(models[2], models[3], prompts, got["tokens"],
                            want["tokens"])
        log(f"examples {name} ({card}): {len(card_lines)} lines equal the "
            f"CPU's, token rows at a near tie {ties} of "
            f"{len(got['tokens'])}; launches {counts}")
        for line in card_lines:
            log(f"  {line}")


def _ex_same_results(name, got, want) -> str:
    """Each RetrievalResult of `got` (the card's) equal to `want`'s (the
    CPU's) in ids, scores and shortlist, tolerance 0: integer kernels."""
    shapes = []
    for key, res in want.items():
        for field in ("indices", "scores", "candidate_indices"):
            a = getattr(got[key], field).cpu()
            b = getattr(res, field)
            if a.shape != b.shape or not torch.equal(a, b):
                bad = (a != b).nonzero()[:4].tolist() \
                    if a.shape == b.shape else "shape"
                raise AssertionError(
                    f"examples {name}: {key}.{field} {tuple(a.shape)} on "
                    f"the card differs from the CPU's {tuple(b.shape)} "
                    f"(first at {bad})")
        shapes.append(f"{key} {tuple(res.indices.shape)} k, "
                      f"{tuple(res.candidate_indices.shape)} shortlist")
    return "; ".join(shapes)


def _ex_retrieval(card, dev) -> None:
    cpu = torch.device("cpu")
    for name, run, args in (
            ("quickstart", quickstart.run, (dev, cpu)),
            ("pod_retrieval", pod_retrieval.run,
             [make_test_mesh(data=4, model=2, device=str(d))
              for d in (dev, cpu)])):
        before = ops.launch_counts()
        card_lines, got = _ex_lines(run, args[0])
        counts = _ex_counts(before)
        cpu_lines, want = _ex_lines(run, args[1])
        _ex_same(name, card_lines, cpu_lines)
        held = _ex_same_results(name, got, want)
        log(f"examples {name} ({card}): {len(card_lines)} lines equal the "
            f"CPU's; ids, scores and shortlists equal ({held}); launches "
            f"{counts}")
        for line in card_lines:
            log(f"  {line}")


def _ex_state_errors(got_dir, want_dir, like, step) -> dict[str, float]:
    """{leaf name: error} of the training state saved at `step` under
    got_dir (the card's run) against want_dir's (the CPU's), restored into
    `like`, the state at step 0: an int leaf's error is 0 if equal else
    inf, a float leaf's |got - want| / |want - start| (the bound is on the
    training's updates, as in the CPU tests' STATE_RTOL)."""
    got, _ = restore_checkpoint(got_dir, like, step=step)
    want, _ = restore_checkpoint(want_dir, like, step=step)
    errs = {}
    for (name, a), b, b0 in zip(_tree.named_leaves(got), _tree.leaves(want),
                                _tree.leaves(like), strict=True):
        if not a.dtype.is_floating_point:
            errs[name] = 0.0 if torch.equal(a, b) else float("inf")
            continue
        a, b, b0 = a.double(), b.double(), b0.double()
        errs[name] = float(torch.linalg.norm(a - b)
                           / torch.linalg.norm(b - b0))
    return errs


def _ex_train_smoke(card, dev, root) -> None:
    cfg = train_100m.CFG_SMOKE
    cpu = torch.device("cpu")
    runs = []
    for i, d in enumerate((dev, cpu)):
        params = seeded_params(get_model(cfg).init, 0, d)
        lines, out = _ex_lines(train_100m.run, cfg, params, device=d,
                               ckpt_dir=os.path.join(root, f"smoke_{i}"),
                               **EX_SMOKE)
        runs.append((lines, out["losses"]))
    (card_lines, got), (cpu_lines, want) = runs
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    start = seeded_params(get_model(cfg).init, 0, cpu)
    errs = _ex_state_errors(os.path.join(root, "smoke_0"),
                            os.path.join(root, "smoke_1"),
                            (start, adamw().init(start)), EX_SMOKE["steps"])
    worst = max(errs, key=errs.get)
    log(f"examples train_100m smoke ({card}): {EX_SMOKE}, losses on the "
        f"card {[round(x, 4) for x in got]}, on the CPU "
        f"{[round(x, 4) for x in want]}: max rel err {err:.3g} (limit "
        f"{EX_LOSS_RTOL}); the step-{EX_SMOKE['steps']} state's "
        f"{len(errs)} leaves within {errs[worst]:.3g} of the CPU's, "
        f"relative to its move, at worst {worst} (median "
        f"{statistics.median(errs.values()):.3g}; limit {EX_STATE_RTOL})")
    if not len(got) == len(want) == EX_SMOKE["steps"] \
            or err > EX_LOSS_RTOL or card_lines[0] != cpu_lines[0]:
        raise AssertionError(f"examples train_100m smoke: {card_lines} "
                             f"against {cpu_lines}")
    if errs[worst] > EX_STATE_RTOL:
        raise AssertionError(f"examples train_100m smoke: the state "
                             f"differs from the CPU's: {errs}")


def _ex_train_full(card, dev, root) -> None:
    """train_100m --full on the card: the ~100M model, B = 8 x 128. A step
    is the interval between two batch fetches (each step ends reading its
    loss); the save is the blocking snapshot and the write behind it."""
    cfg = train_100m.CFG_100M
    fetched, snaps, writes = [], [], []

    def timed(fn, store):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            store.append(time.perf_counter() - t0)
            return out
        return call

    def fetch(batch, device):
        fetched.append(time.perf_counter())
        return shard_batch(batch, device)
    params = seeded_params(get_model(cfg).init, 0, dev)
    n = param_count(params)
    with mock.patch.object(train_100m, "shard_batch", fetch), \
            mock.patch.object(ckpt_mod, "_snapshot",
                              timed(ckpt_mod._snapshot, snaps)), \
            mock.patch.object(ckpt_mod, "_write",
                              timed(ckpt_mod._write, writes)):
        lines, out = _ex_lines(train_100m.run, cfg, params,
                               steps=EX_FULL_STEPS, batch=8, seq=128,
                               ckpt_dir=os.path.join(root, "full"),
                               device=dev)
    losses = out["losses"]
    steps = np.diff(fetched)
    p50 = float(np.median(steps))
    state_gb = 3 * n * 4 / 1e9                 # params, mu, nu: float32
    log(f"examples train_100m --full ({card}): {n / 1e6:.1f}M params "
        f"({n}), {EX_FULL_STEPS} steps of B = 8 x 128: p50 step "
        f"{p50 * 1e3:.1f} ms (min {steps.min() * 1e3:.1f}, max "
        f"{steps.max() * 1e3:.1f}), {8 * 128 / p50:.0f} tokens/s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {len(writes)} saves of "
        f"{state_gb:.2f} GB: snapshot {[round(s, 3) for s in snaps]} s, "
        f"write {[round(s, 3) for s in writes]} s "
        f"({state_gb / statistics.median(writes):.2f} GB/s at the median)")
    for line in lines:
        log(f"  {line}")
    if len(losses) != EX_FULL_STEPS or not all(map(math.isfinite, losses)) \
            or losses[-1] >= losses[0]:
        raise AssertionError(f"examples train_100m --full: losses {losses}")


def phase_examples(dev, card: str) -> dict[str, int]:
    """The five examples on the card against the CPU, then train_100m
    --full. Returns the launches of the examples' runs on the card."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="examples_",
                            dir=os.path.join(ROOT, "build"))
    ops.reset_launch_counts()
    try:
        _ex_retrieval(card, dev)
        _ex_agents(card, dev, torch.device("cpu"))
        _ex_train_smoke(card, dev, root)
        _ex_train_full(card, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = ops.launch_counts()
    missing = [k for k in EX_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"examples: no launch of {missing} "
                             f"({launches})")
    torch.cuda.empty_cache()
    log(f"examples path launches ({card}): "
        f"{ {k: n for k, n in launches.items() if n} }")
    log(f"examples ({card}): the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# The two routes redesigned together: #6's resident gather (every cached
# serving turn) and #1 at one shard's rows. Their host time per call split
# into its parts, and #1's device-only time over a sweep of plane sizes at
# each tile. `tools/route_turns.py` measures both routes' whole calls with
# these helpers in a parent's tree and in this one, in turns.
SWEEP_ROWS = (1 << 15, 1 << 16, 131072, 1 << 18, 349526, 1 << 20)


def _host_us(fn, calls: int = HOST_CALLS, rounds: int = 3) -> float:
    """Host microseconds per call of `fn`: `calls` back-to-back calls and
    one synchronize, the median of `rounds` rounds."""
    times = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return round(statistics.median(times), 2)


def _device_us(fn, symbol: str, bound_us: float = 0.0, reps: int = 20,
               rounds: int = 3, spare: int = 3) -> float:
    """Device-only microseconds per launch of the kernels whose name holds
    `symbol`: their time over their count in a torch.profiler trace of
    `reps` calls (a record the trace drops then costs a sample, not a
    zero), the median of `rounds` traces. A trace that holds no such
    kernel, or reads below `bound_us`, the least time the card could take
    for the launch (its bytes at the HBM rate, where they outgrow the L2),
    lost or misplaced records: it is logged, set aside and taken again,
    up to `spare` times; then this raises."""
    fn()
    torch.cuda.synchronize()
    per_launch, misread = [], []
    while len(per_launch) < rounds:
        total = count = 0
        for e in _traced(fn, reps).key_averages():
            if symbol in e.key and e.self_device_time_total > 0:
                total += e.self_device_time_total
                count += e.count
        if count and total / count >= bound_us:
            per_launch.append(total / count)
            continue
        misread.append(f"{total / count:.2f} us per launch" if count
                       else "no launch")
        log(f"device time of {symbol}: a trace of {reps} calls read "
            f"{misread[-1]} against a bound of {bound_us:.2f} us; taken "
            "again")
        if len(misread) > spare:
            raise AssertionError(f"{symbol}: {len(misread)} traces misread "
                                 f"({', '.join(misread)})")
    return round(statistics.median(per_launch), 3)


def _resident_ids(gen, dev, nb: int, s: int) -> torch.Tensor:
    """(B, T_NPROBE * 4) int32 block ids of a resident launch: the first
    half in the arena region [0, nb), the rest in the slab's [nb, nb + s)."""
    j = T_NPROBE * 4
    return torch.cat([
        torch.randint(0, nb, (B, j // 2), generator=gen, device=dev),
        torch.randint(nb, nb + s, (B, j - j // 2), generator=gen,
                      device=dev)], dim=1).to(torch.int32)


def _resident_split(q_msb, plane, ids, br) -> dict[str, float]:
    """Host microseconds per call of each part of the resident gather's
    call, and of the whole call: the query pack the call no longer runs
    (`pack_queries_even_odd`), the Python checks, the route query as the
    wrapper asks it and as one ctypes call, the output's allocation
    (torch.empty, and new_empty, as the wrapper makes it), and the ctypes
    launch alone (a known route, an output made once)."""
    dev = plane.device
    b, (n, d2), j = q_msb.shape[0], plane.shape, ids.shape[1]
    out = torch.empty((b, j * br), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    takes = _build.function("stage1_gather", "stage1_gather_tma_takes",
                            stage1_gather._TAKES_ARGS)
    launch = _build.function("stage1_gather", "stage1_gather_tma_launch",
                             stage1_gather._GATHER_ARGS)

    def checks():
        ops._check_resident(plane, br, "plane")
        stage1_gather._checked(q_msb, plane, ids, br)
    pieces = {
        "pack": lambda: ops.pack_queries_even_odd(q_msb),
        "checks": checks,
        "route query": lambda: stage1_gather._tma_takes(n, d2, br),
        "route query, one ctypes call": lambda: takes(n, d2, br),
        "torch.empty": lambda: torch.empty((b, j * br), dtype=torch.int32,
                                           device=dev),
        "new_empty": lambda: plane.new_empty((b, j * br), dtype=torch.int32),
        "launch alone": lambda: launch(
            q_msb.data_ptr(), plane.data_ptr(), ids.data_ptr(),
            out.data_ptr(), b, n, j, br, d2, stream),
        "whole call": lambda: ops.stage1_scores_gather_resident(
            q_msb, plane, ids, block_rows=br)}
    return {name: _host_us(fn) for name, fn in pieces.items()}


def _plane_split(panel, plane, rows: int = DEFAULT_ROWS) -> dict[str, float]:
    """Host microseconds per call of each part of a #1 call on the
    tensor-core kernel, on a plane small enough (1024 rows) that the card
    never holds the host back: the Python checks, the lane-tile query as
    the wrapper asks it and as one ctypes call, the output's allocation
    (torch.empty and new_empty, as in `_resident_split`), the ctypes
    launch alone, the whole call."""
    dev = plane.device
    b, (n, d2) = panel.shape[1], plane.shape
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lanes = _build.function("stage1_mma", "stage1_mma_lanes",
                            stage1_int4._LANES_ARGS)
    fn = _build.function("stage1_mma", "stage1_mma_launch",
                         stage1_int4._PLANE_ARGS)

    def checks():
        stage1_int4.check_rows(rows)
        stage1_int4._on_cpu(plane)
        stage1_int4._check("q_panel", panel, torch.int8, 3, dev)
        stage1_int4._check("msb_plane", plane, torch.uint8, 2, dev)
        if panel.shape != (2, b, d2) or b > stage1_int4.MAX_GRID_Y:
            raise ValueError("q_panel does not match the plane")
    pieces = {
        "checks": checks,
        "lanes query": lambda: stage1_int4._mma_lanes(b, d2, rows),
        "lanes query, one ctypes call": lambda: lanes(b, d2, rows),
        "torch.empty": lambda: torch.empty((b, n), dtype=torch.int32,
                                           device=dev),
        "new_empty": lambda: plane.new_empty((b, n), dtype=torch.int32),
        "launch alone": lambda: fn(panel.data_ptr(), plane.data_ptr(),
                                   out.data_ptr(), b, n, d2, rows, stream),
        "whole call": lambda: stage1_int4_batched(panel, plane, rows=rows)}
    return {name: _host_us(f) for name, f in pieces.items()}


def _fit(points) -> tuple[float, float]:
    """Least-squares fixed cost (us) and slope (us per row) of (rows, us)
    points."""
    slope, fixed = np.polyfit([p[0] for p in points],
                              [p[1] for p in points], 1)
    return float(fixed), float(slope)


def _plane_sweep(card, q_msb, rounds: int = 1) -> None:
    """#1's device-only time on the tensor-core kernel at B = 32 over
    SWEEP_ROWS plane rows, at every tile the kernel takes (the autotuner
    picks among them), each result equal to the plain version; per tile
    the fit of a fixed cost plus a slope, the slope against the byte rate
    (the plane row read and B int32 scores written). Each time is the
    median of `rounds` traces, none below the launch's bound."""
    dev = q_msb.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    d2 = D // 2
    panel = ops.pack_query_panel(q_msb)
    plane = torch.randint(0, 256, (max(SWEEP_ROWS), d2), generator=gen,
                          device=dev, dtype=torch.uint8)
    want = {n: ref.stage1_scores_batched_ref(panel, plane[:n])
            for n in SWEEP_ROWS}
    byte_ns = (d2 + B * 4) / HBM_BYTES_PER_S * 1e9
    best = {}
    for rows in stage1_int4.ROWS_CHOICES:
        if not stage1_int4._mma_lanes(B, d2, rows):
            continue
        points = []
        for n in SWEEP_ROWS:
            p = plane[:n]

            def fn(p=p, rows=rows):
                return stage1_int4._plane(panel, p, rows, route="mma")
            if not torch.equal(fn(), want[n]):
                raise AssertionError(f"#1 at {n} rows, tile {rows}: differs "
                                     "from its plain version")
            moved = 2 * B * d2 + n * d2 + B * n * 4
            bound_us = (bound_ms(moved, 2 * B * n * D)[0] * 1e3
                        if moved > L2_BYTES else 0.0)
            us = _device_us(fn, "::plane_mma_kernel<", bound_us,
                            rounds=rounds)
            points.append((n, us))
            if us < best.get(n, (None, math.inf))[1]:
                best[n] = (rows, us)
        fixed, slope = _fit(points)
        log(f"kernel stage1_plane_mma sweep tile={rows} ({card}): "
            f"device_only_us " + ", ".join(f"{n}: {us:.2f}"
                                          for n, us in points)
            + f"; fit {fixed:.2f} us + {slope * 1e3:.5f} ns/row (the byte "
            f"rate's {byte_ns:.5f} ns/row: {byte_ns / slope / 10:.0f} %; "
            "bit-exact)")
    log(f"kernel stage1_plane_mma sweep ({card}): fastest tile per rows "
        + ", ".join(f"{n}: {r} ({us:.2f} us)" for n, (r, us) in best.items()))
    del plane, want
    torch.cuda.empty_cache()


# Host cost of the exact wrappers, of the block gather on each of its
# kernels and in the form the engine calls it (the raw nibble query), and
# of #1 on a 1024-row plane: HOST_CALLS back-to-back calls at the main
# path's shapes (B = 32, C = 50, D = 512; one query for the single form;
# one lane and one block for the gathers), one synchronize at the end,
# microseconds per call; beside them torch.bmm and torch.mv, the
# yardsticks' calls. The median of three rounds.
def phase_host_us(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rand(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)
    d2 = D // 2
    msb, lsb = (rand((N, d2), 0, 256, torch.uint8) for _ in range(2))
    q8 = rand((B, 2, d2), -128, 128, torch.int8)
    ids = rand((B, C), 0, N, torch.int32)
    mr, lr = msb[ids.long()], lsb[ids.long()]
    q1, mr1, lr1 = q8[0].contiguous(), mr[0].contiguous(), lr[0].contiguous()
    docs = torch.randn(B, C, D, device=dev, generator=gen)
    col = torch.randn(B, D, 1, device=dev, generator=gen)
    docs1, col1 = docs[0].contiguous(), col[0, :, 0].contiguous()
    # The gathers at one lane and one block: the wrapper's host cost, not
    # the kernel's device time, sets the time per call.
    q_g, ids_g = q8[:1].contiguous(), ids[:1, :1] // BLOCK_ROWS
    qm_g = rand((1, D), -8, 8, torch.int8)
    panel = rand((2, B, d2), -8, 8, torch.int8)
    fns = {"stage2_int8_batched": lambda: stage2_int8_batched(q8, mr, lr),
           "stage2_int8_single": lambda: stage2_int8_single(q1, mr1, lr1),
           "stage2_int8_by_id": lambda: stage2_int8_by_id(q8, msb, lsb, ids),
           "stage1_int4_gather": lambda: stage1_int4_gather(
               q_g, msb, ids_g, block_rows=BLOCK_ROWS),
           "stage1_gather_dp4a": lambda: stage1_gather._gather(
               q_g, msb, ids_g, BLOCK_ROWS, route="dp4a"),
           "ops.stage1_scores_gather": lambda: ops.stage1_scores_gather(
               qm_g, msb, ids_g, block_rows=BLOCK_ROWS),
           "stage1_int4_batched (1024 rows)": lambda: stage1_int4_batched(
               panel, msb[:1024]),
           "torch.bmm": lambda: torch.bmm(docs, col),
           "torch.mv": lambda: torch.mv(docs1, col1)}
    us = {name: _host_us(fn) for name, fn in fns.items()}
    log(f"host_us_per_call ({HOST_CALLS} calls, median of 3 rounds): {us}")
    # The exact stage in one launch beside the parent's stage (the by-id
    # kernel, then the plain rerank), whose cosine form runs ~10 ms a call:
    # it is timed over STAGE_CALLS calls.
    q = rand((B, D), -128, 128, torch.int8)
    norms = rand((N,), 0, 1 << 20, torch.int32)
    db = bitplanar.BitPlanarDB(msb_plane=msb, lsb_plane=lsb, norms_sq=norms,
                               scale=torch.ones((), device=dev))
    stage = {}
    for metric in ("cosine", "mips"):
        stage[f"ops.exact_rerank_by_id ({metric})"] = _host_us(
            lambda: ops.exact_rerank_by_id(q, msb, lsb, ids, norms, k=K,
                                           metric=metric))
        stage[f"parent's stage ({metric})"] = _host_us(
            lambda: _parent_stage(q, db, ids, None, K, metric),
            calls=STAGE_CALLS)
    stage["ops.rerank (cosine)"] = _host_us(
        lambda: ops.rerank(ids, ids, ids, k=K, metric="cosine"))
    log(f"host_us_per_call, the exact stage ({HOST_CALLS} calls; the "
        f"parent's {STAGE_CALLS}; median of 3 rounds): {stage}")
    del msb, lsb, mr, lr, docs, db
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    qdb, db, q_codes, gold = phase_corpus(dev)
    kernels = phase_kernels(db, q_codes, dev)
    launches = phase_main(qdb, db, q_codes, gold, dev)
    sharded_launches, shard_row = phase_sharded_index(db, q_codes, gold, dev,
                                                      card)
    _add_counts(sharded_launches, phase_sharded_serving(qdb, dev, card))
    new_kernels = phase_new_kernels(db, q_codes, gold, dev)
    tune_launches = phase_autotune(qdb, db, q_codes, gold, dev)
    del qdb, db, q_codes, gold
    torch.cuda.empty_cache()
    cluster_launches = phase_cluster(dev)
    serving = _Serving()
    tenancy_launches, served = phase_tenancy(dev, serving)
    kernels += new_kernels + phase_serving(dev, serving, *served)
    del served
    torch.cuda.empty_cache()
    decode_rows, decode_launches = phase_decode(dev)
    rag_launches, rag_sharded = phase_rag(dev, card)
    _add_counts(sharded_launches, rag_sharded)
    train_launches = phase_train(dev, card)
    models_launches = phase_models(dev, card)
    ssm_launches = phase_ssm(dev, card)
    encdec_launches = phase_encdec(dev, card)
    dryrun_launches = phase_dryrun(dev, card)
    phase_train_sharded(card)
    examples_launches = phase_examples(dev, card)
    log(f"sharded path launches ({card}): {sharded_launches}")
    for k in kernels:
        k["launches"] = sum(counts.get(k["name"], 0) for counts in (
            launches, sharded_launches, tune_launches, cluster_launches,
            tenancy_launches, serving.launches, decode_launches,
            rag_launches, train_launches, models_launches, ssm_launches,
            encdec_launches, dryrun_launches, examples_launches))
    kernels += decode_rows + [shard_row]
    phase_host_us(dev)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
