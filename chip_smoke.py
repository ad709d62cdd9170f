#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's retrieval cascades on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. card    — print the card's name and power limit (nvidia-smi).
  2. build   — compile every CUDA kernel from src/repro_torch/csrc.
  3. corpus  — a seeded planted-relevance corpus of N = 2^20 documents x
               D = 512 (512 users x 2048 docs, the paper's 1 MB unit per
               user) built on the card: 256 MiB MSB plane, 256 MiB LSB.
  4. kernels — each kernel against its plain PyTorch version on the card,
               bit-exact, at the main paths' shapes and at ragged shapes
               (every width D % 8 == 0 from 8 to 8192 for the plane, rows
               and exact kernels); times from CUDA events (median of 20
               after warm-up).
  5. main    — B = 32 query batches through `RetrievalEngine.retrieve`
               with the Plain (cosine, MIPS), Masked (512 tenants) and
               Windowed (window 2048) policies on the kernel backend; the
               launch counter of each kernel of the path must grow, every
               result must equal the plain backend's bit for bit, the exact
               scores must equal the INT8 dot products, and recall@5
               against the planted gold is checked.
  6. cluster — the cluster-pruned cascade at full width: a clustered corpus
               of N = 2^20 x D = 512 (1024 clusters of 1024 rows) built on
               the card, its INT8 codebook of cluster means and block table
               (64-row blocks), and B = 32 batches through
               `RetrievalEngine.retrieve` with `ClusterPolicy(nprobe=8)`:
               cosine, MIPS, and cosine with the sign prescreen at
               C0 = 2048; counted, checked against the plain backend and
               the planted gold like the main phase, then freed.

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import bitplanar, clustering, quantization  # noqa: E402
from repro_torch.core.engine import (ClusterPolicy,  # noqa: E402
                                     MaskedPolicy, PlainPolicy,
                                     RetrievalEngine, WindowedPolicy)
from repro_torch.core.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.stage0_sign import stage0_sign_gather  # noqa: E402
from repro_torch.kernels.stage1_gather import (  # noqa: E402
    stage1_int4_gather)
from repro_torch.kernels.stage1_int4 import (stage1_int4_batched,  # noqa: E402
                                             stage1_int4_rows)
from repro_torch.kernels.stage2_int8 import stage2_int8_batched  # noqa: E402

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
MAIN_KERNELS = ("stage1_plane", "stage1_rows", "stage2_exact")
CLUSTER_KERNELS = ("stage1_plane", "stage1_rows", "stage2_exact",
                   "stage1_gather", "stage0_sign_gather")
# Published H100 SXM peaks (NVIDIA data sheet): device memory and dense
# int8 tensor-core rate. Used only for the least-time bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


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


def device_profile(fn, reps: int = 5) -> list[tuple[str, float, float]]:
    """(name, device microseconds per call, launches per call) of every
    GPU kernel `fn` launches, from torch.profiler's CUPTI trace, busiest
    first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / reps, e.count / reps)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def kernel_device_us(fn, symbol: str) -> str:
    """Device-only time of the kernel named `symbol` per call, or "not
    measured" when the trace holds no such kernel."""
    times = [t for name, t, _ in device_profile(fn, reps=20)
             if symbol in name]
    return f"{sum(times):.2f}" if times else "not measured"


def bound_ms(bytes_moved: int, int8_ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"kernel gave {got.dtype}{tuple(got.shape)}, "
                             f"plain {want.dtype}{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def phase_card() -> None:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(out.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        kernel = ""
        for line in text.splitlines():
            entry = re.search(r"((?:plane|rows|sign_gather|gather|exact)"
                              r"_kernel(?:I.*?EE)?)", line)
            if "Compiling entry function" in line and entry:
                kernel = entry.group(1)     # e.g. plane_kernelILi32ELb1ELb0EE
            if "registers" in line or "error" in line.lower():
                log(f"  nvcc {name}: {kernel} {line.strip()}")
    log(f"build: {len(logs)} sources compiled in "
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


def _check_kernel(name, kernel, plain, args, shapes_note) -> int:
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shapes_note}: max abs err {err}")
    return err


def _library_ms(name: str, fn, want: torch.Tensor) -> float:
    """Time one PyTorch library call that computes a kernel's function on
    pre-unpacked operands, after checking that it gives the kernel's
    answer (float32 products are exact here: every partial sum is an
    integer below 2^24, and TF32 is off by default)."""
    got = fn()
    got = (got if got.dtype == torch.int32 else got.to(torch.int32)).reshape(
        want.shape)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the library yardstick disagrees with "
                             "the kernel")
    return time_ms(fn)


def phase_kernels(db, q_codes, dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = q_codes[:B]
    q_msb = quantization.msb_nibble(q)
    d2 = D // 2
    rows = []

    # -- plane: the shared-plane stage-1 scan ------------------------------
    panel = ops.pack_query_panel(q_msb)
    err = _check_kernel("stage1_plane", stage1_int4_batched,
                        ref.stage1_scores_batched_ref, (panel, db.msb_plane),
                        f"B={B} N={N} D={D}")
    for bb, nn, dd in ((1, 1000, 512), (3, 4099, 256), (33, 777, 512),
                       (17, 256, 128)):
        p = torch.randint(0, 256, (nn, dd // 2), generator=gen, device=dev,
                          dtype=torch.uint8)
        qp = torch.randint(-8, 8, (2, bb, dd // 2), generator=gen,
                           device=dev, dtype=torch.int8)
        _check_kernel("stage1_plane", stage1_int4_batched,
                      ref.stage1_scores_batched_ref, (qp, p),
                      f"B={bb} N={nn} D={dd}")
    unpacked = bitplanar.unpack_nibble_plane_signed(db.msb_plane)
    unpacked_t = unpacked.t()
    q_int8 = q_msb.contiguous()
    lib_ms = _library_ms("stage1_plane",
                         lambda: torch._int_mm(q_int8, unpacked_t),
                         stage1_int4_batched(panel, db.msb_plane))
    del unpacked, unpacked_t
    t_bound, by = bound_ms(2 * B * d2 + N * d2 + B * N * 4, 2 * B * N * D)
    rows.append(dict(
        name="stage1_plane", route="cuda",
        source="src/repro_torch/csrc/stage1_int4.cu",
        replaces="src/repro/kernels/stage1_int4.py:79",
        max_abs_err=err,
        ms=time_ms(lambda: stage1_int4_batched(panel, db.msb_plane)),
        plain_ms=time_ms(lambda: ref.stage1_scores_batched_ref(
            panel, db.msb_plane)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

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
        source="src/repro_torch/csrc/stage1_int4.cu",
        replaces="src/repro/kernels/stage1_int4.py:120",
        max_abs_err=err,
        ms=time_ms(lambda: stage1_int4_rows(q_eo, win)),
        plain_ms=time_ms(lambda: ref.stage1_rows_batched_ref(q_eo, win)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

    # -- exact: INT8 rescore of gathered candidates ------------------------
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

    _check_widths(gen, dev)

    # -- gather: stage 1 over the cluster path's per-lane block tables -----
    ids = _cluster_like_ids(gen, dev)
    j = ids.shape[1]
    r_view = j * BLOCK_ROWS
    view = bitplanar.expand_block_rows(ids, BLOCK_ROWS)
    uniq_rows = int(torch.unique(view[view < N]).numel())

    def gather(qe, plane, block_ids):
        return stage1_int4_gather(qe, plane, block_ids,
                                  block_rows=BLOCK_ROWS)

    def gather_plain(qe, plane, block_ids):
        return ref.stage1_gather_batched_ref(qe, plane, block_ids, BLOCK_ROWS)

    err = _check_kernel("stage1_gather", gather, gather_plain,
                        (q_eo, db.msb_plane, ids),
                        f"B={B} J={j} BR={BLOCK_ROWS} D={D}")
    for bb, nn, dd, br in ((1, 1000, 64, 64), (3, 4099, 200, 8),
                           (33, 777, 512, 32), (3, 300, 512, 64)):
        p = torch.randint(0, 256, (nn, dd // 2), generator=gen, device=dev,
                          dtype=torch.uint8)
        qe = torch.randint(-8, 8, (bb, 2, dd // 2), generator=gen,
                           device=dev, dtype=torch.int8)
        _check_kernel("stage1_gather",
                      lambda a, b_, c: stage1_int4_gather(a, b_, c,
                                                          block_rows=br),
                      lambda a, b_, c: ref.stage1_gather_batched_ref(
                          a, b_, c, br),
                      (qe, p, _ragged_ids(gen, dev, bb, nn, br)),
                      f"B={bb} N={nn} D={dd} BR={br}")
    gathered, _ = bitplanar.gather_blocks(db.msb_plane, ids, BLOCK_ROWS)
    gat_f = bitplanar.unpack_nibble_plane_signed(
        gathered.reshape(B * r_view, d2)).reshape(B, r_view, D).float()
    lib_ms = _library_ms("stage1_gather", lambda: torch.bmm(gat_f, q_col),
                         gather(q_eo, db.msb_plane, ids))
    del gathered, gat_f
    t_bound, by = bound_ms(2 * B * d2 + B * j * 4 + uniq_rows * d2
                           + B * r_view * 4, 2 * B * r_view * D)
    rows.append(dict(
        name="stage1_gather", route="cuda",
        source="src/repro_torch/csrc/stage1_int4.cu",
        replaces="src/repro/kernels/stage1_gather.py:65",
        max_abs_err=err,
        ms=time_ms(lambda: gather(q_eo, db.msb_plane, ids)),
        plain_ms=time_ms(lambda: gather_plain(q_eo, db.msb_plane, ids)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

    # -- sign gather: the prescreen over the same block tables -------------
    q_sign = ops.pack_query_signs(q)
    d8 = D // 8

    def sign(qs, plane, block_ids):
        return stage0_sign_gather(qs, plane, block_ids,
                                  block_rows=BLOCK_ROWS)

    def sign_plain(qs, plane, block_ids):
        return ref.stage0_sign_gather_ref(qs, plane, block_ids, BLOCK_ROWS)

    err = _check_kernel("stage0_sign_gather", sign, sign_plain,
                        (q_sign, db.sign_plane, ids),
                        f"B={B} J={j} BR={BLOCK_ROWS} D={D}")
    for bb, nn, dd, br in ((1, 1000, 64, 64), (3, 4099, 200, 8),
                           (33, 777, 512, 32), (3, 300, 40, 64)):
        p = torch.randint(0, 256, (nn, dd // 8), generator=gen, device=dev,
                          dtype=torch.uint8)
        qs = ops.pack_query_signs(torch.randint(
            -128, 128, (bb, dd), generator=gen, device=dev,
            dtype=torch.int8))
        _check_kernel("stage0_sign_gather",
                      lambda a, b_, c: stage0_sign_gather(a, b_, c,
                                                          block_rows=br),
                      lambda a, b_, c: ref.stage0_sign_gather_ref(
                          a, b_, c, br),
                      (qs, p, _ragged_ids(gen, dev, bb, nn, br)),
                      f"B={bb} N={nn} D={dd} BR={br}")
    gathered, _ = bitplanar.gather_blocks(db.sign_plane, ids, BLOCK_ROWS)
    sgn_f = bitplanar.unpack_sign_pm1(gathered).float()          # (B, R, D)
    q_sign_col = q_sign.float()[:, :, None]
    lib_ms = _library_ms("stage0_sign_gather",
                         lambda: torch.bmm(sgn_f, q_sign_col),
                         sign(q_sign, db.sign_plane, ids))
    del gathered, sgn_f
    t_bound, by = bound_ms(B * D + B * j * 4 + uniq_rows * d8
                           + B * r_view * 4, 2 * B * r_view * D)
    rows.append(dict(
        name="stage0_sign_gather", route="cuda",
        source="src/repro_torch/csrc/stage0_sign.cu",
        replaces="src/repro/kernels/stage0_sign.py:113",
        max_abs_err=err,
        ms=time_ms(lambda: sign(q_sign, db.sign_plane, ids)),
        plain_ms=time_ms(lambda: sign_plain(q_sign, db.sign_plane, ids)),
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms))

    device_only = {
        "stage1_plane": kernel_device_us(
            lambda: stage1_int4_batched(panel, db.msb_plane), "plane_kernel"),
        "stage1_rows": kernel_device_us(
            lambda: stage1_int4_rows(q_eo, win), "rows_kernel"),
        "stage2_exact": kernel_device_us(
            lambda: stage2_int8_batched(q_eo8, msb_rows, lsb_rows),
            "exact_kernel"),
        "stage1_gather": kernel_device_us(
            lambda: gather(q_eo, db.msb_plane, ids), "gather_kernel"),
        "stage0_sign_gather": kernel_device_us(
            lambda: sign(q_sign, db.sign_plane, ids), "sign_gather_kernel"),
    }
    for r in rows:
        note = (" (library yardstick: one torch.bmm on the pre-gathered, "
                "pre-unpacked operand; it leaves out the gather)"
                if r["name"] in ("stage1_gather", "stage0_sign_gather")
                else "")
        log(f"kernel {r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_us {r['bound_ms'] * 1e3:.2f} "
            f"({r['bound_by']}) library_ms {r['library_ms']} "
            f"device_only_us {device_only[r['name']]}{note}")
    log(f"kernel gathers: {uniq_rows} distinct plane rows of the "
        f"{B * r_view} gathered at B={B} J={j} BR={BLOCK_ROWS}")
    return rows


WIDTHS = (8, 64, 200, 1536, 8192)


def _check_widths(gen, dev) -> None:
    """The plane, rows and exact kernels at every kind of width: one
    partial 64-byte chunk (D = 8, 200), 16-byte loads (64, 1536, 8192), and
    shared-memory panels past the 48 KiB default (8192, where the plane
    kernel's lane tile also shrinks; B = 40 spans more than one tile)."""
    for dd in WIDTHS:
        d2 = dd // 2
        for bb in (1, 5) + ((40,) if dd == 8192 else ()):
            p = torch.randint(0, 256, (1000, d2), generator=gen, device=dev,
                              dtype=torch.uint8)
            qp = torch.randint(-8, 8, (2, bb, d2), generator=gen, device=dev,
                               dtype=torch.int8)
            _check_kernel("stage1_plane", stage1_int4_batched,
                          ref.stage1_scores_batched_ref, (qp, p),
                          f"B={bb} N=1000 D={dd}")
            r = torch.randint(0, 256, (bb, 77, d2), generator=gen,
                              device=dev, dtype=torch.uint8)
            qe = torch.randint(-8, 8, (bb, 2, d2), generator=gen, device=dev,
                               dtype=torch.int8)
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
    log(f"widths: plane, rows and exact kernels bit-exact at D in {WIDTHS} "
        "(B = 1, 5; B = 40 at D = 8192)")


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
    with the launch counts set to 0 just before and read just after; then
    hold every batch to the plain backend, the exact INT8 dot products and
    the planted gold, and profile one batch of each variant."""
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
    del qdb, db, q_codes, gold, codebook, policy, variants
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    phase_card()
    phase_build()
    qdb, db, q_codes, gold = phase_corpus(dev)
    kernels = phase_kernels(db, q_codes, dev)
    launches = phase_main(qdb, db, q_codes, gold, dev)
    del qdb, db, q_codes, gold
    torch.cuda.empty_cache()
    cluster_launches = phase_cluster(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]] + cluster_launches[k["name"]]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
