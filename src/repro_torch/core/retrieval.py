"""Quantization-aware two-stage hierarchical retrieval (the paper's core).

Port of `repro.core.retrieval`. Stage 1 scores every document on the MSB
nibbles only (the packed MSB plane, half the bytes) and keeps a candidate
set; stage 2 gathers the candidates' full INT8 codes, rescores them
exactly and ranks the final top-k with the non-division comparator
(cosine) or the raw integer scores (MIPS). The candidate budget is
``min(max_candidates, ceil(candidate_frac * N))``, at least k.

Every engine-backed variant here is a thin wrapper that builds a policy
and runs the one batched cascade in `repro_torch.core.engine`.
`backend="torch"` runs the plain PyTorch stage functions; `backend="cuda"`
runs the kernel wrappers in `repro_torch.kernels.ops`, which launch the
hand-written CUDA kernels on CUDA tensors and fall back to the same plain
functions only for tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from repro_torch.core import bitplanar, quantization, similarity


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    k: int = 5
    metric: Literal["cosine", "mips"] = "cosine"
    max_candidates: int = 50
    candidate_frac: float = 0.2
    backend: Literal["torch", "cuda"] = "cuda"
    # Stage-0 sign-plane prescreen budget of the cluster-pruned cascade:
    # a 1-bit scan keeps the top-C0 rows of each lane's probed view
    # (clamped to [k, view rows]) before the INT4 scan. None disables it.
    prescreen_c0: int | None = None

    def num_candidates(self, num_docs: int) -> int:
        return max(self.k, min(self.max_candidates,
                               math.ceil(self.candidate_frac * num_docs)))

    def prescreen_budget(self, view_rows: int) -> int | None:
        """Effective stage-0 survivor count for a `view_rows`-row view."""
        if self.prescreen_c0 is None:
            return None
        return max(self.k, min(self.prescreen_c0, view_rows))


@dataclasses.dataclass(frozen=True)
class RetrievalResult:
    indices: torch.Tensor            # (k,) or (B, k) global ids, best first
    scores: torch.Tensor             # exact int32 dot products
    candidate_indices: torch.Tensor  # stage-1 candidate ids (diagnostics)


# Sentinel tenant id that matches no arena slot (free slots use -1).
NO_TENANT = -2


# ---------------------------------------------------------------------------
# Single-query stage primitives and the paper's baselines
# ---------------------------------------------------------------------------

def stage1_scores(q_msb: torch.Tensor, msb_plane: torch.Tensor) -> torch.Tensor:
    """Approximate MIPS on MSB nibbles: q_msb (D,) int8 in [-8, 7],
    msb_plane (N, D//2) uint8 -> (N,) int32 (lo . q_even + hi . q_odd)."""
    lo, hi = bitplanar.split_nibbles_signed(msb_plane)
    return (similarity.int_matvec(lo, q_msb[0::2])
            + similarity.int_matvec(hi, q_msb[1::2]))


def _single_stage(scores: torch.Tensor, norms_sq: torch.Tensor,
                  cfg: RetrievalConfig) -> RetrievalResult:
    key = (similarity.cosine_key_f32(scores, norms_sq)
           if cfg.metric == "cosine" else scores)
    _, idx = similarity.stable_topk(key, cfg.k)
    return RetrievalResult(indices=idx, scores=scores[idx],
                           candidate_indices=idx)


def exact_retrieve(query_codes: torch.Tensor, db: quantization.QuantizedDB,
                   cfg: RetrievalConfig) -> RetrievalResult:
    """Single-stage full-precision INT8 retrieval (the paper's baseline)."""
    return _single_stage(similarity.int_matvec(db.values, query_codes),
                         db.norms_sq, cfg)


def int4_retrieve(query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
                  cfg: RetrievalConfig) -> RetrievalResult:
    """Pure-INT4 baseline: rank on MSB-nibble scores (no stage 2)."""
    approx = stage1_scores(quantization.msb_nibble(query_codes),
                           db.msb_plane)
    return _single_stage(approx, db.norms_sq, cfg)


# ---------------------------------------------------------------------------
# Engine-backed retrieval variants
# ---------------------------------------------------------------------------

def two_stage_retrieve(query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
                       cfg: RetrievalConfig, *, device=None
                       ) -> RetrievalResult:
    """One (D,) int8 query over one DB: a B=1 lane of the batched engine."""
    return _engine.RetrievalEngine(cfg, device).retrieve_single(
        query_codes, db)


def batched_retrieve(query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
                     cfg: RetrievalConfig, *, device=None
                     ) -> RetrievalResult:
    """(B, D) int8 queries -> batched RetrievalResult; stage 1 streams the
    MSB plane once for the whole batch."""
    return _engine.RetrievalEngine(cfg, device).retrieve(query_codes, db)


def two_stage_retrieve_masked(query_codes: torch.Tensor,
                              db: bitplanar.BitPlanarDB, owner: torch.Tensor,
                              tenant_id, cfg: RetrievalConfig, *,
                              device=None) -> RetrievalResult:
    """One (D,) int8 query restricted to one tenant's arena rows: a B=1
    lane of the masked batched engine over the whole arena. Rows with
    ``owner != tenant_id`` are never returned; positions the tenant cannot
    fill come back as -1 with score 0."""
    tids = torch.as_tensor(tenant_id, dtype=torch.int32,
                           device=owner.device).reshape(1)
    policy = _engine.MaskedPolicy(owner=owner, tenant_ids=tids)
    return _engine.RetrievalEngine(cfg, device).retrieve_single(
        query_codes, db, policy)


def batched_retrieve_masked(query_codes: torch.Tensor,
                            db: bitplanar.BitPlanarDB, owner: torch.Tensor,
                            tenant_ids: torch.Tensor, cfg: RetrievalConfig,
                            *, device=None) -> RetrievalResult:
    """Cross-tenant batch over a shared arena: lane i sees only rows with
    ``owner == tenant_ids[i]`` (negative ids see nothing). Returned ids
    are arena slots; unfillable positions come back as -1 with score 0."""
    policy = _engine.MaskedPolicy(owner=owner,
                                  tenant_ids=tenant_ids.to(torch.int32))
    return _engine.RetrievalEngine(cfg, device).retrieve(query_codes, db,
                                                         policy)


def windowed_retrieve_masked(query_codes: torch.Tensor,
                             db: bitplanar.BitPlanarDB, owner: torch.Tensor,
                             tenant_ids: torch.Tensor, starts: torch.Tensor,
                             cfg: RetrievalConfig, window: int, *,
                             device=None) -> RetrievalResult:
    """Cross-tenant batch over a tenant-contiguous arena: lane i streams
    only the `window` rows at ``starts[i]`` (window >= cfg.k), masked like
    the full scan."""
    policy = _engine.WindowedPolicy(owner=owner,
                                    tenant_ids=tenant_ids.to(torch.int32),
                                    starts=starts, window=window)
    return _engine.RetrievalEngine(cfg, device).retrieve(query_codes, db,
                                                         policy)


def cluster_pruned_retrieve(query_codes: torch.Tensor,
                            db: bitplanar.BitPlanarDB, codebook,
                            cluster_blocks, labels, cfg: RetrievalConfig, *,
                            nprobe: int, block_rows: int,
                            owner: torch.Tensor | None = None,
                            tenant_ids: torch.Tensor | None = None,
                            device=None) -> RetrievalResult:
    """The cluster-pruned cascade over one DB: (B, D) int8 queries.

    Stage 0 scores the `codebook`'s K centroids
    (`repro_torch.core.clustering.ClusterCodebook`) and keeps each lane's
    top-`nprobe` clusters; stage 1 reads only those clusters' row blocks
    (`cluster_blocks` from `clustering.block_table`, (K, MB) or per lane
    (B, K, MB); `labels` maps each row to its cluster, so a row is seen
    only through its own cluster's entry); stage 2 rescores exactly.
    `cluster_blocks` and `labels` may be numpy (they are put on the
    engine's device). Single-corpus callers omit owner/tenant_ids (every
    gathered row is visible); arena callers pass both."""
    eng = _engine.RetrievalEngine(cfg, device)
    b, n = query_codes.shape[0], db.num_docs
    if (owner is None) != (tenant_ids is None):
        raise ValueError("owner and tenant_ids must be passed together "
                         "(segment masking needs both) or both omitted "
                         "(single corpus: every row visible)")
    if owner is None:
        owner = torch.zeros((n,), dtype=torch.int32, device=eng.device)
        tenant_ids = torch.zeros((b,), dtype=torch.int32, device=eng.device)
    policy = _engine.ClusterPolicy(
        owner=owner, tenant_ids=tenant_ids.to(torch.int32),
        labels=_int32_on(labels, eng.device),
        centroid_msb=codebook.msb_plane, centroid_norms=codebook.norms_sq,
        cluster_blocks=_int32_on(cluster_blocks, eng.device),
        nprobe=nprobe, block_rows=block_rows)
    return eng.retrieve(query_codes, db, policy)


def _int32_on(x, device: torch.device) -> torch.Tensor:
    """An int32 tensor: a tensor keeps its device (the engine checks it),
    numpy input is put on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.from_numpy(np.array(x, np.int32, copy=True)).to(device)


# Bottom import: engine imports the config/result types above.
from repro_torch.core import engine as _engine                # noqa: E402
