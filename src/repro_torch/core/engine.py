"""Batch-native retrieval engine: one staged cascade behind every variant.

Port of the two-stage part of `repro.core.engine`, layered as:

  policy   — which rows each batch lane may touch, as data: `PlainPolicy`
             (every row), `MaskedPolicy` (rows whose arena owner matches
             the lane's tenant), `WindowedPolicy` (a per-lane contiguous
             arena window).
  schedule — the cascade `(ApproxScan, ExactRescore)`: a batched INT4 scan
             of the MSB plane with a per-lane top-C, then a batched INT8
             gather, exact rescore and metric rerank.
  backend  — the batched stage primitives, chosen by
             `RetrievalConfig.backend`: "torch" (plain PyTorch) or "cuda"
             (the kernel wrappers of `repro_torch.kernels.ops`). Both are
             exact integer arithmetic and agree bit for bit.

`SchedulePlan` carries the exact analytic byte counts of one launch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal

import torch

from repro_torch._device import resolve_device
from repro_torch.core import bitplanar, quantization, similarity
from repro_torch.core.retrieval import RetrievalConfig, RetrievalResult

INT32_MIN = -(2 ** 31)

# Stage-2 score of out-of-segment candidates: most-negative-plus-one, so
# s*s stays inside the comparator's limbs and every in-segment row (even
# with a negative score) orders strictly above it.
MASKED_SCORE = -(2 ** 31 - 1)


# ---------------------------------------------------------------------------
# Membership / window policies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlainPolicy:
    """Every row visible to every lane (the single-corpus case)."""


@dataclasses.dataclass(frozen=True)
class MaskedPolicy:
    """Lane i sees exactly the rows with ``owner == tenant_ids[i]``.

    owner: (N,) int32 slot -> tenant map (free slots hold -1).
    tenant_ids: (B,) int32; negative ids match nothing.
    """

    owner: torch.Tensor
    tenant_ids: torch.Tensor


@dataclasses.dataclass(frozen=True)
class WindowedPolicy:
    """MaskedPolicy restricted to one contiguous window per lane: lane i
    streams only the `window` rows at ``starts[i]`` (clamped into the
    arena); rows of the window outside the segment are masked like the
    full scan. `window` must be >= cfg.k and <= N."""

    owner: torch.Tensor
    tenant_ids: torch.Tensor
    starts: torch.Tensor
    window: int


Policy = PlainPolicy | MaskedPolicy | WindowedPolicy


# ---------------------------------------------------------------------------
# Batched stage primitives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageFns:
    """The cascade's batched primitives for one backend.

    plane: stage-1 shared-plane scan   (B, D) x (N, D/2)    -> (B, N)
    rows:  stage-1 per-lane rows       (B, D) x (B, W, D/2) -> (B, W)
    exact: stage-2 INT8 rescore        (B, D) x 2 (B, C, D/2) -> (B, C)
    """

    plane: Callable
    rows: Callable
    exact: Callable


def stage_fns(backend: str) -> StageFns:
    """"cuda": the kernel wrappers; "torch": the same query packing feeding
    the kernels' plain versions in `kernels.ref` on any device."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    if backend == "cuda":
        return StageFns(plane=kops.stage1_scores_batched,
                        rows=kops.stage1_scores_rows,
                        exact=kops.stage2_scores_batched)
    if backend == "torch":
        return StageFns(
            plane=lambda q_msb, plane: ref.stage1_scores_batched_ref(
                kops.pack_query_panel(q_msb), plane),
            rows=lambda q_msb, rows: ref.stage1_rows_batched_ref(
                kops.pack_queries_even_odd(q_msb), rows),
            exact=lambda q, msb, lsb: ref.stage2_scores_batched_ref(
                kops.pack_queries_even_odd(q), msb, lsb))
    raise ValueError(f"unknown backend {backend!r}: 'torch' or 'cuda'")


# ---------------------------------------------------------------------------
# The cascade schedule
# ---------------------------------------------------------------------------

def _vslice(arr: torch.Tensor, starts: torch.Tensor,
            window: int) -> torch.Tensor:
    """Per-lane windows: (N, ...) x (B,) starts -> (B, window, ...)."""
    rows = starts.long()[:, None] + torch.arange(window, device=arr.device)
    return arr[rows]


def _candidate_budget(cfg: RetrievalConfig, num_docs: int,
                      view_rows: int | None) -> int:
    """Stage-2 budget C, clamped to a restricted view's rows (then every
    visible row is a candidate and the view is rescored exhaustively)."""
    c = cfg.num_candidates(num_docs)
    if view_rows is not None:
        c = min(c, view_rows)
    return c


def _membership(owner: torch.Tensor, tenant_ids: torch.Tensor) -> torch.Tensor:
    """(.., R) owner view x (B,) tenants -> (B, R) visibility mask."""
    return (owner == tenant_ids[:, None]) & (tenant_ids >= 0)[:, None]


@dataclasses.dataclass
class _CascadeState:
    """What the stages refine: which rows are still alive.

    rows: (B, C) global candidate row ids after ApproxScan.
    member: visibility mask aligned with `rows` (None = all visible).
    result: the final RetrievalResult, set by the terminal stage.
    """

    rows: torch.Tensor | None = None
    member: torch.Tensor | None = None
    result: RetrievalResult | None = None


@dataclasses.dataclass
class _CascadeCtx:
    """Per-launch invariants every stage reads."""

    query_codes: torch.Tensor
    q_msb: torch.Tensor
    db: bitplanar.BitPlanarDB
    policy: Policy
    cfg: RetrievalConfig
    fns: StageFns


@dataclasses.dataclass(frozen=True)
class ApproxScan:
    """Stage 1: batched INT4 MSB scan of the policy's row view, then a
    per-lane candidate top-C."""

    def run(self, state: _CascadeState, ctx: _CascadeCtx) -> _CascadeState:
        db, policy, cfg = ctx.db, ctx.policy, ctx.cfg
        n = db.num_docs
        member = None
        base = None
        if isinstance(policy, WindowedPolicy):
            if policy.window < cfg.k:
                raise ValueError(f"window {policy.window} < k={cfg.k}: "
                                 "top-k over a window needs window >= k")
            if policy.window > n:
                raise ValueError(f"window {policy.window} exceeds the "
                                 f"{n}-row arena")
            c = _candidate_budget(cfg, n, policy.window)
            starts = torch.clamp(policy.starts, 0,
                                 max(n - policy.window, 0)).to(torch.int32)
            msb_view = _vslice(db.msb_plane, starts, policy.window)
            norms = _vslice(db.norms_sq, starts, policy.window)
            member = _membership(_vslice(policy.owner, starts, policy.window),
                                 policy.tenant_ids)
            scores = ctx.fns.rows(ctx.q_msb, msb_view)         # (B, W) int32
            base = starts[:, None]
        else:
            c = _candidate_budget(cfg, n, None)
            scores = ctx.fns.plane(ctx.q_msb, db.msb_plane)    # (B, N) int32
            norms = db.norms_sq[None, :]
            if isinstance(policy, MaskedPolicy):
                member = _membership(policy.owner[None, :],
                                     policy.tenant_ids)

        if cfg.metric == "cosine":
            # Tombstoned rows carry norm 0 (key 0), so even an inconsistent
            # membership mask cannot let a dead row win.
            key1 = similarity.cosine_key_f32(scores, norms)
            if member is not None:
                key1 = key1.masked_fill(~member, float("-inf"))
        else:
            key1 = (scores if member is None
                    else scores.masked_fill(~member, INT32_MIN))
        _, cand_local = similarity.stable_topk(key1, c)        # (B, C) view
        cand = (cand_local if base is None else cand_local + base)
        cand = cand.to(torch.int32)
        cand_member = (None if member is None
                       else torch.gather(member, 1, cand_local))
        return dataclasses.replace(state, rows=cand, member=cand_member)


@dataclasses.dataclass(frozen=True)
class ExactRescore:
    """Terminal stage: gather the candidates' full INT8 codes, rescore
    exactly, rerank (non-division comparator for cosine, top-k for MIPS)."""

    def run(self, state: _CascadeState, ctx: _CascadeCtx) -> _CascadeState:
        db, cfg = ctx.db, ctx.cfg
        cand, cand_member = state.rows, state.member
        # Candidates are gathered from the full planes by global id; holes
        # clamp to row 0 and are pinned below every real candidate by the
        # membership mask.
        safe = torch.clamp(cand, min=0).long()
        msb_rows = db.msb_plane[safe]                          # (B, C, D//2)
        lsb_rows = db.lsb_plane[safe]
        exact = ctx.fns.exact(ctx.query_codes, msb_rows, lsb_rows)
        cand_norms = db.norms_sq[safe]
        if cand_member is not None:
            exact = exact.masked_fill(~cand_member, MASKED_SCORE)
            cand_norms = cand_norms.masked_fill(~cand_member, 1)

        if cfg.metric == "cosine":
            local, top_scores = similarity.rerank_dense_comparator(
                exact, cand_norms, cfg.k)
        else:
            top_scores, local = similarity.stable_topk(exact, cfg.k)

        indices = torch.gather(cand, 1, local)
        if cand_member is None:
            result = RetrievalResult(indices=indices, scores=top_scores,
                                     candidate_indices=cand)
        else:
            valid = torch.gather(cand_member, 1, local)
            result = RetrievalResult(
                indices=indices.masked_fill(~valid, -1),
                scores=top_scores.masked_fill(~valid, 0),
                candidate_indices=cand.masked_fill(~cand_member, -1))
        return dataclasses.replace(state, result=result)


def cascade_stages(policy: Policy, cfg: RetrievalConfig) -> tuple:
    """The stage specs one launch runs: the paper's two-stage cascade."""
    if not isinstance(policy, (PlainPolicy, MaskedPolicy, WindowedPolicy)):
        raise TypeError(f"policy {type(policy).__name__} is not ported")
    return (ApproxScan(), ExactRescore())


def _run_cascade(query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
                 policy: Policy, cfg: RetrievalConfig) -> _CascadeState:
    ctx = _CascadeCtx(query_codes=query_codes,
                      q_msb=quantization.msb_nibble(query_codes),
                      db=db, policy=policy, cfg=cfg,
                      fns=stage_fns(cfg.backend))
    state = _CascadeState()
    for stage in cascade_stages(policy, cfg):
        state = stage.run(state, ctx)
    return state


def retrieve_batched(query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
                     policy: Policy, cfg: RetrievalConfig) -> RetrievalResult:
    """The one batched cascade entry point: (B, D) int8 queries -> a batched
    RetrievalResult of global row ids (-1 where a masked lane cannot fill
    a position)."""
    return _run_cascade(query_codes, db, policy, cfg).result


# ---------------------------------------------------------------------------
# Schedule planning (host-side, analytic)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One cascade stage's exact analytic ledger for one batched launch.

    rows is per lane; bytes_hbm the plane bytes the launch streams from
    device memory for this stage; bytes_sram the bytes served on-chip
    instead; bits the operand width of the MACs; compares the per-lane
    comparisons of the stage's select or rerank."""

    name: str
    rows: int
    bits: int
    bytes_hbm: int
    compares: int
    bytes_sram: int = 0


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """What one batched launch streams, computed exactly (no timers)."""

    kind: Literal["plain", "masked", "windowed", "cluster", "view", "decode"]
    batch: int
    rows_scanned: int          # stage-1 rows per lane (N, window, or probe)
    candidates: int            # stage-2 budget C per lane
    stage1_bytes: int          # MSB-plane bytes the batched scan streams
    stage1_bytes_vmapped: int  # the one-query-at-a-time path, for comparison
    stage2_bytes: int          # gathered candidate rows (MSB+LSB planes)
    stages: tuple[StagePlan, ...] = ()
    stage1_bytes_sram: int = 0  # stage-1 bytes served from an on-chip cache

    def publish(self, registry) -> None:
        """Fan the per-stage ledger out to a metrics registry (anything
        with ``enabled`` and ``counter(name, **labels).inc(v)``)."""
        if not getattr(registry, "enabled", False):
            return
        for st in self.stages:
            registry.counter("stage_rows", stage=st.name).inc(
                st.rows * self.batch)
            registry.counter("stage_bytes_hbm", stage=st.name).inc(
                st.bytes_hbm)
            if st.bytes_sram:
                registry.counter("stage_bytes_sram", stage=st.name).inc(
                    st.bytes_sram)
            registry.counter("stage_compares", stage=st.name).inc(
                st.compares * self.batch)


def plan(cfg: RetrievalConfig, *, num_docs: int, dim: int, batch: int,
         kind: str = "plain", window: int | None = None,
         num_clusters: int | None = None,
         view_rows: int | None = None) -> SchedulePlan:
    """Analytic schedule for one launch of the engine (the reference's
    `plan`, every kind included): plain/masked stream the plane once per
    batch, windowed lanes their own window, cluster lanes their gathered
    probe rows after a pass over the centroid plane."""
    d2 = dim // 2
    if kind == "windowed":
        if window is None:
            raise ValueError("windowed plan needs a window")
        rows = min(window, num_docs)
        s1 = batch * rows * d2
        s1_vmapped = s1
        c = _candidate_budget(cfg, num_docs, window)
        stages = ()
    elif kind == "cluster":
        if num_clusters is None or view_rows is None:
            raise ValueError("cluster plan needs num_clusters and view_rows")
        rows = view_rows
        s1 = batch * rows * d2
        s1_vmapped = batch * num_docs * d2
        c = _candidate_budget(cfg, num_docs, view_rows)
        stages = (StagePlan(name="prune", rows=num_clusters, bits=4,
                            bytes_hbm=num_clusters * d2,
                            compares=num_clusters),)
        c0 = cfg.prescreen_budget(view_rows)
        if c0 is not None:
            stages += (StagePlan(name="prescreen", rows=view_rows, bits=1,
                                 bytes_hbm=batch * view_rows * (dim // 8),
                                 compares=view_rows),)
            rows = c0
            s1 = batch * c0 * d2
            c = _candidate_budget(cfg, num_docs, c0)
    elif kind == "view":
        if view_rows is None:
            raise ValueError("view plan needs view_rows")
        rows = view_rows
        s1 = batch * rows * d2
        s1_vmapped = batch * num_docs * d2
        c = _candidate_budget(cfg, num_docs, view_rows)
        stages = ()
    else:
        if window is not None:
            raise ValueError(f"{kind} plan does not take a window")
        rows = num_docs
        s1 = rows * d2
        s1_vmapped = batch * s1
        c = _candidate_budget(cfg, num_docs, None)
        stages = ()
    s2 = batch * c * dim
    stages += (StagePlan(name="approx", rows=rows, bits=4, bytes_hbm=s1,
                         compares=rows),
               StagePlan(name="exact", rows=c, bits=8, bytes_hbm=s2,
                         compares=c * c))
    return SchedulePlan(kind=kind, batch=batch, rows_scanned=rows,
                        candidates=c, stage1_bytes=s1,
                        stage1_bytes_vmapped=s1_vmapped,
                        stage2_bytes=s2, stages=stages)


def cache_split_plan(base: SchedulePlan, *, hbm_bytes: int,
                     sram_bytes: int,
                     prescreen_hbm: int | None = None,
                     prescreen_sram: int = 0) -> SchedulePlan:
    """Re-ledger a launch's approx stage (and optionally its prescreen)
    for a measured split between device-memory misses and on-chip hits;
    row and compare counts are untouched."""
    def _rewrite(s: StagePlan) -> StagePlan:
        if s.name == "approx":
            return dataclasses.replace(s, bytes_hbm=hbm_bytes,
                                       bytes_sram=sram_bytes)
        if s.name == "prescreen" and prescreen_hbm is not None:
            return dataclasses.replace(s, bytes_hbm=prescreen_hbm,
                                       bytes_sram=prescreen_sram)
        return s
    stages = tuple(_rewrite(s) for s in base.stages)
    return dataclasses.replace(base, stages=stages, stage1_bytes=hbm_bytes,
                               stage1_bytes_sram=sram_bytes)


# ---------------------------------------------------------------------------
# The engine facade
# ---------------------------------------------------------------------------

def _lane(res: RetrievalResult, i: int) -> RetrievalResult:
    return RetrievalResult(indices=res.indices[i], scores=res.scores[i],
                           candidate_indices=res.candidate_indices[i])


@dataclasses.dataclass(frozen=True)
class RetrievalEngine:
    """Owns the backend and the cascade schedule for one config on one
    device. `device` None means the CUDA device, and constructing the
    engine raises when there is none; pass ``device="cpu"`` to run on the
    CPU (where the kernel wrappers take their plain versions)."""

    cfg: RetrievalConfig
    device: torch.device | str | None = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _check(self, *tensors: torch.Tensor) -> None:
        for t in tensors:
            if t.device.type != self.device.type:
                raise ValueError(f"engine runs on {self.device}, got a "
                                 f"tensor on {t.device}")

    def retrieve(self, query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
                 policy: Policy = PlainPolicy()) -> RetrievalResult:
        """Batched retrieval: (B, D) int8 queries -> batched result."""
        self._check(query_codes, db.msb_plane, db.lsb_plane, db.norms_sq)
        return retrieve_batched(query_codes, db, policy, self.cfg)

    def retrieve_single(self, query_codes: torch.Tensor,
                        db: bitplanar.BitPlanarDB,
                        policy: Policy = PlainPolicy()) -> RetrievalResult:
        """(D,) int8 query -> unbatched result (a B=1 lane)."""
        return _lane(self.retrieve(query_codes[None], db, policy), 0)

    def plan_for(self, db: bitplanar.BitPlanarDB, batch: int,
                 policy: Policy = PlainPolicy()) -> SchedulePlan:
        """The analytic SchedulePlan for one launch against `db`."""
        kind = {PlainPolicy: "plain", MaskedPolicy: "masked",
                WindowedPolicy: "windowed"}[type(policy)]
        window = policy.window if isinstance(policy, WindowedPolicy) else None
        return plan(self.cfg, num_docs=db.num_docs, dim=db.dim, batch=batch,
                    kind=kind, window=window)
