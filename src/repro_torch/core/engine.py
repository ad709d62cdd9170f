"""Batch-native retrieval engine: one staged cascade behind every variant.

Port of `repro.core.engine` (the two-stage and cluster-pruned cascades
and the serving runtime's slab and view policies), layered as:

  policy   — which rows each batch lane may touch, as data: `PlainPolicy`
             (every row), `MaskedPolicy` (rows whose arena owner matches
             the lane's tenant), `WindowedPolicy` (a per-lane contiguous
             arena window), `ClusterPolicy` (rows in the lane's
             top-`nprobe` clusters of an INT8 centroid codebook),
             `SlabPolicy` (the cluster prune whose blocks come from the
             arena plane or the serving cache's slab, one combined
             plane) and `ViewPolicy` (a per-lane view the caller
             gathered itself).
  schedule — the cascade: `(ApproxScan, ExactRescore)`, a batched INT4
             scan with a per-lane top-C and then a batched exact INT8
             rescore of the candidates, read by id, and a metric rerank;
             the cluster and slab policies prepend `CentroidPrune` and,
             with `prescreen_c0`, `SignPrescreen`.
  backend  — the batched stage primitives, chosen by
             `RetrievalConfig.backend`: "torch" (plain PyTorch) or "cuda"
             (the kernel wrappers of `repro_torch.kernels.ops`, whose
             block knobs come from the installed autotune table). Both
             are exact integer arithmetic and agree bit for bit.

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


@dataclasses.dataclass(frozen=True)
class ClusterPolicy:
    """Centroid prune: lane i scans only its top-`nprobe` clusters' row
    blocks (and, within them, only rows it owns).

    `cluster_blocks` lists, per cluster, the ids of the `block_rows`-row
    blocks holding its rows (-1 padding): (K, MB) shared by every lane, or
    (B, K, MB) per lane (lane i's table lists only blocks holding its
    tenant's rows, so foreign clusters read as empty and are never
    probed). owner/tenant_ids mask exactly like MaskedPolicy
    (single-corpus callers pass zeros for both). `nprobe` must be <= K and
    the expanded view must hold at least cfg.k rows.
    """

    owner: torch.Tensor            # (N,) int32
    tenant_ids: torch.Tensor       # (B,) int32
    labels: torch.Tensor           # (N,) int32 row -> cluster (-1 free)
    centroid_msb: torch.Tensor     # (K, D//2) uint8 packed centroid nibbles
    centroid_norms: torch.Tensor   # (K,) int32 centroid squared norms
    cluster_blocks: torch.Tensor   # (K, MB) or (B, K, MB) int32, -1 padded
    nprobe: int
    block_rows: int


@dataclasses.dataclass(frozen=True)
class ViewPolicy:
    """A per-lane stage-1 view the caller gathered itself.

    rows: (B, R) global row ids of the view (-1 holes).
    member: (B, R) bool visibility mask (tenant, cluster and holes).
    msb_rows: (B, R, D//2) uint8 stage-1 plane rows of the view (holes may
        hold any bytes: `member` masks them out of both stages).
    """

    rows: torch.Tensor
    member: torch.Tensor
    msb_rows: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SlabPolicy:
    """A ClusterPolicy whose stage-1 blocks come from the arena plane
    (misses) or the serving cache's slab (hits): the serving runtime's
    cached path.

    The slab extends the arena's plane: ``slab_plane = [arena msb_plane |
    slab rows]``, so both sources are one block gather. `slab_blocks` is
    the runtime's per-launch table, each entry a plane block id (a miss),
    ``N / block_rows + slot`` (a hit) or -1 (a hole). Every id is checked
    on the host against the combined plane's blocks before the upload.
    Slab blocks are densely packed, so each combined-space block carries
    `block_gid0` (the global row id of its first row) and `block_count`
    (its live rows): ``block * block_rows`` and `block_rows` for a plane
    block, written at fill time for a slab block.

    `inv_norms` is the cosine key's ``rsqrt(max(norm, 1))`` per combined
    row (0 for an empty row), computed once per arena generation;
    `packed_labels` is `packed_membership` of the arena's owner and
    cluster labels; `cluster_valid` the (B, K) selection validity the
    plane table's first column gives, computed on the host so selection
    is the same at any table width. `sign_plane`, when given, is the
    combined sign plane (the prescreen reads it); else it is derived from
    `slab_plane`. `block_tier`, when the cache runs precision tiers, is
    its (NB + S,) int8 tier of every combined block (0 an arena plane
    block, 1 a sign-tier resident's plane block, 2 a full-tier slab slot):
    no stage reads it; it rides along for the runtime's ledger and the
    checks. The results are the ClusterPolicy cascade's bit for bit.
    """

    packed_labels: torch.Tensor    # (N,) int32 packed (owner, label)
    tenant_ids: torch.Tensor       # (B,) int32
    centroid_msb: torch.Tensor     # (K, D//2) uint8
    centroid_norms: torch.Tensor   # (K,) int32
    cluster_valid: torch.Tensor    # (B, K) bool
    slab_blocks: torch.Tensor      # (B, K, W) int32 combined-space blocks
    block_gid0: torch.Tensor       # (NB + S,) int32 first global row
    block_count: torch.Tensor      # (NB + S,) int32 live rows
    slab_plane: torch.Tensor       # (N + S*br, D//2) uint8 plane + slab
    inv_norms: torch.Tensor        # (N + S*br,) f32
    nprobe: int
    block_rows: int
    sign_plane: torch.Tensor | None = None  # (N + S*br, D//8) uint8
    block_tier: torch.Tensor | None = None  # (NB + S,) int8 tiers


def packed_membership(owner: torch.Tensor, labels: torch.Tensor,
                      num_clusters: int) -> torch.Tensor:
    """Per-row (owner, cluster label) as one int32:
    ``(owner + 1) * (K + 1) + label + 1``, injective for owner >= -1 and
    label in [-1, K), so ``packed[row] == (t + 1) * (K + 1) + c + 1``
    exactly when the row is tenant t's and in cluster c."""
    k1 = num_clusters + 1
    return ((owner.to(torch.int32) + 1) * k1
            + labels.to(torch.int32) + 1)


Policy = (PlainPolicy | MaskedPolicy | WindowedPolicy | ClusterPolicy
          | ViewPolicy | SlabPolicy)


# ---------------------------------------------------------------------------
# Batched stage primitives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageFns:
    """The cascade's batched primitives for one backend.

    plane:    stage-1 shared-plane scan   (B, D) x (N, D/2)    -> (B, N)
    rows:     stage-1 per-lane rows       (B, D) x (B, W, D/2) -> (B, W)
    gather:   stage-1 per-lane block gather (B, D) x plane + (B, J) ids
              -> (B, J * block_rows); rows past N score 0
    gather_resident: the gather over a plane of whole blocks whose every
              id is live (no zero-row convention): the slab policy's
              combined plane
    centroid: stage-0 codebook scoring, the plane scan over (K, D/2)
    exact:    stage-2 INT8 rescore of candidate ids (B, D) x 2 (N, D/2)
              planes + (B, C) int32 ids -> (B, C); ids clamp to [0, N - 1]
              as JAX's indexing clamps (the reference's `jnp.take` fills;
              the engine never passes an id >= N)
    exact_rerank: the whole exact stage, (B, D) queries x 2 (N, D/2)
              planes + (B, C) int32 ids + (N,) norms + (B, C) member mask
              or None, k and metric -> (indices, scores, candidate_indices)
              int32: the exact scores, norms, MASKED_SCORE pins, rerank
              and the result's -1 / 0 masking
    rerank:   the exact stage's ranking half, (B, C) int32 scores, norms
              and ids, k and metric -> (ids at the top k, their scores)
    sign_gather / sign_gather_resident: the sign prescreen's block gathers
              over the packed (N, D/8) sign plane (zero bytes score
              sum(q_sign)) and over the slab policy's combined sign plane;
              sign_gather takes `group` (a table row per `group` lanes)
    """

    plane: Callable
    rows: Callable
    gather: Callable
    gather_resident: Callable
    centroid: Callable
    exact: Callable
    exact_rerank: Callable
    rerank: Callable
    sign_gather: Callable
    sign_gather_resident: Callable


def stage_fns(backend: str) -> StageFns:
    """"cuda": the kernel wrappers; "torch": the same query packing feeding
    the kernels' plain versions in `kernels.ref` on any device."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    if backend == "cuda":
        return StageFns(
            plane=kops.stage1_scores_batched,
            rows=kops.stage1_scores_rows,
            gather=kops.stage1_scores_gather,
            gather_resident=kops.stage1_scores_gather_resident,
            centroid=kops.centroid_scores_batched,
            exact=kops.stage2_scores_by_id,
            exact_rerank=kops.exact_rerank_by_id,
            rerank=kops.rerank,
            sign_gather=kops.stage0_sign_scores_gather,
            sign_gather_resident=kops.stage0_sign_scores_gather_resident)
    if backend == "torch":
        def plane(q_msb, plane):
            return ref.stage1_scores_batched_ref(kops.pack_query_panel(q_msb),
                                                 plane)

        def gather_with(plain):
            return lambda q_msb, plane, ids, *, block_rows: plain(
                kops.pack_queries_even_odd(q_msb), plane, ids, block_rows)

        def sign_gather(q_sign, plane, ids, *, block_rows, group=1):
            return ref.stage0_sign_gather_ref(q_sign, plane, ids, block_rows,
                                              group=group)

        return StageFns(
            plane=plane,
            rows=lambda q_msb, rows: ref.stage1_rows_batched_ref(
                kops.pack_queries_even_odd(q_msb), rows),
            gather=gather_with(ref.stage1_gather_batched_ref),
            gather_resident=gather_with(ref.stage1_gather_resident_ref),
            centroid=plane,
            exact=lambda q, msb, lsb, ids: ref.stage2_scores_by_id_ref(
                kops.pack_queries_even_odd(q), msb, lsb, ids),
            exact_rerank=ref.exact_rerank_by_id_ref,
            rerank=ref.rerank_ref,
            sign_gather=sign_gather,
            sign_gather_resident=lambda q_sign, plane, ids, *, block_rows: (
                ref.stage0_sign_gather_resident_ref(q_sign, plane, ids,
                                                    block_rows)))
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


def probe_rows(policy: ClusterPolicy | SlabPolicy) -> int:
    """Per-lane row count of the cluster or slab policy's gathered view."""
    table = (policy.slab_blocks if isinstance(policy, SlabPolicy)
             else policy.cluster_blocks)
    return (min(policy.nprobe, policy.centroid_msb.shape[0])
            * table.shape[-1] * policy.block_rows)


@dataclasses.dataclass
class _CascadeState:
    """What the stages refine: which rows are still alive.

    rows: (B, R) global row ids of the current view (-1 holes), or None
        while the view is implicit (plane / window); (B, C) candidates
        after ApproxScan.
    member: visibility mask aligned with `rows` (None = all visible).
    block_ids: (B, J) clamped block ids backing `rows` when the view is a
        block gather (the gather kernels' table; combined-space under a
        SlabPolicy).
    comb_rows: (B, R) combined-space row ids aligned with `rows`, set by
        the prescreen under a SlabPolicy (stage 1 then reads the
        survivors from the combined plane, hits from the slab).
    top_clusters: (B, nprobe) cluster ids selected by a centroid prune.
    result: the final RetrievalResult, set by the terminal stage.
    """

    rows: torch.Tensor | None = None
    member: torch.Tensor | None = None
    block_ids: torch.Tensor | None = None
    comb_rows: torch.Tensor | None = None
    top_clusters: torch.Tensor | None = None
    result: RetrievalResult | None = None


@dataclasses.dataclass
class _CascadeCtx:
    """Per-launch invariants every stage reads. q_sign is the (B, D) +-1
    sign view of the query codes (0 maps to +1), set only when the
    cascade runs the sign prescreen."""

    query_codes: torch.Tensor
    q_msb: torch.Tensor
    db: bitplanar.BitPlanarDB
    policy: Policy
    cfg: RetrievalConfig
    fns: StageFns
    q_sign: torch.Tensor | None = None


def select_clusters(q_msb: torch.Tensor, policy: ClusterPolicy | SlabPolicy,
                    cfg: RetrievalConfig, fns: StageFns) -> torch.Tensor:
    """Score the K centroids and keep each lane's top-`nprobe` valid
    clusters (a cluster with no blocks for the lane, first block id -1,
    spends no probe; a SlabPolicy carries that validity as
    `cluster_valid`). Returns (B, nprobe) int32 cluster ids in rank
    order, ties toward the lower id."""
    nprobe = min(policy.nprobe, policy.centroid_msb.shape[0])
    scores = fns.centroid(q_msb, policy.centroid_msb)            # (B, K)
    if isinstance(policy, SlabPolicy):
        valid = policy.cluster_valid
    else:
        table = policy.cluster_blocks
        valid = (table[:, 0] >= 0)[None, :] if table.ndim == 2 \
            else table[:, :, 0] >= 0
    if cfg.metric == "cosine":
        key = similarity.cosine_key_f32(scores, policy.centroid_norms)
        key = key.masked_fill(~valid, float("-inf"))
    else:
        key = scores.masked_fill(~valid, INT32_MIN)
    _, top = similarity.stable_topk(key, nprobe)
    return top.to(torch.int32)


def expand_cluster_view(policy: ClusterPolicy, top_clusters: torch.Tensor,
                        num_docs: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand the selected clusters' blocks into an explicit per-lane row
    view: (rows (B, R) int32 with -1 holes, member (B, R) bool,
    clamped_block_ids (B, J) int32)."""
    table = policy.cluster_blocks
    top = top_clusters.long()
    if table.ndim == 2:
        blocks = table[top]                                      # (B, P, MB)
    else:
        blocks = torch.gather(
            table, 1, top[:, :, None].expand(-1, -1, table.shape[2]))
    b, _, max_blocks = blocks.shape
    blocks = blocks.reshape(b, -1)                               # (B, J)
    br = policy.block_rows
    clamped = torch.clamp(blocks, min=0)
    # Row ids come from the expansion the gather primitives use, so the
    # bookkeeping matches what stage 1 reads.
    rows = bitplanar.expand_block_rows(clamped, br)
    hole = torch.repeat_interleave(blocks < 0, br, dim=1) | (rows >= num_docs)
    rows = rows.masked_fill(hole, -1)
    safe = torch.clamp(rows, min=0).long()
    # A block at a cluster boundary is listed under both clusters; a row
    # is kept only through its own cluster's entry, so no row appears
    # twice in the view.
    owning = top.repeat_interleave(max_blocks * br, dim=1)       # (B, R)
    member = (~hole & _membership(policy.owner[safe], policy.tenant_ids)
              & (policy.labels[safe] == owning))
    return rows, member, clamped


def expand_slab_view(policy: SlabPolicy, top_clusters: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slab path's expansion of the selected clusters: (rows (B, R)
    int32 global row ids, clamped to [0, N - 1] (holes and pads ride the
    member mask), member (B, R) bool, comb_ids (B, J) int32 clamped
    combined-space block ids for the gather). Row ids come from each
    block's `block_gid0`/`block_count`, so plane blocks expand as the
    cluster path's do and packed slab blocks to their run's rows."""
    top = top_clusters.long()
    w = policy.slab_blocks.shape[2]
    comb = torch.gather(policy.slab_blocks, 1,
                        top[:, :, None].expand(-1, -1, w))
    b = comb.shape[0]
    comb = comb.reshape(b, -1)                                   # (B, J)
    br = policy.block_rows
    hole = comb < 0
    safe_blk = torch.clamp(comb, min=0)
    gid0 = policy.block_gid0[safe_blk.long()]                    # (B, J)
    cnt = policy.block_count[safe_blk.long()]
    offs = torch.arange(br, dtype=torch.int32, device=comb.device)
    rows = (gid0[:, :, None] + offs).reshape(b, -1)
    live = (offs < cnt[:, :, None]).reshape(b, -1)
    n = policy.packed_labels.shape[0]
    rows = torch.clamp(rows, max=n - 1)      # tail pads stay gatherable
    owning = top_clusters.repeat_interleave(w * br, dim=1)       # (B, R)
    k1 = policy.centroid_msb.shape[0] + 1
    expected = (policy.tenant_ids[:, None] + 1) * k1 + owning + 1
    member = (~hole.repeat_interleave(br, dim=1) & live
              & (policy.packed_labels[rows.long()] == expected)
              & (policy.tenant_ids >= 0)[:, None])
    return rows, member, safe_blk


@dataclasses.dataclass(frozen=True)
class CentroidPrune:
    """Stage 0: score the K centroids, keep the top-`nprobe` clusters'
    blocks, and expand them into an explicit per-lane row view."""

    nprobe: int

    def run(self, state: _CascadeState, ctx: _CascadeCtx) -> _CascadeState:
        top_clusters = select_clusters(ctx.q_msb, ctx.policy, ctx.cfg,
                                       ctx.fns)
        if isinstance(ctx.policy, SlabPolicy):
            rows, member, comb = expand_slab_view(ctx.policy, top_clusters)
            return dataclasses.replace(state, rows=rows, member=member,
                                       block_ids=comb,
                                       top_clusters=top_clusters)
        rows, member, clamped = expand_cluster_view(ctx.policy, top_clusters,
                                                    ctx.db.num_docs)
        return dataclasses.replace(state, rows=rows, member=member,
                                   block_ids=clamped,
                                   top_clusters=top_clusters)


@dataclasses.dataclass(frozen=True)
class SignPrescreen:
    """Stage 0.5: 1-bit sign-agreement prescreen of the pruned view.

    Reads only the packed sign plane (D/8 bytes per row) over the
    prune's gathered view and keeps each lane's top-`c0` members. Ties
    (sign scores are small integers) go to the lower view position, and
    the survivors are re-sorted into view order, so at c0 >= the view the
    cascade is bit-identical to the prescreen-off schedule. Non-members
    score INT32_MIN, so a lane with >= k live members never loses one to
    a masked row.

    Under a SlabPolicy the sign bytes come from the combined sign plane
    (hot clusters' sign rows beside their slab rows), and the survivors'
    combined row ids go on as `comb_rows`, so stage 1 reads hits from the
    slab."""

    c0: int

    def run(self, state: _CascadeState, ctx: _CascadeCtx) -> _CascadeState:
        policy = ctx.policy
        c0 = ctx.cfg.prescreen_budget(state.rows.shape[1])
        comb_rows = None
        if isinstance(policy, SlabPolicy):
            sign_plane = policy.sign_plane
            if sign_plane is None:
                sign_plane = bitplanar.sign_plane_from_msb(policy.slab_plane)
            scores = ctx.fns.sign_gather_resident(
                ctx.q_sign, sign_plane, state.block_ids,
                block_rows=policy.block_rows)
            comb_rows = bitplanar.expand_block_rows(state.block_ids,
                                                    policy.block_rows)
        else:
            sign_plane = ctx.db.sign_plane
            if sign_plane is None:
                # Derived per call from the nibble plane, as the
                # reference does; a DB built with its sign plane skips
                # this.
                sign_plane = bitplanar.sign_plane_from_msb(ctx.db.msb_plane)
            scores = ctx.fns.sign_gather(ctx.q_sign, sign_plane,
                                         state.block_ids,
                                         block_rows=policy.block_rows)
        key0 = scores.masked_fill(~state.member, INT32_MIN)
        _, sel = similarity.stable_topk(key0, c0)
        sel, _ = torch.sort(sel, dim=1)      # survivors keep view order
        if comb_rows is not None:
            comb_rows = torch.gather(comb_rows, 1, sel)
        return dataclasses.replace(
            state, rows=torch.gather(state.rows, 1, sel),
            member=torch.gather(state.member, 1, sel), block_ids=None,
            comb_rows=comb_rows)


@dataclasses.dataclass(frozen=True)
class ApproxScan:
    """Stage 1: batched INT4 MSB scan of the policy's row view, then a
    per-lane candidate top-C."""

    def run(self, state: _CascadeState, ctx: _CascadeCtx) -> _CascadeState:
        db, policy, cfg = ctx.db, ctx.policy, ctx.cfg
        n = db.num_docs
        member = state.member
        view_rows = state.rows          # view-local -> global row id map
        base = None
        key1 = None                     # set directly by the slab branch
        if isinstance(policy, SlabPolicy):
            # One block gather over the combined plane: hits from the slab
            # region, misses from the arena plane. The cosine key
            # multiplies the per-generation rsqrt sidecar (the cold path's
            # f32 bits); + 0.0 turns the sidecar's empty rows' -0.0 into
            # the cold path's +0.0.
            r = view_rows.shape[1]
            if r < cfg.k:
                raise ValueError(f"slab view holds {r} rows < k={cfg.k}: "
                                 "raise nprobe or block_rows")
            c = _candidate_budget(cfg, n, r)
            if state.block_ids is not None:
                scores = ctx.fns.gather_resident(
                    ctx.q_msb, policy.slab_plane, state.block_ids,
                    block_rows=policy.block_rows)
                comb_rows = bitplanar.expand_block_rows(state.block_ids,
                                                        policy.block_rows)
            else:
                # Prescreened view: the survivors' combined rows, scored by
                # the per-lane rows primitive.
                comb_rows = state.comb_rows
                scores = ctx.fns.rows(ctx.q_msb,
                                      policy.slab_plane[comb_rows.long()])
            if cfg.metric == "cosine":
                key1 = (scores.to(torch.float32)
                        * policy.inv_norms[comb_rows.long()] + 0.0)
                key1 = key1.masked_fill(~member, float("-inf"))
            else:
                key1 = scores.masked_fill(~member, INT32_MIN)
        elif isinstance(policy, ViewPolicy):
            # The caller's own view: the rows arrive as data.
            r = policy.rows.shape[1]
            if r < cfg.k:
                raise ValueError(f"materialized view holds {r} rows < k="
                                 f"{cfg.k}: raise nprobe or block_rows")
            c = _candidate_budget(cfg, n, r)
            scores = ctx.fns.rows(ctx.q_msb, policy.msb_rows)  # (B, R) int32
            norms = db.norms_sq[torch.clamp(policy.rows, min=0).long()]
            member = policy.member
            view_rows = policy.rows
        elif isinstance(policy, WindowedPolicy):
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
        elif view_rows is not None:
            # Gathered view (the centroid prune's output): read only the
            # selected blocks.
            r = view_rows.shape[1]
            if r < cfg.k:
                raise ValueError(f"gathered view holds {r} rows < k="
                                 f"{cfg.k}: raise nprobe or block_rows")
            c = _candidate_budget(cfg, n, r)
            safe = torch.clamp(view_rows, min=0).long()
            if state.block_ids is not None:
                scores = ctx.fns.gather(ctx.q_msb, db.msb_plane,
                                        state.block_ids,
                                        block_rows=policy.block_rows)
            else:
                # Prescreened view: survivors are global row ids; holes
                # clamp to row 0 and ride the member mask (their raw
                # score differs from the block gather's zero row, their
                # masked key does not).
                scores = ctx.fns.rows(ctx.q_msb, db.msb_plane[safe])
            norms = db.norms_sq[safe]
        else:
            c = _candidate_budget(cfg, n, None)
            scores = ctx.fns.plane(ctx.q_msb, db.msb_plane)    # (B, N) int32
            norms = db.norms_sq[None, :]
            if isinstance(policy, MaskedPolicy):
                member = _membership(policy.owner[None, :],
                                     policy.tenant_ids)

        if key1 is None and cfg.metric == "cosine":
            # Tombstoned rows carry norm 0 (key 0), so even an inconsistent
            # membership mask cannot let a dead row win.
            key1 = similarity.cosine_key_f32(scores, norms)
            if member is not None:
                key1 = key1.masked_fill(~member, float("-inf"))
        elif key1 is None:
            key1 = (scores if member is None
                    else scores.masked_fill(~member, INT32_MIN))
        _, cand_local = similarity.stable_topk(key1, c)        # (B, C) view
        if view_rows is not None:
            cand = torch.gather(view_rows, 1, cand_local)
        elif base is not None:
            cand = cand_local + base
        else:
            cand = cand_local
        cand = cand.to(torch.int32)
        cand_member = (None if member is None
                       else torch.gather(member, 1, cand_local))
        return dataclasses.replace(state, rows=cand, member=cand_member,
                                   block_ids=None)


@dataclasses.dataclass(frozen=True)
class ExactRescore:
    """Terminal stage: rescore the candidates' full INT8 codes exactly, read
    from the full planes at their ids, then rerank (non-division comparator
    for cosine, top-k for MIPS): one call of the backend's `exact_rerank`
    (on "cuda" one kernel launch). Holes (-1) clamp to row 0 and are pinned
    below every real candidate by the membership mask."""

    def run(self, state: _CascadeState, ctx: _CascadeCtx) -> _CascadeState:
        db, cfg = ctx.db, ctx.cfg
        indices, scores, cand = ctx.fns.exact_rerank(
            ctx.query_codes, db.msb_plane, db.lsb_plane, state.rows,
            db.norms_sq, state.member, k=cfg.k, metric=cfg.metric)
        return dataclasses.replace(state, result=RetrievalResult(
            indices=indices, scores=scores, candidate_indices=cand))


_PLAN_KINDS = {PlainPolicy: "plain", MaskedPolicy: "masked",
               WindowedPolicy: "windowed", ClusterPolicy: "cluster",
               ViewPolicy: "view", SlabPolicy: "cluster"}


def cascade_stages(policy: Policy, cfg: RetrievalConfig) -> tuple:
    """The stage specs one launch runs: the paper's two-stage cascade;
    the cluster and slab policies prepend the centroid prune and, with
    `prescreen_c0`, the sign prescreen. A ViewPolicy enters at the scan:
    its prune ran before."""
    if isinstance(policy, (ClusterPolicy, SlabPolicy)):
        head: tuple = (CentroidPrune(policy.nprobe),)
        if cfg.prescreen_c0 is not None:
            head += (SignPrescreen(cfg.prescreen_c0),)
        return head + (ApproxScan(), ExactRescore())
    return (ApproxScan(), ExactRescore())


def _run_cascade(query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
                 policy: Policy, cfg: RetrievalConfig) -> _CascadeState:
    stages = cascade_stages(policy, cfg)
    q_sign = (bitplanar.sign_pm1(query_codes)
              if any(isinstance(s, SignPrescreen) for s in stages) else None)
    ctx = _CascadeCtx(query_codes=query_codes,
                      q_msb=quantization.msb_nibble(query_codes),
                      db=db, policy=policy, cfg=cfg,
                      fns=stage_fns(cfg.backend), q_sign=q_sign)
    state = _CascadeState()
    for stage in stages:
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
        # Block-shape hook: if REPRO_TORCH_AUTOTUNE_CACHE names a valid
        # artifact for this device, install it; the "cuda" backend's
        # tunable wrappers resolve their blocks through it. Without one
        # every block is the kernel's default.
        from repro_torch.kernels import autotune
        autotune.ensure_default_installed(self.device)

    def _check(self, query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
               policy: Policy) -> None:
        tensors = [query_codes, db.msb_plane, db.lsb_plane, db.norms_sq]
        tensors += [v for v in vars(policy).values()
                    if isinstance(v, torch.Tensor)]
        for t in tensors:
            if t.device.type != self.device.type:
                raise ValueError(f"engine runs on {self.device}, got a "
                                 f"tensor on {t.device}")

    def retrieve(self, query_codes: torch.Tensor, db: bitplanar.BitPlanarDB,
                 policy: Policy = PlainPolicy()) -> RetrievalResult:
        """Batched retrieval: (B, D) int8 queries -> batched result."""
        return self.retrieve_with_clusters(query_codes, db, policy)[0]

    def retrieve_with_clusters(self, query_codes: torch.Tensor,
                               db: bitplanar.BitPlanarDB, policy: Policy
                               ) -> tuple[RetrievalResult,
                                          torch.Tensor | None]:
        """Batched retrieval plus the prune's (B, nprobe) int32 cluster
        selection (None for policies without a prune stage)."""
        self._check(query_codes, db, policy)
        state = _run_cascade(query_codes, db, policy, self.cfg)
        return state.result, state.top_clusters

    def retrieve_single(self, query_codes: torch.Tensor,
                        db: bitplanar.BitPlanarDB,
                        policy: Policy = PlainPolicy()) -> RetrievalResult:
        """(D,) int8 query -> unbatched result (a B=1 lane)."""
        return _lane(self.retrieve(query_codes[None], db, policy), 0)

    def plan_for(self, db: bitplanar.BitPlanarDB, batch: int,
                 policy: Policy = PlainPolicy()) -> SchedulePlan:
        """The analytic SchedulePlan for one launch against `db`."""
        if type(policy) not in _PLAN_KINDS:
            raise TypeError(f"{type(policy).__name__} is not a retrieval "
                            "policy")
        window = policy.window if isinstance(policy, WindowedPolicy) else None
        num_clusters = view_rows = None
        if isinstance(policy, (ClusterPolicy, SlabPolicy)):
            num_clusters = policy.centroid_msb.shape[0]
            view_rows = probe_rows(policy)
        elif isinstance(policy, ViewPolicy):
            view_rows = policy.rows.shape[1]
        return plan(self.cfg, num_docs=db.num_docs, dim=db.dim, batch=batch,
                    kind=_PLAN_KINDS[type(policy)], window=window,
                    num_clusters=num_clusters, view_rows=view_rows)


# ---------------------------------------------------------------------------
# The KV-cache cascade (decode attention)
# ---------------------------------------------------------------------------
# One decode step's attention as a cascade over a quantized KV cache, the
# retrieval cascade's shape applied to the cache: `KVPagePrune` (score
# per-page INT8 centroids, keep the top-`npages` pages per (batch, kv-head)
# lane), `KVSignPrescreen` (1-bit sign agreement over the kept pages, keep
# the top-`c0` positions), `KVApproxTopK` (f32 query x MSB-nibble keys,
# keep the top-k) and `KVExactAttend` (rebuild the survivors' INT8 keys,
# exact masked softmax attention). The integer stages run on the "cuda"
# kernels (#2 for the page prune, #8 for the prescreen) or their plain
# versions; the f32 stages are the same torch ops on either backend, so
# on one device the two backends give the same bits. Without a prune or a
# prescreen the cascade is the two-stage schedule of
# `serve.sparse_kv.sparse_decode_attention_ref`, bit for bit.

KV_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class KVCascadeConfig:
    """The schedule of one decode-attention cascade.

    top_k: exact-attention budget per (batch, kv-head) lane.
    npages: pages kept by KVPagePrune (None: no prune, every position
        enters the approx scan).
    page_rows: rows per key page (the prune and prescreen block; the cache
        length T must be a multiple when either stage is on).
    prescreen_c0: positions kept by the sign prescreen (None: off; needs
        npages, since the sign gather reads the pruned pages).
    backend: "cuda" (the kernel wrappers, whose CPU tensors take the plain
        versions) or "torch" (the plain versions on any device) for the
        integer stages; the f32 stages are shared.
    scale: softmax scale (None: hd ** -0.5).
    """

    top_k: int
    npages: int | None = None
    page_rows: int = 8
    prescreen_c0: int | None = None
    backend: Literal["torch", "cuda"] = "cuda"
    scale: float | None = None

    def __post_init__(self):
        if self.top_k < 1:
            raise ValueError("top_k must be >= 1")
        if self.prescreen_c0 is not None and self.npages is None:
            raise ValueError("prescreen_c0 gates the pruned pages' sign "
                             "gather: it needs npages")
        if self.npages is not None and self.page_rows < 1:
            raise ValueError("page_rows must be >= 1")


@dataclasses.dataclass(frozen=True)
class KVCachePolicy:
    """One layer's quantized KV cache as the cascade's corpus.

    k_msb / k_lsb: (B, T, KH, hd//2) uint8 nibble planes of INT8 keys.
    k_scale: (B, T, KH) f32 per-(position, head) scales.
    v: (B, T, KH, hd) values at compute precision.
    length: (B,) int32 valid positions per sequence.
    cent_msb / cent_scale: (B, P, KH, hd//2) / (B, P, KH) page centroids
        (P = T // page_rows), needed when npages is set.
    k_sign: optional (B, T, KH, hd//8) packed sign sidecar; without it the
        prescreen derives the sign plane from k_msb on every step (the
        same bytes, `bitplanar.sign_plane_from_msb`).
    """

    k_msb: torch.Tensor
    k_lsb: torch.Tensor
    k_scale: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    cent_msb: torch.Tensor | None = None
    cent_scale: torch.Tensor | None = None
    k_sign: torch.Tensor | None = None


@dataclasses.dataclass
class _KVState:
    """Which cache positions are alive.

    rows: (B, KH, R) position ids of the view (None: the implicit full
        view of the no-prune schedule).
    member: (B, KH, R) bool, position < length, aligned with rows.
    pages: (B, KH, npages) selected page ids, ascending (the prescreen
        addresses the flat sign plane by them).
    out: the (B, 1, H, hd) attention output, set by KVExactAttend.
    """

    rows: torch.Tensor | None = None
    member: torch.Tensor | None = None
    pages: torch.Tensor | None = None
    out: torch.Tensor | None = None


@dataclasses.dataclass
class _KVCtx:
    """Per-step invariants: qg is the f32 grouped query (B, KH, G, hd);
    q_codes / q_scale its per-head-vector INT8 quantization, made only when
    a kernel stage (prune, prescreen) needs integer query operands."""

    q: torch.Tensor
    qg: torch.Tensor
    policy: KVCachePolicy
    cfg: KVCascadeConfig
    fns: StageFns
    q_codes: torch.Tensor | None = None
    q_scale: torch.Tensor | None = None


def _kv_flat(x: torch.Tensor) -> torch.Tensor:
    """(B, T, KH, ...) cache plane -> (B*KH*T, ...) flat plane: row
    (b*KH + kh)*T + t holds position t of lane (b, kh), so the gather
    kernels read the whole batched cache as one corpus with per-lane block
    ids. A copy whenever KH > 1, as in the reference."""
    b, t, kh = x.shape[:3]
    return x.transpose(1, 2).reshape(b * kh * t, *x.shape[3:])


def _kv_flat_rows(rows: torch.Tensor, t: int) -> torch.Tensor:
    """(B, KH, R) cache positions -> flat plane row ids."""
    b, kh = rows.shape[:2]
    dev = rows.device
    lane = (torch.arange(b, dtype=torch.int32, device=dev)[:, None, None] * kh
            + torch.arange(kh, dtype=torch.int32, device=dev)[None, :, None])
    return lane * t + rows


def _kv_scores(qg: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(B, KH, G, hd) f32 queries x (B, KH, R, hd) keys -> (B, KH, G, R)
    f32. The keys are made contiguous f32 first, so every caller hands the
    product the same operand layout and equal inputs give equal bits."""
    return torch.matmul(qg, keys.to(torch.float32).contiguous()
                        .transpose(-1, -2))


def _kv_lengths(policy: KVCachePolicy) -> torch.Tensor:
    return policy.length.reshape(-1, 1, 1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class KVPagePrune:
    """Stage 0: score the per-page centroids, keep each (batch, kv-head)
    lane's top-`npages` valid pages, and expand them to a position view.

    The centroid scores are the rows kernel's integer dots over each
    lane's centroid rows, scaled to f32 by the query and centroid scales,
    max-reduced over the lane's G query heads; pages wholly past `length`
    score -inf. The kept pages are sorted ascending, so at full coverage
    the view is the identity and the cascade is the unpruned one."""

    npages: int

    def run(self, state: _KVState, ctx: _KVCtx) -> _KVState:
        pol, cfg = ctx.policy, ctx.cfg
        if pol.cent_msb is None or pol.cent_scale is None:
            raise ValueError("npages needs page centroids on the policy "
                             "(cent_msb/cent_scale: see "
                             "serve.sparse_kv.build_page_centroids)")
        b, t, kh, hd = pol.v.shape
        pr = cfg.page_rows
        if t % pr:
            raise ValueError(f"cache length {t} is not a multiple of "
                             f"page_rows={pr}")
        p = t // pr
        if pol.cent_msb.shape[1] != p:
            raise ValueError(f"centroid table holds {pol.cent_msb.shape[1]} "
                             f"pages, cache has {p}")
        npages = min(self.npages, p)
        g = ctx.qg.shape[2]
        dev = pol.v.device
        q_nib = quantization.msb_nibble(ctx.q_codes).reshape(b * kh * g, hd)
        # Each lane's centroid rows, repeated for its G query heads: one
        # contiguous (B*KH*G, P, hd/2) operand for the rows kernel.
        cent_rows = (pol.cent_msb.transpose(1, 2)[:, :, None]
                     .expand(b, kh, g, p, hd // 2)
                     .reshape(b * kh * g, p, hd // 2).contiguous())
        scores = ctx.fns.rows(q_nib, cent_rows)               # (B', P) int32
        key = (scores.to(torch.float32).reshape(b, kh, g, p)
               * ctx.q_scale.reshape(b, kh, g)[..., None]
               * pol.cent_scale.transpose(1, 2)[:, :, None, :])
        key = key.amax(dim=2)                                 # (B, KH, P)
        first_row = torch.arange(p, dtype=torch.int32, device=dev) * pr
        valid = first_row[None, None, :] < _kv_lengths(pol)
        key = key.masked_fill(~valid, float("-inf"))
        _, pages = similarity.stable_topk(key, npages)        # (B, KH, NP)
        pages, _ = torch.sort(pages.to(torch.int32), dim=-1)  # cache order
        offs = torch.arange(pr, dtype=torch.int32, device=dev)
        rows = (pages[..., None] * pr + offs).reshape(b, kh, npages * pr)
        member = rows < _kv_lengths(pol)
        return dataclasses.replace(state, rows=rows, member=member,
                                   pages=pages)


@dataclasses.dataclass(frozen=True)
class KVSignPrescreen:
    """Stage 0.5: 1-bit sign agreement over the pruned pages.

    The sign gather (#8) reads only the kept pages' sign bytes (hd/8 per
    position) from the flat cache plane, each (lane, page) a block; the
    G query heads of a KV head share its (B*KH, NP) page table (`group`
    = G), so each page is read once for all of them. The scores are
    max-reduced over the G query heads, non-members score INT32_MIN, and
    the top-`c0` survivors are re-sorted into view order, so at c0 >= the
    view the cascade is the no-prescreen one."""

    c0: int

    def run(self, state: _KVState, ctx: _KVCtx) -> _KVState:
        pol, cfg = ctx.policy, ctx.cfg
        b, t, kh, hd = pol.v.shape
        if hd % 8:
            raise ValueError(f"sign prescreen needs head_dim % 8 == 0, "
                             f"got {hd}")
        pr = cfg.page_rows
        g = ctx.qg.shape[2]
        r = state.rows.shape[2]
        c0 = min(self.c0, r)
        flat_sign = (bitplanar.sign_plane_from_msb(_kv_flat(pol.k_msb))
                     if pol.k_sign is None else _kv_flat(pol.k_sign))
        q_sign = bitplanar.sign_pm1(ctx.q_codes).reshape(b * kh * g, hd)
        blk = _kv_flat_rows(state.pages, t // pr).reshape(b * kh, -1)
        scores = ctx.fns.sign_gather(q_sign, flat_sign, blk, block_rows=pr,
                                     group=g)                 # (B', R) int32
        key = scores.reshape(b, kh, g, r).amax(dim=2)         # (B, KH, R)
        key = key.masked_fill(~state.member, INT32_MIN)
        _, sel = similarity.stable_topk(key, c0)              # (B, KH, C0)
        sel, _ = torch.sort(sel, dim=-1)     # survivors keep view order
        return dataclasses.replace(
            state, rows=torch.gather(state.rows, 2, sel),
            member=torch.gather(state.member, 2, sel))


@dataclasses.dataclass(frozen=True)
class KVApproxTopK:
    """Stage 1: f32 query x MSB-nibble keys (times the per-position scale),
    max over the G query heads, dead positions at KV_NEG_INF, per-lane
    top-k. The full-view branch is the legacy schedule's stage 1; the
    gathered branch scores the surviving positions' rows with the same
    product on the same (B, KH, R, hd) layout, so at full page coverage
    both give the same bits and the same selection."""

    top_k: int

    def run(self, state: _KVState, ctx: _KVCtx) -> _KVState:
        pol = ctx.policy
        b, t, kh, hd = pol.v.shape
        if state.rows is None:
            # Full view: every cached position, from the MSB plane.
            k_msb = bitplanar.unpack_nibble_plane_signed(
                pol.k_msb.reshape(-1, hd // 2)).reshape(b, t, kh, hd)
            s1 = _kv_scores(ctx.qg, k_msb.transpose(1, 2))
            s1 = s1 * pol.k_scale.transpose(1, 2)[:, :, None, :]
            s1 = s1.amax(dim=2)                               # (B, KH, T)
            valid = (torch.arange(t, dtype=torch.int32, device=s1.device)
                     [None, None, :] < _kv_lengths(pol))
            s1 = s1.masked_fill(~valid, KV_NEG_INF)
            _, sel = similarity.stable_topk(s1, min(self.top_k, t))
            sel = sel.to(torch.int32)                         # (B, KH, k)
            return dataclasses.replace(state, rows=sel,
                                       member=sel < _kv_lengths(pol))
        # Gathered view: only the surviving positions' nibble rows, read
        # from the flat plane.
        r = state.rows.shape[2]
        fr = _kv_flat_rows(state.rows, t).reshape(-1).long()
        g_msb = _kv_flat(pol.k_msb)[fr]
        k_msb = bitplanar.unpack_nibble_plane_signed(g_msb).reshape(
            b, kh, r, hd)
        scale_sel = _kv_flat(pol.k_scale)[fr].reshape(b, kh, r)
        s1 = _kv_scores(ctx.qg, k_msb) * scale_sel[:, :, None, :]
        s1 = s1.amax(dim=2)                                   # (B, KH, R)
        s1 = s1.masked_fill(~state.member, KV_NEG_INF)
        _, sel = similarity.stable_topk(s1, min(self.top_k, r))
        return dataclasses.replace(
            state, rows=torch.gather(state.rows, 2, sel),
            member=torch.gather(state.member, 2, sel))


@dataclasses.dataclass(frozen=True)
class KVExactAttend:
    """Terminal stage: gather the survivors' two nibble planes, rebuild
    their INT8 keys, exact masked softmax attention over them. A masked
    position weighs exp 0 and an all-masked row divides by 1, so at
    length 0 the output is exact zeros, not NaN."""

    def run(self, state: _KVState, ctx: _KVCtx) -> _KVState:
        pol, cfg = ctx.policy, ctx.cfg
        b, t, kh, hd = pol.v.shape
        h = ctx.q.shape[2]
        k_eff = state.rows.shape[2]
        scale = cfg.scale or hd ** -0.5
        dev = pol.v.device
        sel = state.rows.long()
        bidx = torch.arange(b, device=dev)[:, None, None]
        hidx = torch.arange(kh, device=dev)[None, :, None]
        msb_sel = pol.k_msb[bidx, sel, hidx]                  # (B, KH, k, hd/2)
        lsb_sel = pol.k_lsb[bidx, sel, hidx]
        scale_sel = pol.k_scale[bidx, sel, hidx]              # (B, KH, k)
        k_int = bitplanar.reconstruct_int8(
            msb_sel.reshape(-1, hd // 2),
            lsb_sel.reshape(-1, hd // 2)).reshape(b, kh, k_eff, hd)
        k_sel = k_int.to(torch.float32) * scale_sel[..., None]
        v_sel = pol.v[bidx, sel, hidx].to(torch.float32)
        s2 = _kv_scores(ctx.qg, k_sel) * scale
        mask = state.member[:, :, None, :]
        s2 = s2.masked_fill(~mask, KV_NEG_INF)
        e = torch.where(mask, torch.exp(s2 - s2.amax(dim=-1, keepdim=True)),
                        0.0)
        denom = e.sum(dim=-1, keepdim=True)
        p = e / torch.where(denom > 0, denom, 1.0)
        out = torch.matmul(p, v_sel).reshape(b, 1, h, hd).to(ctx.q.dtype)
        return dataclasses.replace(state, out=out)


def kv_cascade_stages(cfg: KVCascadeConfig) -> tuple:
    """The stage specs one decode step runs, selected by the config."""
    stages: tuple = ()
    if cfg.npages is not None:
        stages += (KVPagePrune(cfg.npages),)
    if cfg.prescreen_c0 is not None:
        stages += (KVSignPrescreen(cfg.prescreen_c0),)
    return stages + (KVApproxTopK(cfg.top_k), KVExactAttend())


def kv_decode_batched(q: torch.Tensor, policy: KVCachePolicy,
                      cfg: KVCascadeConfig) -> torch.Tensor:
    """One decode step's staged KV attention: q (B, 1, H, hd) against the
    policy's cache -> (B, 1, H, hd). Runs on the device of its inputs,
    which must all be on one device."""
    for name, t in vars(policy).items():
        if isinstance(t, torch.Tensor) and t.device != q.device:
            raise ValueError(f"policy.{name} is on {t.device}, the query "
                             f"on {q.device}")
    b, _, h, hd = q.shape
    kh = policy.v.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, hd).to(torch.float32)
    q_codes = q_scale = None
    if cfg.npages is not None or cfg.prescreen_c0 is not None:
        # Integer query operands of the kernel stages: per-head-vector INT8
        # (a per-lane positive scale, applied again to the centroid key so
        # heads compare on equal terms before the group max).
        q_codes, q_scale = quantization.quantize_int8(
            qg.reshape(b * kh * g, hd), per_vector=True)
    ctx = _KVCtx(q=q, qg=qg, policy=policy, cfg=cfg,
                 fns=stage_fns(cfg.backend), q_codes=q_codes,
                 q_scale=q_scale)
    state = _KVState()
    for stage in kv_cascade_stages(cfg):
        state = stage.run(state, ctx)
    return state.out


def kv_plan(cfg: KVCascadeConfig, *, batch: int, kv_heads: int,
            q_heads: int, seq_len: int, head_dim: int,
            layers: int = 1) -> SchedulePlan:
    """The analytic StagePlan ledger of one decode step (all `layers`).

    As in `plan`, `rows` is per lane, a lane here being one sequence (every
    (layer, kv-head, query-head) row it scores), and `bytes_hbm` is what
    the whole batched step streams; price it with
    `energy.cost_cascade(plan.stages, head_dim, batch=batch)` for µJ per
    token per sequence. The no-prune plan equals
    `serve.sparse_kv.sparse_bytes_per_step` exactly."""
    t, hd, g = seq_len, head_dim, q_heads // kv_heads
    lanes = layers * kv_heads          # per sequence
    stages: tuple = ()
    r = t
    if cfg.npages is not None:
        p = -(-t // cfg.page_rows)
        npages = min(cfg.npages, p)
        stages += (StagePlan(
            name="prune", rows=lanes * g * p, bits=4,
            bytes_hbm=batch * lanes * p * (hd // 2 + 4),
            compares=lanes * p),)
        r = npages * cfg.page_rows
    if cfg.prescreen_c0 is not None:
        stages += (StagePlan(
            name="prescreen", rows=lanes * g * r, bits=1,
            bytes_hbm=batch * lanes * r * (hd // 8),
            compares=lanes * r),)
        r = min(cfg.prescreen_c0, r)
    k_eff = min(cfg.top_k, r)
    s1 = batch * lanes * r * (hd // 2 + 4)     # MSB plane + f32 scales
    # The exact stage: both nibble planes (hd bytes) and the scale of each
    # surviving key, and its V row at bf16.
    s2 = batch * lanes * k_eff * (hd + 4 + 2 * hd)
    stages += (StagePlan(name="approx", rows=lanes * g * r, bits=4,
                         bytes_hbm=s1, compares=lanes * r),
               StagePlan(name="exact", rows=lanes * g * 2 * k_eff, bits=8,
                         bytes_hbm=s2, compares=0))
    return SchedulePlan(kind="decode", batch=batch, rows_scanned=r,
                        candidates=k_eff, stage1_bytes=s1,
                        stage1_bytes_vmapped=s1, stage2_bytes=s2,
                        stages=stages)
