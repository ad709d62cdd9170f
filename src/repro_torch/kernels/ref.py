"""Plain PyTorch versions of the ported kernels.

Each computes exactly what its CUDA kernel computes, mirroring
`repro.kernels.ref`, from the same packed-query operands. The products run
in float64, which is exact for these integer sums. The wrappers use these
for CPU tensors; the tests and `chip_smoke.py` hold the kernels to them.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitplanar import (expand_block_rows, gather_blocks,
                                        unpack_sign_pm1)
from repro_torch.core.engine import MASKED_SCORE
from repro_torch.core.similarity import rerank_dense_comparator, stable_topk

INT32_MIN = -(2 ** 31)


def _sext4(nib: torch.Tensor) -> torch.Tensor:
    """4-bit two's-complement nibble in uint8 -> float64 in [-8, 7]."""
    n = nib.to(torch.float64)
    return torch.where(n >= 8, n - 16, n)


def unpack_even_odd_signed(plane: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D//2) packed uint8 -> signed nibbles of (even dims, odd dims)."""
    return _sext4(plane & 0xF), _sext4((plane >> 4) & 0xF)


def unpack_even_odd_unsigned(plane: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    return (plane & 0xF).to(torch.float64), \
        ((plane >> 4) & 0xF).to(torch.float64)


def stage1_scores_batched_ref(q_panel: torch.Tensor,
                              msb_plane: torch.Tensor) -> torch.Tensor:
    """The plane kernel: q_panel (2, B, D//2) int8 [even; odd] MSB-nibble
    panels, msb_plane (N, D//2) uint8 -> (B, N) int32."""
    even, odd = unpack_even_odd_signed(msb_plane)
    q = q_panel.to(torch.float64)
    return (q[0] @ even.T + q[1] @ odd.T).to(torch.int32)


def stage1_scores_ref(q_eo: torch.Tensor,
                      msb_plane: torch.Tensor) -> torch.Tensor:
    """The plane kernel for one query: q_eo (2, D//2) int8 [even; odd]
    MSB nibbles, msb_plane (N, D//2) uint8 -> (N,) int32."""
    return stage1_scores_batched_ref(q_eo[:, None], msb_plane)[0]


def stage1_rows_batched_ref(q_eo: torch.Tensor,
                            msb_rows: torch.Tensor) -> torch.Tensor:
    """The rows kernel: q_eo (B, 2, D//2) int8, msb_rows (B, W, D//2)
    uint8 -> (B, W) int32, each lane against its own rows."""
    even, odd = unpack_even_odd_signed(msb_rows)
    q = q_eo.to(torch.float64)
    return (torch.bmm(even, q[:, 0, :, None])
            + torch.bmm(odd, q[:, 1, :, None]))[..., 0].to(torch.int32)


def centroid_scores_rows_ref(q_eo: torch.Tensor,
                             centroid_rows: torch.Tensor) -> torch.Tensor:
    """The per-lane centroid scoring of the KV page prune: the rows kernel
    with W = pages. q_eo (B, 2, D//2), centroid_rows (B, P, D//2) ->
    (B, P) int32."""
    return stage1_rows_batched_ref(q_eo, centroid_rows)


def stage1_gather_batched_ref(q_eo: torch.Tensor, msb_plane: torch.Tensor,
                              block_ids: torch.Tensor,
                              block_rows: int) -> torch.Tensor:
    """The gather kernel: q_eo (B, 2, D//2), msb_plane (N, D//2), block_ids
    (B, J) int32 clamped block ids -> (B, J * block_rows) int32; rows past
    the plane's end read as zero rows and score 0 (`gather_blocks`)."""
    gathered, _ = gather_blocks(msb_plane, block_ids, block_rows)
    return stage1_rows_batched_ref(q_eo, gathered)


def stage1_gather_resident_ref(q_eo: torch.Tensor, plane: torch.Tensor,
                               block_ids: torch.Tensor,
                               block_rows: int) -> torch.Tensor:
    """The gather kernel over a resident plane whose every block id is
    live: a pure gather and score, no zero-row convention."""
    rows = expand_block_rows(block_ids, block_rows)
    return stage1_rows_batched_ref(q_eo, plane[rows.long()])


def _sign_dot(q_sign: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 signs x (B, R, D//8) packed sign rows -> (B, R) int32."""
    docs = unpack_sign_pm1(rows).to(torch.float64)
    return torch.bmm(docs, q_sign.to(torch.float64)[:, :, None])[..., 0].to(
        torch.int32)


def stage0_sign_batched_ref(q_sign: torch.Tensor,
                            sign_plane: torch.Tensor) -> torch.Tensor:
    """The dense sign kernel: q_sign (B, D) int8 in {+1, -1}, sign_plane
    (N, D//8) uint8 -> (B, N) int32 ``sum_k q_sign[k] * sign(d_k)``."""
    docs = unpack_sign_pm1(sign_plane).to(torch.float64)
    return (q_sign.to(torch.float64) @ docs.T).to(torch.int32)


def check_group(b: int, group: int, tables: int) -> None:
    """Raises unless `group` divides the B lanes and the block table has
    one row per group of lanes (B / group rows)."""
    if group < 1 or b % group:
        raise ValueError(f"group {group} does not divide the {b} query "
                         "lanes")
    if tables != b // group:
        raise ValueError(f"block_ids has {tables} rows; {b} lanes in groups "
                         f"of {group} need {b // group}")


def stage0_sign_gather_ref(q_sign: torch.Tensor, sign_plane: torch.Tensor,
                           block_ids: torch.Tensor, block_rows: int, *,
                           group: int = 1) -> torch.Tensor:
    """The sign gather kernel: q_sign (B, D) int8 in {+1, -1}, sign_plane
    (N, D//8) uint8, block_ids (B / group, J) int32 clamped block ids, row
    t serving lanes t * group ... t * group + group - 1 ->
    (B, J * block_rows) int32 ``sum_k q_sign[k] * sign(d_k)``. Rows past
    the plane's end gather zero bytes, all +1, scoring ``sum_k
    q_sign[k]``. The grouped table is repeated to one row per lane."""
    check_group(q_sign.shape[0], group, block_ids.shape[0])
    if group > 1:
        block_ids = block_ids.repeat_interleave(group, 0)
    gathered, _ = gather_blocks(sign_plane, block_ids, block_rows)
    return _sign_dot(q_sign, gathered)


def stage0_sign_gather_resident_ref(q_sign: torch.Tensor,
                                    sign_plane: torch.Tensor,
                                    block_ids: torch.Tensor,
                                    block_rows: int) -> torch.Tensor:
    """The sign gather over a resident sign plane whose every block id is
    live: no zero-byte convention."""
    rows = expand_block_rows(block_ids, block_rows)
    return _sign_dot(q_sign, sign_plane[rows.long()])


def stage2_scores_batched_ref(q_eo8: torch.Tensor, msb_rows: torch.Tensor,
                              lsb_rows: torch.Tensor) -> torch.Tensor:
    """The exact kernel: q_eo8 (B, 2, D//2) int8 full query values,
    msb/lsb_rows (B, C, D//2) uint8 -> (B, C) int32 exact INT8 scores."""
    me, mo = unpack_even_odd_signed(msb_rows)
    le, lo = unpack_even_odd_unsigned(lsb_rows)
    q = q_eo8.to(torch.float64)
    return (torch.bmm(me * 16 + le, q[:, 0, :, None])
            + torch.bmm(mo * 16 + lo, q[:, 1, :, None]))[..., 0].to(
                torch.int32)


def stage2_scores_by_id_ref(q_eo8: torch.Tensor, msb_plane: torch.Tensor,
                            lsb_plane: torch.Tensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """The exact kernel by id: q_eo8 (B, 2, D//2), msb/lsb_plane (N, D//2),
    ids (B, C) int32 -> (B, C) int32. Ids are clamped to [0, N - 1], as
    JAX's indexing `x[ids]` clamps them (the reference engine's `jnp.take`
    fills instead; the engine never passes an id >= N), then the rows are
    gathered and scored."""
    safe = ids.clamp(0, msb_plane.shape[0] - 1).long()
    return stage2_scores_batched_ref(q_eo8, msb_plane[safe], lsb_plane[safe])


def _rank(scores: torch.Tensor, norms: torch.Tensor, k: int,
          metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C) scores and norms -> (top-k candidate positions (B, k) int64,
    their scores (B, k) int32): the non-division cosine rerank or the
    MIPS top-k, ties toward the lower position."""
    if metric == "cosine":
        return rerank_dense_comparator(scores, norms, k)
    if metric == "mips":
        top, local = stable_topk(scores, k)
        return local, top
    raise ValueError(f"metric must be one of ('cosine', 'mips'), got "
                     f"{metric!r}")


def exact_rerank_by_id_ref(q: torch.Tensor, msb_plane: torch.Tensor,
                           lsb_plane: torch.Tensor, ids: torch.Tensor,
                           norms_sq: torch.Tensor,
                           member: torch.Tensor | None, *, k: int,
                           metric: str
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The exact-stage kernel: q (B, D) int8, msb/lsb_plane (N, D//2),
    ids (B, C) int32, norms_sq (N,) int32, member (B, C) bool or None ->
    (indices (B, k), scores (B, k), candidate_indices (B, C)) int32: the
    by-id exact scores, then `pin_and_rerank_ref`."""
    q_eo8 = torch.stack([q[:, 0::2], q[:, 1::2]], dim=1).to(torch.int8)
    exact = stage2_scores_by_id_ref(q_eo8, msb_plane, lsb_plane, ids)
    return pin_and_rerank_ref(exact, ids, norms_sq, member, k=k,
                              metric=metric)


def pin_and_rerank_ref(exact: torch.Tensor, ids: torch.Tensor,
                       norms_sq: torch.Tensor, member: torch.Tensor | None,
                       *, k: int, metric: str
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact stage after the (B, C) exact scores, as the engine
    composed it before the kernel: the norms at ids clamped to [0, N - 1],
    non-members pinned to (MASKED_SCORE, 1), the rerank, then -1 / 0 / -1
    at non-members."""
    cand_norms = norms_sq[ids.clamp(0, norms_sq.shape[0] - 1).long()]
    if member is not None:
        exact = exact.masked_fill(~member, MASKED_SCORE)
        cand_norms = cand_norms.masked_fill(~member, 1)
    local, top = _rank(exact, cand_norms, k, metric)
    indices = torch.gather(ids, 1, local)
    if member is None:
        return indices, top, ids
    valid = torch.gather(member, 1, local)
    return (indices.masked_fill(~valid, -1), top.masked_fill(~valid, 0),
            ids.masked_fill(~member, -1))


def rerank_ref(scores: torch.Tensor, norms: torch.Tensor, ids: torch.Tensor,
               *, k: int, metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The rerank kernel: (B, C) int32 scores, norms and ids -> (ids at
    the top k (B, k) int32, their scores (B, k) int32)."""
    local, top = _rank(scores, norms, k, metric)
    return torch.gather(ids, 1, local), top


def stage2_scores_ref(q_eo8: torch.Tensor, msb_rows: torch.Tensor,
                      lsb_rows: torch.Tensor) -> torch.Tensor:
    """The exact kernel for one query: q_eo8 (2, D//2), msb/lsb_rows
    (C, D//2) -> (C,) int32."""
    return stage2_scores_batched_ref(q_eo8[None], msb_rows[None],
                                     lsb_rows[None])[0]


def blockwise_topk(scores: torch.Tensor, block_n: int,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) int32 scores, N a multiple of block_n -> (scores, global ids)
    (B, N // block_n, k) int32: the reference's per-block iterative argmax
    in closed form. Each pick takes the largest score, ties toward the
    lower row, and sets it to INT32_MIN; so the first L = min(k, live)
    picks are the live (non-INT32_MIN) entries in stable descending order,
    and every later pick, over an all-INT32_MIN block, is argmax's index
    0: (INT32_MIN, the block's first row), repeated."""
    b, n = scores.shape
    nb = n // block_n
    blocks = scores.reshape(b, nb, block_n)
    kk = min(k, block_n)
    vals, idx = stable_topk(blocks, kk)
    live = (blocks != INT32_MIN).sum(-1, keepdim=True)
    dead = torch.arange(kk, device=scores.device) >= live
    vals = vals.masked_fill(dead, INT32_MIN)
    idx = idx.masked_fill(dead, 0)
    if k > kk:
        vals = torch.cat([vals, vals.new_full((b, nb, k - kk), INT32_MIN)], -1)
        idx = torch.cat([idx, idx.new_zeros((b, nb, k - kk))], -1)
    base = torch.arange(nb, device=scores.device)[:, None] * block_n
    return vals, (idx + base).to(torch.int32)


def fused_topk_batched_ref(q_eo: torch.Tensor, msb_plane: torch.Tensor,
                           block_n: int, k: int,
                           owner: torch.Tensor | None = None,
                           tenant_ids: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel: q_eo (B, 2, D//2), msb_plane (N, D//2), optionally
    owner (N,) and tenant_ids (B,) int32 (rows outside the lane's tenant,
    or every row of a lane with tid < 0, score INT32_MIN) -> (scores,
    global ids), each (B, ceil(N / block_n), k) int32. A ragged plane is
    taken as zero-padded to a block multiple (padding rows score 0, owner
    -1), as the reference wrapper pads it."""
    n, d2 = msb_plane.shape
    pad = -n % block_n
    if pad:
        msb_plane = torch.cat([msb_plane,
                               msb_plane.new_zeros((pad, d2))])
    scores = stage1_scores_batched_ref(q_eo.transpose(0, 1), msb_plane)
    if owner is not None:
        if pad:
            owner = torch.cat([owner, owner.new_full((pad,), -1)])
        member = ((owner[None, :] == tenant_ids[:, None])
                  & (tenant_ids >= 0)[:, None])
        scores = scores.masked_fill(~member, INT32_MIN)
    return blockwise_topk(scores, block_n, k)


def fused_topk_ref(q_eo: torch.Tensor, msb_plane: torch.Tensor, block_n: int,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel for one query, unmasked: q_eo (2, D//2) ->
    (scores, global ids), each (ceil(N / block_n), k) int32."""
    scores, ids = fused_topk_batched_ref(q_eo[None], msb_plane, block_n, k)
    return scores[0], ids[0]
