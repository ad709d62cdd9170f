"""Public kernel-backed stage functions, drop-ins for the engine's plain
batched primitives (the port of `repro.kernels.ops`).

They pack the query into the kernels' operands and return exactly the
reference wrappers' trimmed shapes; the kernels mask their own ragged
edges, so nothing is padded. CPU tensors take the plain versions.

Block knobs: the tunable wrappers (the stage-1 plane, single-query and
rows scans, the dense sign scan and the fused top-k) take `block_n` (or
`block_w`) None and resolve it from the installed `autotune` table for
the family and batch bucket, falling back to the kernel's default when no
table is installed. For the scans the knob is rows per thread block, a
schedule choice that never changes a result; for the fused top-k it is
the reference's `block_n`. Pass an explicit value to bypass the table.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitplanar import sign_pm1
from repro_torch.core.similarity import stable_topk
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.fused_topk import (fused_topk_batched,
                                            fused_topk_single)
from repro_torch.kernels.ref import INT32_MIN
from repro_torch.kernels.stage0_sign import (stage0_sign_batched,
                                             stage0_sign_gather)
from repro_torch.kernels.stage1_gather import (DEFAULT_BLOCK_ROWS,
                                               stage1_nibble_gather)
from repro_torch.kernels.stage1_int4 import (DEFAULT_ROWS,
                                             pack_queries_even_odd,
                                             stage1_int4_batched,
                                             stage1_int4_rows,
                                             stage1_int4_single)
from repro_torch.kernels.stage2_int8 import (stage2_int8_batched,
                                             stage2_int8_by_id,
                                             stage2_int8_rerank_by_id,
                                             stage2_int8_single,
                                             stage2_rerank)


def _block(kernel: str, batch: int, block: int | None) -> int:
    if block is None:
        return autotune.lookup(kernel, batch, autotune.default_block(kernel))
    return block


def pack_query_even_odd(q: torch.Tensor) -> torch.Tensor:
    """(D,) int8 -> (2, D//2) int8: row 0 even dims, row 1 odd dims."""
    return torch.stack([q[0::2], q[1::2]]).to(torch.int8).contiguous()


def pack_query_panel(q: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 -> (2, B, D//2) int8 batch panels [even; odd dims]."""
    return torch.stack([q[:, 0::2], q[:, 1::2]]).to(torch.int8).contiguous()


def pack_query_signs(q: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 -> (B, D) int8 in {+1, -1}, the sign kernels' query
    operand; zero maps to +1, as the packed sign plane reads zero bits."""
    return sign_pm1(q)


def stage1_scores(q_msb: torch.Tensor, msb_plane: torch.Tensor,
                  block_n: int | None = None) -> torch.Tensor:
    """One query: q_msb (D,) int8 MSB nibbles x msb_plane (N, D//2) uint8
    -> (N,) int32. block_n None -> the table's rows per block for
    "stage1_single" (default 256)."""
    return stage1_int4_single(pack_query_even_odd(q_msb), msb_plane,
                              rows=_block("stage1_single", 1, block_n))


def stage2_scores(q: torch.Tensor, msb_rows: torch.Tensor,
                  lsb_rows: torch.Tensor) -> torch.Tensor:
    """One query: q (D,) int8 full query codes x gathered msb/lsb_rows
    (C, D//2) -> (C,) int32 exact scores. (The reference's `block_c`
    schedule knob has no counterpart: the exact kernel takes one warp per
    row.)"""
    return stage2_int8_single(pack_query_even_odd(q), msb_rows, lsb_rows)


def stage1_scores_batched(q_msb: torch.Tensor, msb_plane: torch.Tensor,
                          block_n: int | None = None) -> torch.Tensor:
    """q_msb (B, D) int8 MSB nibbles x msb_plane (N, D//2) uint8 ->
    (B, N) int32; the plane is streamed once for the whole batch. block_n
    None -> the table's rows per block for "stage1_batched" at this batch
    bucket (default 256)."""
    rows = _block("stage1_batched", q_msb.shape[0], block_n)
    return stage1_int4_batched(pack_query_panel(q_msb), msb_plane, rows=rows)


def stage1_scores_rows(q_msb: torch.Tensor, msb_rows: torch.Tensor,
                       block_w: int | None = None) -> torch.Tensor:
    """q_msb (B, D) int8 nibbles x msb_rows (B, W, D//2) per-lane rows ->
    (B, W) int32. block_w None -> the table's rows per block for
    "stage1_rows" (default 256)."""
    rows = _block("stage1_rows", q_msb.shape[0], block_w)
    return stage1_int4_rows(pack_queries_even_odd(q_msb), msb_rows,
                            rows=rows)


def _check_resident(plane: torch.Tensor, block_rows: int, what: str) -> None:
    n = plane.shape[0]
    if n % block_rows:
        raise ValueError(f"resident {what} must be a block multiple, got "
                         f"{n} rows with block_rows={block_rows}")


def stage1_scores_gather(q_msb: torch.Tensor, msb_plane: torch.Tensor,
                         block_ids: torch.Tensor, *,
                         block_rows: int = DEFAULT_BLOCK_ROWS
                         ) -> torch.Tensor:
    """q_msb (B, D) int8 nibbles; msb_plane (N, D//2) uint8; block_ids
    (B, J) int32 ids of `block_rows`-row plane blocks, clamped to valid
    blocks -> (B, J * block_rows) int32. Only the selected blocks are read;
    rows past N score 0, and a ragged plane is not padded (the reference
    pads it every launch)."""
    return stage1_nibble_gather(q_msb, msb_plane, block_ids,
                                block_rows=block_rows)


def stage1_scores_gather_resident(q_msb: torch.Tensor, plane: torch.Tensor,
                                  block_ids: torch.Tensor, *,
                                  block_rows: int = DEFAULT_BLOCK_ROWS
                                  ) -> torch.Tensor:
    """The block gather over a resident plane that is a whole number of
    blocks and whose every id addresses a live block; raises on a partial
    plane. Its TMA launches count under `stage1_gather_resident`."""
    _check_resident(plane, block_rows, "plane")
    return stage1_nibble_gather(q_msb, plane, block_ids,
                                block_rows=block_rows,
                                counter="stage1_gather_resident")


def stage0_sign_scores_batched(q_sign: torch.Tensor, sign_plane: torch.Tensor,
                               block_n: int | None = None) -> torch.Tensor:
    """q_sign (B, D) int8 {+1, -1} (`pack_query_signs`); sign_plane
    (N, D//8) uint8 -> (B, N) int32 sign-agreement scores, the plane
    streamed once for the whole batch. block_n None -> the table's rows per
    block for "stage0_sign" (default 256)."""
    rows = _block("stage0_sign", q_sign.shape[0], block_n)
    return stage0_sign_batched(q_sign, sign_plane, rows=rows)


def stage0_sign_scores_gather(q_sign: torch.Tensor, sign_plane: torch.Tensor,
                              block_ids: torch.Tensor, *,
                              block_rows: int = DEFAULT_BLOCK_ROWS,
                              group: int = 1) -> torch.Tensor:
    """q_sign (B, D) int8 {+1, -1} (`pack_query_signs`); sign_plane
    (N, D//8) uint8; block_ids (B / group, J) clamped block ids, the table
    the stage-1 gather reads, row t serving lanes t * group ... t * group
    + group - 1 -> (B, J * block_rows) int32 sign-agreement scores, the
    per-lane call's on the table repeated `group` times. Rows past N are
    zero bytes, all +1, scoring sum(q_sign)."""
    return stage0_sign_gather(q_sign, sign_plane, block_ids,
                              block_rows=block_rows, group=group)


def stage0_sign_scores_gather_resident(q_sign: torch.Tensor,
                                       plane: torch.Tensor,
                                       block_ids: torch.Tensor, *,
                                       block_rows: int = DEFAULT_BLOCK_ROWS
                                       ) -> torch.Tensor:
    """The sign gather over a resident sign plane that is a whole number of
    blocks; raises on a partial plane. Its launches count under
    `stage0_sign_gather_resident`."""
    _check_resident(plane, block_rows, "sign plane")
    return stage0_sign_gather(q_sign, plane, block_ids,
                              block_rows=block_rows,
                              counter="stage0_sign_gather_resident")


def centroid_scores_batched(q_msb: torch.Tensor,
                            centroid_msb: torch.Tensor) -> torch.Tensor:
    """The cluster prune's centroid scoring: the codebook is a packed MSB
    nibble plane, so this is the plane kernel over (K, D//2) ->
    (B, K) int32, at the default block (untuned, as in the reference)."""
    return stage1_scores_batched(q_msb, centroid_msb, block_n=DEFAULT_ROWS)


def centroid_scores_rows(q_msb: torch.Tensor, centroid_rows: torch.Tensor,
                         block_p: int | None = None) -> torch.Tensor:
    """The KV page prune's per-lane centroid scoring: each lane scores its
    own page-centroid codebook, (B, P, D//2) packed MSB nibbles, so this
    is the rows kernel (#2) with W = pages: q_msb (B, D) int8 nibbles ->
    (B, P) int32. block_p None -> the table's rows per block for
    "stage1_rows"."""
    return stage1_scores_rows(q_msb, centroid_rows, block_w=block_p)


def stage2_scores_batched(q: torch.Tensor, msb_rows: torch.Tensor,
                          lsb_rows: torch.Tensor) -> torch.Tensor:
    """q (B, D) int8 full queries x gathered msb/lsb_rows (B, C, D//2) ->
    (B, C) int32 exact scores."""
    return stage2_int8_batched(pack_queries_even_odd(q), msb_rows, lsb_rows)


def stage2_scores_by_id(q: torch.Tensor, msb_plane: torch.Tensor,
                        lsb_plane: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """q (B, D) int8 full queries x the rows of msb/lsb_plane (N, D//2) at
    ids (B, C) int32, clamped to [0, N - 1] -> (B, C) int32 exact scores;
    the rows are read in place, not gathered."""
    return stage2_int8_by_id(pack_queries_even_odd(q), msb_plane, lsb_plane,
                             ids)


# The engine's whole exact stage in one launch, from the (B, D) query, and
# its ranking half (`ShardedIndex`'s final rerank): see `stage2_int8`.
exact_rerank_by_id = stage2_int8_rerank_by_id
rerank = stage2_rerank


def _merge_blocks(scores: torch.Tensor, ids: torch.Tensor, n: int,
                  c: int) -> torch.Tensor:
    """Cross-block top-c of the fused kernel's (B, nb, k) output -> (B, c)
    ids: padding rows (id >= n) are masked to INT32_MIN, ties go to the
    lower flattened position, as `jax.lax.top_k` breaks them."""
    flat_s = scores.reshape(scores.shape[0], -1)
    flat_i = ids.reshape(ids.shape[0], -1)
    flat_s = flat_s.masked_fill(flat_i >= n, INT32_MIN)
    _, sel = stable_topk(flat_s, c)
    return torch.gather(flat_i, 1, sel)


def fused_candidates_batched(q_msb: torch.Tensor, msb_plane: torch.Tensor,
                             owner: torch.Tensor | None = None,
                             tenant_ids: torch.Tensor | None = None, *,
                             c: int, k_per_block: int = 8,
                             block_n: int | None = None) -> torch.Tensor:
    """Batched stage-1 candidates through the fused score + per-block top-k
    kernel, optionally with each lane's tenant mask applied inside it:
    q_msb (B, D) int8 nibbles -> (B, c) int32 global doc ids. Exact (the
    dense masked top-c, in order) whenever k_per_block >= c; lanes whose
    live segment is smaller than c fill with masked entries. block_n None
    -> the table's block for "fused_topk" (default 512); it is clamped to
    max(8, N) as the reference clamps it."""
    n = msb_plane.shape[0]
    block_n = min(_block("fused_topk", q_msb.shape[0], block_n), max(8, n))
    scores, ids = fused_topk_batched(pack_queries_even_odd(q_msb), msb_plane,
                                     owner, tenant_ids, k=k_per_block,
                                     block_n=block_n)
    return _merge_blocks(scores, ids, n, c)


def fused_candidates(q_msb: torch.Tensor, msb_plane: torch.Tensor, *, c: int,
                     k_per_block: int = 8,
                     block_n: int | None = None) -> torch.Tensor:
    """One query: q_msb (D,) int8 nibbles -> (c,) int32 global doc ids, the
    approximate stage-1 top-c (exact whenever k_per_block >= c). block_n
    None -> the table's block for "fused_topk" at batch 1 (default 512)."""
    n = msb_plane.shape[0]
    block_n = min(_block("fused_topk", 1, block_n), max(8, n))
    scores, ids = fused_topk_single(pack_query_even_odd(q_msb), msb_plane,
                                    k=k_per_block, block_n=block_n)
    return _merge_blocks(scores[None], ids[None], n, c)[0]


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, per kernel."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    _build.reset_launches()
