"""Public kernel-backed stage functions, drop-ins for the engine's plain
batched primitives (the port of `repro.kernels.ops` for the ported paths).

They pack the query into the kernels' operands and return exactly the
reference wrappers' trimmed shapes; the kernels mask their own ragged
edges, so nothing is padded. CPU tensors take the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitplanar import sign_pm1
from repro_torch.kernels import _build
from repro_torch.kernels.stage0_sign import stage0_sign_gather
from repro_torch.kernels.stage1_gather import (DEFAULT_BLOCK_ROWS,
                                               stage1_int4_gather)
from repro_torch.kernels.stage1_int4 import (stage1_int4_batched,
                                             stage1_int4_rows)
from repro_torch.kernels.stage2_int8 import stage2_int8_batched


def pack_query_panel(q: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 -> (2, B, D//2) int8 batch panels [even; odd dims]."""
    return torch.stack([q[:, 0::2], q[:, 1::2]]).to(torch.int8).contiguous()


def pack_queries_even_odd(q: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 -> (B, 2, D//2) int8 per-lane [even; odd] panels."""
    return torch.stack([q[:, 0::2], q[:, 1::2]], dim=1).to(
        torch.int8).contiguous()


def pack_query_signs(q: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 -> (B, D) int8 in {+1, -1}, the sign kernels' query
    operand; zero maps to +1, as the packed sign plane reads zero bits."""
    return sign_pm1(q)


def stage1_scores_batched(q_msb: torch.Tensor,
                          msb_plane: torch.Tensor) -> torch.Tensor:
    """q_msb (B, D) int8 MSB nibbles x msb_plane (N, D//2) uint8 ->
    (B, N) int32; the plane is streamed once for the whole batch."""
    return stage1_int4_batched(pack_query_panel(q_msb), msb_plane)


def stage1_scores_rows(q_msb: torch.Tensor,
                       msb_rows: torch.Tensor) -> torch.Tensor:
    """q_msb (B, D) int8 nibbles x msb_rows (B, W, D//2) per-lane rows ->
    (B, W) int32."""
    return stage1_int4_rows(pack_queries_even_odd(q_msb), msb_rows)


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
    return stage1_int4_gather(pack_queries_even_odd(q_msb), msb_plane,
                              block_ids, block_rows=block_rows)


def stage1_scores_gather_resident(q_msb: torch.Tensor, plane: torch.Tensor,
                                  block_ids: torch.Tensor, *,
                                  block_rows: int = DEFAULT_BLOCK_ROWS
                                  ) -> torch.Tensor:
    """The block gather over a resident plane that is a whole number of
    blocks and whose every id addresses a live block; raises on a partial
    plane."""
    _check_resident(plane, block_rows, "plane")
    return stage1_int4_gather(pack_queries_even_odd(q_msb), plane,
                              block_ids, block_rows=block_rows)


def stage0_sign_scores_gather(q_sign: torch.Tensor, sign_plane: torch.Tensor,
                              block_ids: torch.Tensor, *,
                              block_rows: int = DEFAULT_BLOCK_ROWS
                              ) -> torch.Tensor:
    """q_sign (B, D) int8 {+1, -1} (`pack_query_signs`); sign_plane
    (N, D//8) uint8; block_ids (B, J) clamped block ids, the table the
    stage-1 gather reads -> (B, J * block_rows) int32 sign-agreement
    scores. Rows past N are zero bytes, all +1, scoring sum(q_sign)."""
    return stage0_sign_gather(q_sign, sign_plane, block_ids,
                              block_rows=block_rows)


def stage0_sign_scores_gather_resident(q_sign: torch.Tensor,
                                       plane: torch.Tensor,
                                       block_ids: torch.Tensor, *,
                                       block_rows: int = DEFAULT_BLOCK_ROWS
                                       ) -> torch.Tensor:
    """The sign gather over a resident sign plane that is a whole number of
    blocks; raises on a partial plane."""
    _check_resident(plane, block_rows, "sign plane")
    return stage0_sign_gather(q_sign, plane, block_ids,
                              block_rows=block_rows)


def centroid_scores_batched(q_msb: torch.Tensor,
                            centroid_msb: torch.Tensor) -> torch.Tensor:
    """The cluster prune's centroid scoring: the codebook is a packed MSB
    nibble plane, so this is the plane kernel over (K, D//2) ->
    (B, K) int32."""
    return stage1_scores_batched(q_msb, centroid_msb)


def stage2_scores_batched(q: torch.Tensor, msb_rows: torch.Tensor,
                          lsb_rows: torch.Tensor) -> torch.Tensor:
    """q (B, D) int8 full queries x gathered msb/lsb_rows (B, C, D//2) ->
    (B, C) int32 exact scores."""
    return stage2_int8_batched(pack_queries_even_odd(q), msb_rows, lsb_rows)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, per kernel."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    _build.reset_launches()
