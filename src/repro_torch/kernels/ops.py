"""Public kernel-backed stage functions, drop-ins for the engine's plain
batched primitives (the port of `repro.kernels.ops` for the main path).

They pack the query into the kernels' even/odd panels and return exactly
the reference wrappers' trimmed shapes; the kernels mask their own ragged
edges, so nothing is padded. CPU tensors take the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
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
