"""Block-gathered stage-1 MSB-nibble (INT4) scoring: wrapper of the CUDA
gather kernel in `csrc/stage1_int4.cu`, which replaces the reference's
`stage1_int4_gather_pallas`.

Lane b scores the plane rows of its block table: view row r is plane row
``block_ids[b, r // block_rows] * block_rows + r % block_rows``. The
kernel reads those rows in place and scores rows past N as 0 without
reading them, so a ragged plane is never padded. Every even D is served
(the rows kernel's widths). A tensor on the CPU goes to the plain version
in `ref`; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_int4 import MAX_GRID_Y, _check, _on_cpu

DEFAULT_BLOCK_ROWS = 64

_GATHER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def check_gather(block_ids: torch.Tensor, b: int, block_rows: int,
                 dev: torch.device) -> int:
    """Checks a (B, J) int32 block table; returns J."""
    _check("block_ids", block_ids, torch.int32, 2, dev)
    if block_ids.shape[0] != b:
        raise ValueError(f"block_ids has {block_ids.shape[0]} lanes, the "
                         f"query {b}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if b > MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    j = block_ids.shape[1]
    if -(-j * block_rows // 256) >= 2 ** 31:
        raise ValueError(f"{j} blocks of {block_rows} rows exceed the "
                         "kernel's grid")
    return j


def stage1_int4_gather(q_eo: torch.Tensor, msb_plane: torch.Tensor,
                       block_ids: torch.Tensor, *,
                       block_rows: int) -> torch.Tensor:
    """q_eo (B, 2, D//2) int8 per-lane [even; odd] nibble panels,
    msb_plane (N, D//2) uint8, block_ids (B, J) int32 ids of
    `block_rows`-row plane blocks (clamped: no -1 holes) ->
    (B, J * block_rows) int32 in block-table order."""
    if _on_cpu(msb_plane):
        return ref.stage1_gather_batched_ref(q_eo, msb_plane, block_ids,
                                             block_rows)
    dev = msb_plane.device
    _check("q_eo", q_eo, torch.int8, 3, dev)
    _check("msb_plane", msb_plane, torch.uint8, 2, dev)
    n, d2 = msb_plane.shape
    b = q_eo.shape[0]
    if q_eo.shape != (b, 2, d2):
        raise ValueError(f"q_eo shape {tuple(q_eo.shape)} does not match "
                         f"the plane's {d2} bytes per row")
    j = check_gather(block_ids, b, block_rows, dev)
    out = torch.empty((b, j * block_rows), dtype=torch.int32, device=dev)
    if out.numel():
        fn = _build.function("stage1_int4", "stage1_gather_launch",
                             _GATHER_ARGS)
        _build.launch("stage1_gather", fn, q_eo.data_ptr(),
                      msb_plane.data_ptr(), block_ids.data_ptr(),
                      out.data_ptr(), b, n, j, block_rows, d2, device=dev)
    return out
