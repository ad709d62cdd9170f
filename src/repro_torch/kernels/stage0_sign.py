"""Stage-0 sign-agreement scoring over the packed sign plane: wrappers of
the CUDA kernels in `csrc/stage0_sign.cu` and `csrc/stage0_sign_mma.cu`.
`stage0_sign_batched` replaces the reference's `stage0_sign_batched_pallas`
(a dense scan of the whole plane, streamed once per batch),
`stage0_sign_gather` its `stage0_sign_gather_pallas` (gathered blocks).

Lane b scores sign-plane rows against its +-1 query signs: ``sum_k
q_sign[k] * (1 - 2 * bit_k)``. The popcount kernels (the dense
`sign_plane_kernel` and the gather) score from the query's sign bits
(bit set where q_sign < 0) as D - 2 * popc(qbits ^ dbits), which equals
the +-1 dot exactly for a query of +-1 signs, the operand
`ops.pack_query_signs` makes; it is the contract of both wrappers. In the
gather, rows past N are zero bytes, all +1, and score ``sum_k
q_sign[k]``; the kernel computes that without a read, so a ragged plane
is never padded. A tensor on the CPU goes to the plain version in `ref`;
a CUDA tensor launches the kernel or raises. Widths: every D % 8 == 0
whose packed signs (D/8 bytes per lane) fit one block's shared memory.

The dense scan has two kernels, chosen by shape: the int8 tensor-core
kernel of `stage0_sign_mma.cu` (counted `stage0_sign_plane_mma`; the sign
bits as `mma.sync` masks against the query's eight sub-panels) wherever
its launcher takes the shape (`_mma_lanes`: B >= 2, D % 128 == 0,
0 < N < 2^31 and a lane tile whose panels fit in shared memory beside its
ring), else the popcount `sign_plane_kernel` (counted `stage0_sign_plane`).
Both give the same bits; a failed build or launch of the chosen one
raises. `_sign_plane(..., route=)` asks for one of them, for tests and
measurements.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_gather import check_gather, check_gather_grid
from repro_torch.kernels.stage1_int4 import (DEFAULT_ROWS, MAX_GRID_Y,
                                             _check, _on_cpu, check_rows,
                                             check_smem)

_SIGN_GATHER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
_SIGN_PLANE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]
_LANES_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_int]
_ROUTES = ("auto", "mma", "popc")


def _mma_lanes(b: int, n: int, d8: int, rows: int) -> int:
    """The tensor-core sign kernel's lane tile for B lanes over an N-row
    plane of D/8 bytes per row at `rows` rows per tile, as its launcher
    decides it; 0 when that kernel does not take the shape."""
    return _build.function("stage0_sign_mma", "stage0_sign_mma_lanes",
                           _LANES_ARGS)(b, n, d8, rows)


def _check_signs(kernel: str, q_sign: torch.Tensor, sign_plane: torch.Tensor,
                 dev: torch.device) -> int:
    """Checks the (B, D) query signs against the (N, D/8) plane; returns D."""
    _check("q_sign", q_sign, torch.int8, 2, dev)
    _check("sign_plane", sign_plane, torch.uint8, 2, dev)
    d = q_sign.shape[1]
    if d != 8 * sign_plane.shape[1]:
        raise ValueError(f"q_sign has D = {d}, the sign plane "
                         f"{sign_plane.shape[1]} bytes per row")
    check_smem(kernel, f"D = {d}", -(-d // 32) * 4)
    return d


def _sign_plane(q_sign: torch.Tensor, sign_plane: torch.Tensor, rows: int,
                *, route: str = "auto") -> torch.Tensor:
    """Launches a dense sign kernel: (B, N) int32. `route` "auto" takes the
    tensor-core kernel wherever its launcher takes the shape, else the
    popcount kernel; "mma" and "popc" ask for one. CUDA tensors only."""
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    dev = sign_plane.device
    d = _check_signs("sign plane", q_sign, sign_plane, dev)
    b, n = q_sign.shape[0], sign_plane.shape[0]
    if b > MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    if route != "popc":
        takes = bool(_mma_lanes(b, n, d // 8, rows))
        if route == "mma" and not takes:
            raise ValueError(f"the tensor-core sign kernel does not take "
                             f"B = {b}, N = {n}, D = {d} at {rows} rows per "
                             "tile: it needs B >= 2, D % 128 == 0, 0 < N < "
                             "2^31 and panels that fit in shared memory "
                             "(stage0_sign_mma_lanes in "
                             "csrc/stage0_sign_mma.cu)")
        route = "mma" if takes else "popc"
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    if out.numel():
        if route == "mma":
            fn = _build.function("stage0_sign_mma", "stage0_sign_mma_launch",
                                 _SIGN_PLANE_ARGS)
            counter = "stage0_sign_plane_mma"
        else:
            fn = _build.function("stage0_sign", "stage0_sign_plane_launch",
                                 _SIGN_PLANE_ARGS)
            counter = "stage0_sign_plane"
        _build.launch(counter, fn, q_sign.data_ptr(), sign_plane.data_ptr(),
                      out.data_ptr(), b, n, d, rows, device=dev)
    return out


def stage0_sign_batched(q_sign: torch.Tensor, sign_plane: torch.Tensor, *,
                        rows: int = DEFAULT_ROWS) -> torch.Tensor:
    """q_sign (B, D) int8 in {+1, -1}, sign_plane (N, D//8) uint8 ->
    (B, N) int32 sign-agreement scores, on the tensor-core kernel wherever
    it takes the shape, else on the popcount kernel. `rows`: sign rows per
    thread block or tile (the autotuner's "stage0_sign" knob; it never
    changes a result)."""
    check_rows(rows)
    if _on_cpu(sign_plane):
        return ref.stage0_sign_batched_ref(q_sign, sign_plane)
    return _sign_plane(q_sign, sign_plane, rows)


def stage0_sign_gather(q_sign: torch.Tensor, sign_plane: torch.Tensor,
                       block_ids: torch.Tensor, *, block_rows: int,
                       counter: str = "stage0_sign_gather") -> torch.Tensor:
    """q_sign (B, D) int8 in {+1, -1}, sign_plane (N, D//8) uint8,
    block_ids (B, J) int32 clamped block ids -> (B, J * block_rows) int32
    sign-agreement scores in block-table order. `counter`: the key the
    launch counts under (the resident wrapper's is
    `stage0_sign_gather_resident`)."""
    if _on_cpu(sign_plane):
        return ref.stage0_sign_gather_ref(q_sign, sign_plane, block_ids,
                                          block_rows)
    dev = sign_plane.device
    d = _check_signs("sign gather", q_sign, sign_plane, dev)
    n, b = sign_plane.shape[0], q_sign.shape[0]
    j = check_gather(block_ids, b, block_rows, dev)
    check_gather_grid(b, j, block_rows)
    out = torch.empty((b, j * block_rows), dtype=torch.int32, device=dev)
    if out.numel():
        fn = _build.function("stage0_sign", "stage0_sign_gather_launch",
                             _SIGN_GATHER_ARGS)
        _build.launch(counter, fn, q_sign.data_ptr(),
                      sign_plane.data_ptr(), block_ids.data_ptr(),
                      out.data_ptr(), b, n, j, block_rows, d, device=dev)
    return out
