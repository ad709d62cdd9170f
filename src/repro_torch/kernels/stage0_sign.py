"""Stage-0 sign-agreement scoring over the packed sign plane: wrappers of
the CUDA kernels in `csrc/stage0_sign.cu`, `csrc/stage0_sign_mma.cu` and
`csrc/stage0_sign_gather.cu`.
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

The gather has two kernels, chosen by shape: the bulk-copy kernel of
`stage0_sign_gather.cu` (`sign_bulk_kernel`: whole blocks by 1D bulk async
copy into a shared-memory ring, each block read once for every lane of
its group) wherever its launcher takes the shape and chooses it
(`_bulk_takes` answers 2: rows of 4, 8 or 16 bytes with block_rows % 4 ==
0, the decode widths; (N % block_rows) * D/8 % 16 == 0; a 16-byte aligned
plane; 0 < N < 2^31; a ring and packed signs that fit in shared memory),
else the popcount `sign_gather_kernel` of
`stage0_sign.cu`. Both count under the caller's key
(`stage0_sign_gather`, or `stage0_sign_gather_resident` for the resident
wrapper) and give the same bits; a failed build or launch of the chosen
one raises. The bulk kernel also takes rows of 32, 64 and 128 bytes
(`_bulk_takes` answers 1), where the popcount kernel was as fast or
faster on an H100 (PERF.md), so only `route="bulk"` runs it there.
`stage0_sign_gather(..., route=)` asks for one of them. With
`group` > 1 the block table has one row per `group` consecutive lanes
(the decode prescreen's query heads of one KV head): the same function as
the per-lane call on the table repeated, with fewer operand bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_gather import check_gather_grid
from repro_torch.kernels.stage1_int4 import (DEFAULT_ROWS, MAX_GRID_Y,
                                             _check, _on_cpu, check_rows,
                                             check_smem)

_SIGN_GATHER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
_BULK_TAKES_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int]
_SIGN_PLANE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]
_LANES_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_int]
_ROUTES = ("auto", "mma", "popc")
_GATHER_ROUTES = ("auto", "bulk", "popc")


def _mma_lanes(b: int, n: int, d8: int, rows: int) -> int:
    """The tensor-core sign kernel's lane tile for B lanes over an N-row
    plane of D/8 bytes per row at `rows` rows per tile, as its launcher
    decides it; 0 when that kernel does not take the shape."""
    return _build.function("stage0_sign_mma", "stage0_sign_mma_lanes",
                           _LANES_ARGS)(b, n, d8, rows)


def _bulk_takes(plane_ptr: int, n: int, d8: int, block_rows: int,
                group: int) -> int:
    """The bulk-copy sign gather's answer for an N-row plane of D/8 bytes
    at address `plane_ptr` in `block_rows`-row blocks for tables shared by
    `group` lanes, as its launcher gives it: 2 it takes the shape and the
    route chooses it, 1 it takes the shape but the route keeps the
    popcount kernel, 0 it does not take the shape."""
    return _build.function("stage0_sign_gather", "stage0_sign_bulk_takes",
                           _BULK_TAKES_ARGS)(plane_ptr, n, d8, block_rows,
                                             group)


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


def check_sign_table(block_ids: torch.Tensor, b: int, group: int,
                     block_rows: int, dev: torch.device) -> int:
    """Checks a (B / group, J) int32 block table for B lanes; returns J."""
    _check("block_ids", block_ids, torch.int32, 2, dev)
    ref.check_group(b, group, block_ids.shape[0])
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    return block_ids.shape[1]


def stage0_sign_gather(q_sign: torch.Tensor, sign_plane: torch.Tensor,
                       block_ids: torch.Tensor, *, block_rows: int,
                       group: int = 1, route: str = "auto",
                       counter: str = "stage0_sign_gather") -> torch.Tensor:
    """q_sign (B, D) int8 in {+1, -1}, sign_plane (N, D//8) uint8,
    block_ids (B / group, J) int32 clamped block ids, row t serving lanes
    t * group ... t * group + group - 1 -> (B, J * block_rows) int32
    sign-agreement scores in block-table order. `route` "auto" takes the
    bulk-copy kernel wherever its launcher chooses it for the shape, else
    the popcount kernel; "bulk" and "popc" ask for one. `counter`: the key
    either route's launch counts under (the resident wrapper's is
    `stage0_sign_gather_resident`)."""
    if route not in _GATHER_ROUTES:
        raise ValueError(f"route must be one of {_GATHER_ROUTES}, got "
                         f"{route!r}")
    if sign_plane.device.type == "meta":
        return _build.abstract(counter, (q_sign.shape[0],
                                         block_ids.shape[1] * block_rows))
    if _on_cpu(sign_plane):
        return ref.stage0_sign_gather_ref(q_sign, sign_plane, block_ids,
                                          block_rows, group=group)
    dev = sign_plane.device
    d = _check_signs("sign gather", q_sign, sign_plane, dev)
    n, b = sign_plane.shape[0], q_sign.shape[0]
    j = check_sign_table(block_ids, b, group, block_rows, dev)
    if route != "popc":
        answer = _bulk_takes(sign_plane.data_ptr(), n, d // 8, block_rows,
                             group)
        if route == "bulk" and not answer:
            raise ValueError(f"the bulk sign gather does not take N = {n}, "
                             f"D = {d}, block_rows = {block_rows}, group = "
                             f"{group}: it needs rows of 4, 8 or 16 bytes "
                             "with block_rows % 4 == 0 or of 32, 64 or 128 "
                             "bytes, (N % block_rows) * D/8 a multiple of "
                             "16, 0 < N < 2^31 and a ring and packed signs "
                             "that fit in shared memory "
                             "(stage0_sign_bulk_takes in "
                             "csrc/stage0_sign_gather.cu)")
        route = "bulk" if answer == 2 or route == "bulk" else "popc"
    if route == "popc":
        check_gather_grid(b, j, block_rows)
    elif b >= 2 ** 31 or j >= 2 ** 31:
        raise ValueError(f"{b} lanes of {j} blocks exceed the bulk sign "
                         "gather launcher's int arguments (B, J < 2^31)")
    out = torch.empty((b, j * block_rows), dtype=torch.int32, device=dev)
    if out.numel():
        if route == "bulk":
            fn = _build.function("stage0_sign_gather",
                                 "stage0_sign_bulk_launch", _SIGN_GATHER_ARGS)
        else:
            fn = _build.function("stage0_sign", "stage0_sign_gather_launch",
                                 _SIGN_GATHER_ARGS)
        _build.launch(counter, fn, q_sign.data_ptr(),
                      sign_plane.data_ptr(), block_ids.data_ptr(),
                      out.data_ptr(), b, n, j, block_rows, d, group,
                      device=dev)
    return out
