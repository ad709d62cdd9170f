"""Block-gathered stage-1 MSB-nibble (INT4) scoring: wrapper of the CUDA
gather kernels in `csrc/stage1_gather.cu` and `csrc/stage1_rows.cu`, which
replace the reference's `stage1_int4_gather_pallas`.

Lane b scores the plane rows of its block table: view row r is plane row
``block_ids[b, r // block_rows] * block_rows + r % block_rows``. The
kernels read those rows in place and score rows past N as 0 without
reading them, so a ragged plane is never padded. Every even D is served.
A tensor on the CPU goes to the plain version in `ref`; a CUDA tensor
launches a kernel or raises.

Two kernels, chosen by shape: the TMA gather of `stage1_gather.cu`
(counted `stage1_gather`; whole 64-row pieces of the blocks by TMA, scored
on the int8 tensor cores) wherever its launcher takes the shape
(`_tma_takes`, asked once per shape: D/2 % 16 == 0, block_rows a multiple
of 64, 0 < N < 2^31), which includes the cluster path's D = 512, 64-row
blocks; else the dp4a `gather_kernel` of `stage1_rows.cu` (counted
`stage1_gather_dp4a`). Both give the same bits; a failed build or launch
of the chosen one raises.

Two forms of the query: `stage1_int4_gather` takes the reference's
(B, 2, D/2) [even; odd] panels; `stage1_nibble_gather`, which the engine
and the serving cache call through `ops`, takes the (B, D) nibble query as
it comes. The TMA kernel reads the (B, D) form and splits it into even and
odd dims itself, so the engine's calls pack nothing; the dp4a kernel reads
the panels. Each wrapper converts its query to the form the chosen kernel
reads (a copy only where they differ), and copies a query that is not
16-byte aligned.
The resident wrapper (`ops.stage1_scores_gather_resident`) passes
`counter="stage1_gather_resident"`, so its TMA launches count apart from
the plane gather's. `_gather(..., route=)` asks for one kernel, for tests
and measurements.

Limits: the dp4a kernel's grid holds B <= 65535 lanes (grid.y) and
ceil(J * block_rows / 256) < 2^31 blocks of 256 view rows (grid.x)
(`check_gather_grid`, which the sign gather shares). The TMA kernel's
launcher takes B and J as C ints, so B, J < 2^31; its tensor map's int32
row coordinate is why it takes N < 2^31 only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_int4 import (MAX_GRID_Y, _check, _on_cpu,
                                             pack_queries_even_odd)

DEFAULT_BLOCK_ROWS = 64
_ROUTES = ("auto", "tma", "dp4a")

_GATHER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_TAKES_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
# The TMA launcher's answer per (N, D/2, block_rows), asked once.
_TAKES: dict[tuple[int, int, int], bool] = {}


def _tma_takes(n: int, d2: int, block_rows: int) -> bool:
    """Whether the TMA gather kernel takes an N-row plane of D/2 bytes in
    `block_rows`-row blocks, as its launcher decides it (once per
    shape)."""
    key = (n, d2, block_rows)
    takes = _TAKES.get(key)
    if takes is None:
        takes = _TAKES[key] = bool(_build.function(
            "stage1_gather", "stage1_gather_tma_takes",
            _TAKES_ARGS)(n, d2, block_rows))
    return takes


def check_gather(block_ids: torch.Tensor, b: int, block_rows: int,
                 dev: torch.device) -> int:
    """Checks a (B, J) int32 block table; returns J."""
    _check("block_ids", block_ids, torch.int32, 2, dev)
    if block_ids.shape[0] != b:
        raise ValueError(f"block_ids has {block_ids.shape[0]} lanes, the "
                         f"query {b}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    return block_ids.shape[1]


def check_gather_grid(b: int, j: int, block_rows: int) -> None:
    """The grid of the gathers that give each lane a grid row and each
    256 view rows a block (dp4a `gather_kernel`, `sign_gather_kernel`)."""
    if b > MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    if -(-j * block_rows // 256) >= 2 ** 31:
        raise ValueError(f"{j} blocks of {block_rows} rows exceed the "
                         "kernel's grid")


def _checked(q: torch.Tensor, msb_plane: torch.Tensor,
             block_ids: torch.Tensor,
             block_rows: int) -> tuple[int, int, int, int]:
    """Checks one gather's operands: q either the (B, 2, D/2) [even; odd]
    panels or the (B, D) nibble query (at any alignment: `_gather` hands
    the kernel an aligned copy), the (N, D/2) plane, the (B, J) table.
    Returns (B, N, D/2, J)."""
    dev = msb_plane.device
    _check("msb_plane", msb_plane, torch.uint8, 2, dev)
    n, d2 = msb_plane.shape
    raw = q.ndim == 2
    _check("q_msb" if raw else "q_eo", q, torch.int8, q.ndim, dev,
           aligned=False)
    b = q.shape[0]
    if q.shape != ((b, 2 * d2) if raw else (b, 2, d2)):
        raise ValueError(f"{'q_msb' if raw else 'q_eo'} shape "
                         f"{tuple(q.shape)} does not match the plane's {d2} "
                         "bytes per row")
    return b, n, d2, check_gather(block_ids, b, block_rows, dev)


def _gather(q: torch.Tensor, msb_plane: torch.Tensor,
            block_ids: torch.Tensor, block_rows: int, *,
            route: str = "auto",
            counter: str = "stage1_gather") -> torch.Tensor:
    """Launches a gather kernel: (B, J * block_rows) int32. q is the
    (B, 2, D//2) panels or the (B, D) nibble query; the TMA kernel reads
    the (B, D) form in place and the dp4a kernel the panels, so the other
    form is converted first. `route` "auto" takes the TMA kernel wherever
    its launcher takes the shape, else dp4a; "tma" and "dp4a" ask for
    one. A TMA launch counts under `counter`, a dp4a one
    under `stage1_gather_dp4a`. CUDA tensors only."""
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    b, n, d2, j = _checked(q, msb_plane, block_ids, block_rows)
    if route != "dp4a":
        takes = _tma_takes(n, d2, block_rows)
        if route == "tma" and not takes:
            raise ValueError(f"the TMA gather kernel does not take N = {n}, "
                             f"D/2 = {d2}, block_rows = {block_rows}: it "
                             "needs D/2 % 16 == 0, block_rows % 64 == 0 and "
                             "0 < N < 2^31 (stage1_gather_tma_takes in "
                             "csrc/stage1_gather.cu)")
        route = "tma" if takes else "dp4a"
    if route == "dp4a":
        check_gather_grid(b, j, block_rows)
        if q.ndim == 2:
            q = pack_queries_even_odd(q)
    else:
        if b >= 2 ** 31 or j >= 2 ** 31:
            raise ValueError(f"{b} lanes of {j} blocks exceed the TMA gather "
                             "launcher's int arguments (B, J < 2^31)")
        if q.ndim == 3:                     # [even; odd] -> dims interleaved
            q = q.transpose(1, 2).reshape(b, 2 * d2)
    if q.data_ptr() % 16:
        q = q.clone()
    dev = msb_plane.device
    out = msb_plane.new_empty((b, j * block_rows), dtype=torch.int32)
    if not out.numel():
        return out
    args = (q.data_ptr(), msb_plane.data_ptr(), block_ids.data_ptr(),
            out.data_ptr(), b, n, j, block_rows, d2)
    if route == "tma":
        fn = _build.function("stage1_gather", "stage1_gather_tma_launch",
                             _GATHER_ARGS)
        _build.launch(counter, fn, *args, device=dev)
    else:
        fn = _build.function("stage1_rows", "stage1_gather_launch",
                             _GATHER_ARGS)
        _build.launch("stage1_gather_dp4a", fn, *args, device=dev)
    return out


def stage1_int4_gather(q_eo: torch.Tensor, msb_plane: torch.Tensor,
                       block_ids: torch.Tensor, *, block_rows: int,
                       counter: str = "stage1_gather") -> torch.Tensor:
    """q_eo (B, 2, D//2) int8 per-lane [even; odd] nibble panels,
    msb_plane (N, D//2) uint8, block_ids (B, J) int32 ids of
    `block_rows`-row plane blocks (clamped: no -1 holes) ->
    (B, J * block_rows) int32 in block-table order. `counter`: the key a
    TMA launch counts under."""
    if _on_cpu(msb_plane):
        return ref.stage1_gather_batched_ref(q_eo, msb_plane, block_ids,
                                             block_rows)
    return _gather(q_eo, msb_plane, block_ids, block_rows, counter=counter)


def stage1_nibble_gather(q_msb: torch.Tensor, msb_plane: torch.Tensor,
                         block_ids: torch.Tensor, *, block_rows: int,
                         counter: str = "stage1_gather") -> torch.Tensor:
    """`stage1_int4_gather` on the query as it comes: q_msb (B, D) int8
    MSB nibbles -> (B, J * block_rows) int32, the same bits. The TMA
    kernel reads q_msb in place; the dp4a route packs it."""
    if _on_cpu(msb_plane):
        return ref.stage1_gather_batched_ref(pack_queries_even_odd(q_msb),
                                             msb_plane, block_ids,
                                             block_rows)
    if q_msb.dtype != torch.int8 or not q_msb.is_contiguous():
        q_msb = q_msb.to(torch.int8).contiguous()
    return _gather(q_msb, msb_plane, block_ids, block_rows, counter=counter)
