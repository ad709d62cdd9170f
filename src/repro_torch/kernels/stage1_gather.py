"""Block-gathered stage-1 MSB-nibble (INT4) scoring: wrapper of the CUDA
gather kernels in `csrc/stage1_gather.cu` and `csrc/stage1_int4.cu`, which
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
(`_tma_takes`: D/2 % 16 == 0, block_rows a multiple of 64, 0 < N < 2^31),
which includes the cluster path's D = 512, 64-row blocks; else the dp4a
`gather_kernel` of `stage1_int4.cu` (counted `stage1_gather_dp4a`). Both
give the same bits; a failed build or launch of the chosen one raises.
The resident wrapper (`ops.stage1_scores_gather_resident`) passes
`counter="stage1_gather_resident"`, so its TMA launches count apart from
the plane gather's.
`_gather(..., route=)` asks for one of them, for tests and measurements.

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
from repro_torch.kernels.stage1_int4 import MAX_GRID_Y, _check, _on_cpu

DEFAULT_BLOCK_ROWS = 64
_ROUTES = ("auto", "tma", "dp4a")

_GATHER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_TAKES_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]


def _tma_takes(n: int, d2: int, block_rows: int) -> bool:
    """Whether the TMA gather kernel takes an N-row plane of D/2 bytes in
    `block_rows`-row blocks, as its launcher decides it."""
    return bool(_build.function("stage1_gather", "stage1_gather_tma_takes",
                                _TAKES_ARGS)(n, d2, block_rows))


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


def _gather(q_eo: torch.Tensor, msb_plane: torch.Tensor,
            block_ids: torch.Tensor, block_rows: int, *,
            route: str = "auto",
            counter: str = "stage1_gather") -> torch.Tensor:
    """Launches a gather kernel: (B, J * block_rows) int32. `route` "auto"
    takes the TMA kernel wherever its launcher takes the shape, else dp4a;
    "tma" and "dp4a" ask for one. A TMA launch counts under `counter`, a
    dp4a one under `stage1_gather_dp4a`. CUDA tensors only."""
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    dev = msb_plane.device
    _check("q_eo", q_eo, torch.int8, 3, dev)
    _check("msb_plane", msb_plane, torch.uint8, 2, dev)
    n, d2 = msb_plane.shape
    b = q_eo.shape[0]
    if q_eo.shape != (b, 2, d2):
        raise ValueError(f"q_eo shape {tuple(q_eo.shape)} does not match "
                         f"the plane's {d2} bytes per row")
    j = check_gather(block_ids, b, block_rows, dev)
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
    elif b >= 2 ** 31 or j >= 2 ** 31:
        raise ValueError(f"{b} lanes of {j} blocks exceed the TMA gather "
                         "launcher's int arguments (B, J < 2^31)")
    out = torch.empty((b, j * block_rows), dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    args = (q_eo.data_ptr(), msb_plane.data_ptr(), block_ids.data_ptr(),
            out.data_ptr(), b, n, j, block_rows, d2)
    if route == "tma":
        fn = _build.function("stage1_gather", "stage1_gather_tma_launch",
                             _GATHER_ARGS)
        _build.launch(counter, fn, *args, device=dev)
    else:
        fn = _build.function("stage1_int4", "stage1_gather_launch",
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
