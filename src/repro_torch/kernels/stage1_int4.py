"""Stage-1 MSB-nibble (INT4) scoring: wrappers of the CUDA kernels in
`csrc/stage1_int4.cu` and `csrc/stage1_mma.cu`.

`stage1_int4_batched` replaces the reference's
`stage1_int4_batched_pallas` (one scan of a shared plane for the whole
batch), `stage1_int4_single` its single-query `stage1_int4_pallas` (the
same plane kernel at B = 1, counted apart), `stage1_int4_rows` its
`stage1_int4_rows_pallas` (per-lane row blocks). A tensor on the CPU goes
to the plain version in `ref`; a CUDA tensor launches the kernel or
raises. The kernels mask their own ragged edge, so no operand is padded.

The batched plane scan has two kernels, chosen by shape: the int8
tensor-core kernel of `stage1_mma.cu` (counted `stage1_plane_mma`)
wherever its launcher takes the shape (`_mma_lanes`: B >= 2, D/2 % 16 ==
0 and a lane tile's panels fit in shared memory beside its ring), else the
dp4a `plane_kernel` (counted `stage1_plane`). Both give the same bits; a
failed build or launch of the chosen one raises. `_plane(..., route=)`
asks for one of them, for tests and measurements.

`rows` is the plane and rows kernels' schedule knob: plane (or window)
rows per thread block, one of `ROWS_CHOICES` (each a compiled instance),
`DEFAULT_ROWS` unless the autotuner chose another. It never changes a
result.

Widths: every even D. Rows of D/2 bytes that are not whole 32-bit words
are read byte by byte, and a D whose query panels do not fit in one
thread block's shared memory walks them through it in passes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_PLANE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p]
_ROWS_ARGS = _PLANE_ARGS
_LANES_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]

# Dynamic shared memory one Hopper thread block may opt into (227 KiB).
SMEM_BYTES = 232448
MAX_GRID_Y = 65535
ROWS_CHOICES = (128, 256, 512, 1024)
DEFAULT_ROWS = 256
_ROUTES = ("auto", "mma", "dp4a")


def _mma_lanes(b: int, d2: int, rows: int) -> int:
    """The tensor-core plane kernel's lane tile for B lanes of D/2 bytes at
    `rows` rows per tile, as its launcher decides it; 0 when that kernel
    does not take the shape."""
    return _build.function("stage1_mma", "stage1_mma_lanes",
                           _LANES_ARGS)(b, d2, rows)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return False


def check_rows(rows: int) -> None:
    """Rows per thread block must name a compiled instance."""
    if rows not in ROWS_CHOICES:
        raise ValueError(f"rows per thread block must be one of "
                         f"{ROWS_CHOICES}, got {rows}")


def check_smem(kernel: str, what: str, nbytes: int) -> None:
    """Raises when the `nbytes` of shared memory one thread block of
    `kernel` keeps for `what` exceed what a Hopper block may hold."""
    if nbytes > SMEM_BYTES:
        raise ValueError(f"{what} is above what one thread block of the "
                         f"{kernel} kernel can hold: it needs {nbytes} bytes "
                         f"of the {SMEM_BYTES} bytes of shared memory")


def _plane(q_panel: torch.Tensor, msb_plane: torch.Tensor, rows: int, *,
           route: str = "auto", counter: str = "stage1_plane"
           ) -> torch.Tensor:
    """Launches a plane kernel: q_panel (2, B, D//2) -> (B, N) int32.
    `route` "auto" takes the tensor-core kernel wherever its launcher takes
    the shape, else dp4a (counted as `counter`); "mma" and "dp4a" ask for
    one. CUDA tensors only."""
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    dev = msb_plane.device
    _check("q_panel", q_panel, torch.int8, 3, dev)
    _check("msb_plane", msb_plane, torch.uint8, 2, dev)
    n, d2 = msb_plane.shape
    b = q_panel.shape[1]
    if q_panel.shape != (2, b, d2):
        raise ValueError(f"q_panel shape {tuple(q_panel.shape)} does not "
                         f"match the plane's {d2} bytes per row")
    if b > MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    if route != "dp4a":
        takes = bool(_mma_lanes(b, d2, rows))
        if route == "mma" and not takes:
            raise ValueError(f"the tensor-core plane kernel does not take "
                             f"B = {b}, D/2 = {d2} at {rows} rows per tile "
                             "(stage1_mma_lanes in csrc/stage1_mma.cu)")
        route = "mma" if takes else "dp4a"
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    if route == "mma":
        if n >= 2 ** 31:
            raise ValueError(f"{n} plane rows exceed the tensor map's "
                             "int32 row coordinate")
        fn = _build.function("stage1_mma", "stage1_mma_launch", _PLANE_ARGS)
        counter = "stage1_plane_mma"
    else:
        fn = _build.function("stage1_int4", "stage1_plane_launch",
                             _PLANE_ARGS)
    _build.launch(counter, fn, q_panel.data_ptr(), msb_plane.data_ptr(),
                  out.data_ptr(), b, n, d2, rows, device=dev)
    return out


def stage1_int4_batched(q_panel: torch.Tensor, msb_plane: torch.Tensor, *,
                        rows: int = DEFAULT_ROWS) -> torch.Tensor:
    """q_panel (2, B, D//2) int8 signed MSB nibbles [even dims; odd dims],
    msb_plane (N, D//2) uint8 -> (B, N) int32, on the tensor-core kernel
    wherever it takes the shape, else on dp4a."""
    check_rows(rows)
    if _on_cpu(msb_plane):
        return ref.stage1_scores_batched_ref(q_panel, msb_plane)
    return _plane(q_panel, msb_plane, rows)


def stage1_int4_single(q_eo: torch.Tensor, msb_plane: torch.Tensor, *,
                       rows: int = DEFAULT_ROWS) -> torch.Tensor:
    """One query: q_eo (2, D//2) int8 [even; odd] MSB nibbles, msb_plane
    (N, D//2) uint8 -> (N,) int32. The plane kernel at B = 1 (its one-lane
    instance), counted as `stage1_single`."""
    check_rows(rows)
    if _on_cpu(msb_plane):
        return ref.stage1_scores_ref(q_eo, msb_plane)
    if q_eo.ndim != 2:
        raise ValueError(f"q_eo must be (2, D//2), got {tuple(q_eo.shape)}")
    return _plane(q_eo[:, None], msb_plane, rows, route="dp4a",
                  counter="stage1_single")[0]


def stage1_int4_rows(q_eo: torch.Tensor, msb_rows: torch.Tensor, *,
                     rows: int = DEFAULT_ROWS) -> torch.Tensor:
    """q_eo (B, 2, D//2) int8 per-lane [even; odd] nibble panels,
    msb_rows (B, W, D//2) uint8 -> (B, W) int32."""
    check_rows(rows)
    if msb_rows.device.type == "meta":
        return _build.abstract("stage1_rows", tuple(msb_rows.shape[:2]))
    if _on_cpu(msb_rows):
        return ref.stage1_rows_batched_ref(q_eo, msb_rows)
    dev = msb_rows.device
    _check("q_eo", q_eo, torch.int8, 3, dev)
    _check("msb_rows", msb_rows, torch.uint8, 3, dev)
    b, w, d2 = msb_rows.shape
    if q_eo.shape != (b, 2, d2):
        raise ValueError(f"q_eo shape {tuple(q_eo.shape)} does not match "
                         f"rows of shape {tuple(msb_rows.shape)}")
    if b > MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    out = torch.empty((b, w), dtype=torch.int32, device=dev)
    if out.numel():
        fn = _build.function("stage1_int4", "stage1_rows_launch", _ROWS_ARGS)
        _build.launch("stage1_rows", fn, q_eo.data_ptr(),
                      msb_rows.data_ptr(), out.data_ptr(), b, w, d2, rows,
                      device=dev)
    return out
