"""Stage-2 exact INT8 rescore: wrappers of the CUDA kernel in
`csrc/stage2_int8.cu`. `stage2_int8_batched` replaces the reference's
`stage2_int8_batched_pallas`, `stage2_int8_single` its single-query
`stage2_int8_pallas` (the same kernel at B = 1, counted apart). A tensor
on the CPU goes to the plain version in `ref`; a CUDA tensor launches the
kernel or raises. They take every even D (the kernel keeps nothing in
shared memory, and reads rows that are not whole words byte by byte).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_int4 import _check, _on_cpu

_EXACT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p]


def stage2_int8_batched(q_eo8: torch.Tensor, msb_rows: torch.Tensor,
                        lsb_rows: torch.Tensor) -> torch.Tensor:
    """q_eo8 (B, 2, D//2) int8 full query values [even; odd],
    msb/lsb_rows (B, C, D//2) uint8 gathered candidates -> (B, C) int32."""
    if _on_cpu(msb_rows):
        return ref.stage2_scores_batched_ref(q_eo8, msb_rows, lsb_rows)
    return _exact("stage2_exact", q_eo8, msb_rows, lsb_rows)


def stage2_int8_single(q_eo8: torch.Tensor, msb_rows: torch.Tensor,
                       lsb_rows: torch.Tensor) -> torch.Tensor:
    """One query: q_eo8 (2, D//2) int8 full query values [even; odd],
    msb/lsb_rows (C, D//2) uint8 gathered candidates -> (C,) int32. The
    exact kernel at B = 1, counted as `stage2_single`."""
    if _on_cpu(msb_rows):
        return ref.stage2_scores_ref(q_eo8, msb_rows, lsb_rows)
    if q_eo8.ndim != 2 or msb_rows.ndim != 2 or lsb_rows.ndim != 2:
        raise ValueError(f"shapes q {tuple(q_eo8.shape)}, msb "
                         f"{tuple(msb_rows.shape)}, lsb "
                         f"{tuple(lsb_rows.shape)}: expected (2, D//2) and "
                         "(C, D//2)")
    return _exact("stage2_single", q_eo8[None], msb_rows[None],
                  lsb_rows[None])[0]


def _exact(counter: str, q_eo8: torch.Tensor, msb_rows: torch.Tensor,
           lsb_rows: torch.Tensor) -> torch.Tensor:
    """Launches the exact kernel: (B, 2, D//2), 2 x (B, C, D//2) ->
    (B, C) int32."""
    dev = msb_rows.device
    _check("q_eo8", q_eo8, torch.int8, 3, dev)
    _check("msb_rows", msb_rows, torch.uint8, 3, dev)
    _check("lsb_rows", lsb_rows, torch.uint8, 3, dev)
    b, c, d2 = msb_rows.shape
    if lsb_rows.shape != msb_rows.shape or q_eo8.shape != (b, 2, d2):
        raise ValueError(f"shapes q {tuple(q_eo8.shape)}, msb "
                         f"{tuple(msb_rows.shape)}, lsb "
                         f"{tuple(lsb_rows.shape)} do not match")
    if b * c >= 2 ** 31:
        raise ValueError(f"{b} x {c} candidate rows exceed the kernel's grid")
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
    if out.numel():
        fn = _build.function("stage2_int8", "stage2_exact_launch",
                             _EXACT_ARGS)
        _build.launch(counter, fn, q_eo8.data_ptr(),
                      msb_rows.data_ptr(), lsb_rows.data_ptr(),
                      out.data_ptr(), b, c, d2, device=dev)
    return out
