"""Stage-2 exact INT8 rescore: wrapper of the CUDA kernel in
`csrc/stage2_int8.cu`, which replaces the reference's
`stage2_int8_batched_pallas`. A tensor on the CPU goes to the plain
version in `ref`; a CUDA tensor launches the kernel or raises. It takes
every D with D % 8 == 0 (it keeps nothing in shared memory).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_int4 import _check, _on_cpu, check_width

_EXACT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p]


def stage2_int8_batched(q_eo8: torch.Tensor, msb_rows: torch.Tensor,
                        lsb_rows: torch.Tensor) -> torch.Tensor:
    """q_eo8 (B, 2, D//2) int8 full query values [even; odd],
    msb/lsb_rows (B, C, D//2) uint8 gathered candidates -> (B, C) int32."""
    if _on_cpu(msb_rows):
        return ref.stage2_scores_batched_ref(q_eo8, msb_rows, lsb_rows)
    dev = msb_rows.device
    _check("q_eo8", q_eo8, torch.int8, 3, dev)
    _check("msb_rows", msb_rows, torch.uint8, 3, dev)
    _check("lsb_rows", lsb_rows, torch.uint8, 3, dev)
    b, c, d2 = msb_rows.shape
    if lsb_rows.shape != msb_rows.shape or q_eo8.shape != (b, 2, d2):
        raise ValueError(f"shapes q {tuple(q_eo8.shape)}, msb "
                         f"{tuple(msb_rows.shape)}, lsb "
                         f"{tuple(lsb_rows.shape)} do not match")
    check_width("exact", 2 * d2, 0)
    if b * c >= 2 ** 31:
        raise ValueError(f"{b} x {c} candidate rows exceed the kernel's grid")
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
    if out.numel():
        fn = _build.function("stage2_int8", "stage2_exact_launch",
                             _EXACT_ARGS)
        _build.launch("stage2_exact", fn, q_eo8.data_ptr(),
                      msb_rows.data_ptr(), lsb_rows.data_ptr(),
                      out.data_ptr(), b, c, d2, device=dev)
    return out
