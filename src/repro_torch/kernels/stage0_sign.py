"""Stage-0 sign-agreement scoring over gathered blocks of the packed sign
plane: wrapper of the CUDA kernel in `csrc/stage0_sign.cu`, which replaces
the reference's `stage0_sign_gather_pallas`.

Lane b scores the sign-plane rows of its block table (the same table the
stage-1 gather reads) against its +-1 query signs: ``sum_k q_sign[k] *
(1 - 2 * bit_k)``. Rows past N are zero bytes, all +1, and score
``sum_k q_sign[k]``; the kernel computes that without a read, so a ragged
plane is never padded. A tensor on the CPU goes to the plain version in
`ref`; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_gather import check_gather
from repro_torch.kernels.stage1_int4 import _check, _on_cpu, check_width

_SIGN_GATHER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]


def stage0_sign_gather(q_sign: torch.Tensor, sign_plane: torch.Tensor,
                       block_ids: torch.Tensor, *,
                       block_rows: int) -> torch.Tensor:
    """q_sign (B, D) int8 in {+1, -1}, sign_plane (N, D//8) uint8,
    block_ids (B, J) int32 clamped block ids -> (B, J * block_rows) int32
    sign-agreement scores in block-table order. The kernel scores from the
    query's sign bits, which equals the +-1 dot only for +-1 signs."""
    if _on_cpu(sign_plane):
        return ref.stage0_sign_gather_ref(q_sign, sign_plane, block_ids,
                                          block_rows)
    dev = sign_plane.device
    _check("q_sign", q_sign, torch.int8, 2, dev)
    _check("sign_plane", sign_plane, torch.uint8, 2, dev)
    n, d8 = sign_plane.shape
    b, d = q_sign.shape
    if d != 8 * d8:
        raise ValueError(f"q_sign has D = {d}, the sign plane {d8} bytes "
                         "per row")
    check_width("sign gather", d, -(-d // 32) * 4)
    j = check_gather(block_ids, b, block_rows, dev)
    out = torch.empty((b, j * block_rows), dtype=torch.int32, device=dev)
    if out.numel():
        fn = _build.function("stage0_sign", "stage0_sign_gather_launch",
                             _SIGN_GATHER_ARGS)
        _build.launch("stage0_sign_gather", fn, q_sign.data_ptr(),
                      sign_plane.data_ptr(), block_ids.data_ptr(),
                      out.data_ptr(), b, n, j, block_rows, d, device=dev)
    return out
