"""Stage-2 exact INT8 rescore: wrappers of the CUDA kernel in
`csrc/stage2_int8.cu`. `stage2_int8_batched` replaces the reference's
`stage2_int8_batched_pallas`, `stage2_int8_single` its single-query
`stage2_int8_pallas` (the same kernel at B = 1, counted apart), both on
rows the caller gathered. `stage2_int8_by_id` is the same kernel reading
each candidate's row of the full planes in place at its id (counted
`stage2_by_id`), the form the engine calls: the reference's index gathers
of (B, C, D/2) rows are skipped. A tensor on the CPU goes to the plain
version in `ref`; a CUDA tensor launches the kernel or raises. They take
every even D (the kernel keeps nothing in shared memory, and reads rows
that are not whole words byte by byte).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_int4 import _check, _on_cpu

_EXACT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def stage2_int8_batched(q_eo8: torch.Tensor, msb_rows: torch.Tensor,
                        lsb_rows: torch.Tensor) -> torch.Tensor:
    """q_eo8 (B, 2, D//2) int8 full query values [even; odd],
    msb/lsb_rows (B, C, D//2) uint8 gathered candidates -> (B, C) int32."""
    if _on_cpu(msb_rows):
        return ref.stage2_scores_batched_ref(q_eo8, msb_rows, lsb_rows)
    return _exact("stage2_exact", q_eo8, msb_rows, lsb_rows, 3)


def stage2_int8_single(q_eo8: torch.Tensor, msb_rows: torch.Tensor,
                       lsb_rows: torch.Tensor) -> torch.Tensor:
    """One query: q_eo8 (2, D//2) int8 full query values [even; odd],
    msb/lsb_rows (C, D//2) uint8 gathered candidates -> (C,) int32. The
    exact kernel at B = 1, counted as `stage2_single`."""
    if _on_cpu(msb_rows):
        return ref.stage2_scores_ref(q_eo8, msb_rows, lsb_rows)
    return _exact("stage2_single", q_eo8, msb_rows, lsb_rows, 2)


def stage2_int8_by_id(q_eo8: torch.Tensor, msb_plane: torch.Tensor,
                      lsb_plane: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """q_eo8 (B, 2, D//2) int8 full query values [even; odd], msb/lsb_plane
    (N, D//2) uint8 full planes, ids (B, C) int32 candidate rows, clamped
    to [0, N - 1] (as JAX's indexing `x[ids]` clamps; the reference
    engine's `jnp.take` fills instead, and the engine never passes an id
    >= N) -> (B, C) int32; no row is copied."""
    if _on_cpu(msb_plane):
        return ref.stage2_scores_by_id_ref(q_eo8, msb_plane, lsb_plane, ids)
    return _exact("stage2_by_id", q_eo8, msb_plane, lsb_plane, 2, ids)


def _exact(counter: str, q_eo8: torch.Tensor, msb: torch.Tensor,
           lsb: torch.Tensor, ndim: int,
           ids: torch.Tensor | None = None) -> torch.Tensor:
    """Launches the exact kernel on gathered rows (`ndim`-D, (B, C, D//2)
    or, for one query, (C, D//2)) or, with (B, C) `ids`, on (N, D//2)
    planes. Returns (B, C) int32 ((C,) for one query). Each operand is
    checked once."""
    dev = msb.device
    _check("msb", msb, torch.uint8, ndim, dev)
    _check("lsb", lsb, torch.uint8, ndim, dev)
    n = 0
    if ids is None:
        b, c, d2 = msb.shape if ndim == 3 else (1, *msb.shape)
        q_shape = (b, 2, d2) if ndim == 3 else (2, d2)
        out_shape = (b, c) if ndim == 3 else (c,)
    else:
        _check("ids", ids, torch.int32, 2, dev)
        (b, c), (n, d2) = ids.shape, msb.shape
        q_shape, out_shape = (b, 2, d2), (b, c)
        if n == 0 and b * c:
            raise ValueError("candidate ids index an empty plane")
    _check("q_eo8", q_eo8, torch.int8, len(q_shape), dev)
    if lsb.shape != msb.shape or q_eo8.shape != q_shape:
        raise ValueError(f"shapes q {tuple(q_eo8.shape)}, msb "
                         f"{tuple(msb.shape)}, lsb {tuple(lsb.shape)} do not "
                         "match")
    if b * c >= 2 ** 31:
        raise ValueError(f"{b} x {c} candidate rows exceed the kernel's grid")
    out = torch.empty(out_shape, dtype=torch.int32, device=dev)
    if b * c:
        fn = _build.function("stage2_int8", "stage2_exact_launch",
                             _EXACT_ARGS)
        _build.launch(counter, fn, q_eo8.data_ptr(), msb.data_ptr(),
                      lsb.data_ptr(), None if ids is None else ids.data_ptr(),
                      out.data_ptr(), b, c, d2, n, device=dev)
    return out
