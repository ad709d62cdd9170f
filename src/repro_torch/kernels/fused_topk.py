"""Stage-1 scoring fused with a per-block top-k: wrappers of the CUDA kernel
in `csrc/fused_topk.cu`.

`fused_topk_batched` replaces the reference's `fused_topk_batched_pallas`
(optionally with the lane's tenant mask applied inside the kernel),
`fused_topk_single` its single-query, unmasked `fused_topk_pallas` (the
dp4a kernel at B = 1, counted apart). For every `block_n`-row block of the
plane each lane gets the block's top-k (score, global row id), ties toward
the lower row, and once the block has no live row left every further
pick is (INT32_MIN, the block's first row), as the reference's iterative
argmax leaves it. The (B, N) scores never reach device memory.

The reference kernel takes N a multiple of `block_n` and its wrapper pads
the plane with zero rows. These take any N and behave as if those zero
rows were there (score 0, owner -1, ids >= N) without padding or copying
the plane, so the output is the reference kernel's on the padded plane:
(B, ceil(N / block_n), k). A tensor on the CPU goes to the plain version in
`ref`; a CUDA tensor launches the kernel or raises. Widths: every even D.

The batched form has two kernels, chosen by shape: the int8 tensor-core
kernel (counted `fused_topk_mma`) wherever its launcher takes the shape
(`_fused_mma_lanes`: B >= 2, D/2 % 16 == 0, block_n one of 128, 256, 512,
1024 and a lane tile that fits in shared memory), else the dp4a kernel
(counted `fused_topk`). Both give the same bits; a failed build or launch
of the chosen one raises. `_fused(..., route=)` asks for one of them, for
tests and measurements. The single-query form stays on dp4a.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_int4 import (_ROUTES, MAX_GRID_Y, _check,
                                             _on_cpu, check_smem)

DEFAULT_BLOCK_N = 512
SPAN_WORDS = 128   # panel words per lane half the kernel holds at a time

_FUSED_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_LANES_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]


def _fused_mma_lanes(b: int, d2: int, block_n: int, k: int) -> int:
    """The tensor-core fused kernel's lane tile for B lanes of D/2 bytes,
    `block_n` and k, as its launcher decides it; 0 when that kernel does
    not take the shape."""
    return _build.function("fused_topk", "fused_mma_lanes",
                           _LANES_ARGS)(b, d2, block_n, k)


def _fused(q_eo: torch.Tensor, msb_plane: torch.Tensor,
           owner: torch.Tensor | None, tenant_ids: torch.Tensor | None,
           k: int, block_n: int, *, route: str = "auto",
           counter: str = "fused_topk") -> tuple[torch.Tensor, torch.Tensor]:
    """Launches a fused kernel: q_eo (B, 2, D//2) -> (scores, ids)
    (B, ceil(N / block_n), k) int32. `route` "auto" takes the tensor-core
    kernel wherever its launcher takes the shape, else dp4a (counted as
    `counter`); "mma" and "dp4a" ask for one. CUDA tensors only."""
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
    if owner is not None:
        _check("owner", owner, torch.int32, 1, dev)
        _check("tenant_ids", tenant_ids, torch.int32, 1, dev)
        if owner.shape[0] != n or tenant_ids.shape[0] != b:
            raise ValueError(f"owner {tuple(owner.shape)} and tenant_ids "
                             f"{tuple(tenant_ids.shape)} do not match N = {n} "
                             f"and B = {b}")
    if b > MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    if route != "dp4a":
        takes = bool(_fused_mma_lanes(b, d2, block_n, k))
        if route == "mma" and not takes:
            raise ValueError(f"the tensor-core fused kernel does not take "
                             f"B = {b}, D/2 = {d2}, block_n = {block_n}, "
                             f"k = {k} (fused_mma_lanes in "
                             "csrc/fused_topk.cu)")
        route = "mma" if takes else "dp4a"
    if route == "mma":
        if n >= 2 ** 31:
            raise ValueError(f"{n} plane rows exceed the tensor map's "
                             "int32 row coordinate")
        counter = "fused_topk_mma"
    else:
        words = -(-d2 // 4)
        span = min(SPAN_WORDS, -(-words // 16) * 16)
        check_smem("fused top-k", f"block_n = {block_n}",
                   (2 * span + block_n) * 4)
    nb = -(-n // block_n)
    scores = torch.empty((b, nb, k), dtype=torch.int32, device=dev)
    ids = torch.empty((b, nb, k), dtype=torch.int32, device=dev)
    if scores.numel():
        fn = _build.function("fused_topk", "fused_topk_launch", _FUSED_ARGS)
        _build.launch(counter, fn, q_eo.data_ptr(), msb_plane.data_ptr(),
                      None if owner is None else owner.data_ptr(),
                      None if owner is None else tenant_ids.data_ptr(),
                      scores.data_ptr(), ids.data_ptr(), b, n, d2, block_n, k,
                      int(route == "mma"), device=dev)
    return scores, ids


def _check_knobs(k: int, block_n: int) -> None:
    if k < 1 or block_n < 1:
        raise ValueError(f"k and block_n must be >= 1, got k = {k}, "
                         f"block_n = {block_n}")


def fused_topk_batched(q_eo: torch.Tensor, msb_plane: torch.Tensor,
                       owner: torch.Tensor | None = None,
                       tenant_ids: torch.Tensor | None = None, *, k: int = 8,
                       block_n: int = DEFAULT_BLOCK_N
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """q_eo (B, 2, D//2) int8 signed MSB nibbles; msb_plane (N, D//2)
    uint8; optionally owner (N,) int32 with tenant_ids (B,) int32, which
    mask each lane to the rows its tenant owns inside the kernel. Returns
    (scores, global_ids), each (B, ceil(N / block_n), k) int32."""
    _check_knobs(k, block_n)
    if (owner is None) != (tenant_ids is None):
        raise ValueError("owner and tenant_ids must be passed together")
    if _on_cpu(msb_plane):
        return ref.fused_topk_batched_ref(q_eo, msb_plane, block_n, k, owner,
                                          tenant_ids)
    return _fused(q_eo, msb_plane, owner, tenant_ids, k, block_n)


def fused_topk_single(q_eo: torch.Tensor, msb_plane: torch.Tensor, *,
                      k: int = 8, block_n: int = DEFAULT_BLOCK_N
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One query, unmasked: q_eo (2, D//2) int8, msb_plane (N, D//2) uint8
    -> (scores, global_ids), each (ceil(N / block_n), k) int32. The fused
    dp4a kernel at B = 1, counted as `fused_topk_single`."""
    _check_knobs(k, block_n)
    if _on_cpu(msb_plane):
        return ref.fused_topk_ref(q_eo, msb_plane, block_n, k)
    if q_eo.ndim != 2:
        raise ValueError(f"q_eo must be (2, D//2), got {tuple(q_eo.shape)}")
    scores, ids = _fused(q_eo[None], msb_plane, None, None, k, block_n,
                         route="dp4a", counter="fused_topk_single")
    return scores[0], ids[0]
