"""Stage-2 exact INT8 rescore: wrappers of the CUDA kernels in
`csrc/stage2_int8.cu` and `csrc/stage2_rerank.cu`. `stage2_int8_batched`
replaces the reference's `stage2_int8_batched_pallas`,
`stage2_int8_single` its single-query `stage2_int8_pallas` (the same
kernel at B = 1, counted apart), both on rows the caller gathered.
`stage2_int8_by_id` is the same kernel reading each candidate's row of
the full planes in place at its id (counted `stage2_by_id`), the form
`ShardedIndex` calls per shard: the reference's index gathers of
(B, C, D/2) rows are skipped. A tensor on the CPU goes to the plain
version in `ref`; a CUDA tensor launches the kernel or raises. They take
every even D (the kernel keeps nothing in shared memory, and reads rows
that are not whole words byte by byte).

`stage2_int8_rerank_by_id` is the engine's whole exact stage in one launch
of `stage2_rerank.cu` (counted `stage2_rerank_by_id`): the exact scores of
each lane's candidates read by id from the raw (B, D) query, their norms,
the membership pins and the rerank (the non-division cosine comparator or
MIPS), with the result's masking. `stage2_rerank` is its ranking half on
scores and norms already formed (counted `stage2_rerank`), the sharded
index's final rerank. Both give the bits of their plain versions in `ref`
for every int32 score and norm.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.stage1_int4 import _check, _on_cpu, check_smem

_EXACT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_RERANK_BY_ID_ARGS = [ctypes.c_void_p] * 9 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_RERANK_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
METRICS = {"cosine": 0, "mips": 1}


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


def stage2_int8_rerank_by_id(q: torch.Tensor, msb_plane: torch.Tensor,
                             lsb_plane: torch.Tensor, ids: torch.Tensor,
                             norms_sq: torch.Tensor,
                             member: torch.Tensor | None = None, *, k: int,
                             metric: str
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The engine's exact stage: q (B, D) int8 raw queries, msb/lsb_plane
    (N, D//2) uint8, ids (B, C) int32 candidate rows (read at clamp(id, 0,
    N - 1)), norms_sq (N,) int32, member (B, C) bool or None -> (indices
    (B, k), scores (B, k), candidate_indices (B, C)) int32. Non-members
    rank as (MASKED_SCORE, norm 1); with `member`, a non-member's result
    position reads (-1, 0) and its candidate id -1. metric "cosine" (the
    non-division comparator) or "mips"."""
    if _on_cpu(msb_plane):
        return ref.exact_rerank_by_id_ref(q, msb_plane, lsb_plane, ids,
                                          norms_sq, member, k=k,
                                          metric=metric)
    dev = msb_plane.device
    _check("msb_plane", msb_plane, torch.uint8, 2, dev)
    _check("lsb_plane", lsb_plane, torch.uint8, 2, dev)
    _check("q", q, torch.int8, 2, dev, aligned=False)
    _check("ids", ids, torch.int32, 2, dev, aligned=False)
    _check("norms_sq", norms_sq, torch.int32, 1, dev, aligned=False)
    (b, c), (n, d2) = ids.shape, msb_plane.shape
    if lsb_plane.shape != (n, d2):
        raise ValueError(f"lsb_plane shape {tuple(lsb_plane.shape)} does not "
                         f"match msb_plane's {(n, d2)}")
    if q.shape != (b, 2 * d2):
        raise ValueError(f"q shape {tuple(q.shape)} does not match {b} "
                         f"lanes of the planes' {d2} bytes per row")
    if norms_sq.shape != (n,):
        raise ValueError(f"norms_sq shape {tuple(norms_sq.shape)} does not "
                         f"match the planes' {n} rows")
    if member is not None:
        _check("member", member, torch.bool, 2, dev, aligned=False)
        if member.shape != (b, c):
            raise ValueError(f"member shape {tuple(member.shape)} does not "
                             f"match ids' {(b, c)}")
    code = _rerank_checks(b, c, k, metric)
    if n == 0 and b * c:
        raise ValueError("candidate ids index an empty plane")
    if q.data_ptr() % 16:
        q = q.clone()
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    scores = torch.empty((b, k), dtype=torch.int32, device=dev)
    cand = torch.empty((b, c), dtype=torch.int32, device=dev)
    if b * c:
        fn = _build.function("stage2_rerank", "stage2_exact_rerank_launch",
                             _RERANK_BY_ID_ARGS)
        _build.launch("stage2_rerank_by_id", fn, q.data_ptr(),
                      msb_plane.data_ptr(), lsb_plane.data_ptr(),
                      ids.data_ptr(),
                      None if member is None else member.data_ptr(),
                      norms_sq.data_ptr(), idx.data_ptr(), scores.data_ptr(),
                      cand.data_ptr(), b, c, d2, n, k, code, device=dev)
    return idx, scores, cand


def stage2_rerank(scores: torch.Tensor, norms: torch.Tensor,
                  ids: torch.Tensor, *, k: int, metric: str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ranking half of the exact stage: scores, norms and ids (B, C)
    int32 (any int32 score, INT32_MIN included) -> (ids at the top k
    (B, k), their scores (B, k)) int32, by the non-division cosine
    comparator (metric "cosine") or the raw scores ("mips"), ties toward
    the lower candidate position."""
    if _on_cpu(scores):
        return ref.rerank_ref(scores, norms, ids, k=k, metric=metric)
    dev = scores.device
    for name, t in (("scores", scores), ("norms", norms), ("ids", ids)):
        _check(name, t, torch.int32, 2, dev, aligned=False)
        if t.shape != scores.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match "
                             f"scores' {tuple(scores.shape)}")
    b, c = scores.shape
    code = _rerank_checks(b, c, k, metric)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    top = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b * c:
        fn = _build.function("stage2_rerank", "stage2_rerank_launch",
                             _RERANK_ARGS)
        _build.launch("stage2_rerank", fn, scores.data_ptr(),
                      norms.data_ptr(), ids.data_ptr(), idx.data_ptr(),
                      top.data_ptr(), b, c, k, code, device=dev)
    return idx, top


def _rerank_checks(b: int, c: int, k: int, metric: str) -> int:
    """Raises on a k outside [0, C], an unknown metric, a grid or a lane's
    shared memory (16 bytes a candidate) past the card's limits; returns
    the metric's code."""
    if not 0 <= k <= c:
        raise ValueError(f"k = {k} is outside the {c} candidates of a lane")
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {tuple(METRICS)}, got "
                         f"{metric!r}")
    if b >= 2 ** 31:
        raise ValueError(f"{b} lanes exceed the kernel's grid")
    check_smem("exact rerank", f"C = {c} candidates", 16 * c)
    return METRICS[metric]
