"""The plain reference of the served two-stage retrieval.

For one tenant's rows, given as INT8 codes with the arena slot each was
ingested at, and a tenant's INT8 queries:

  stage 1  s1 = sum_d (q_d >> 4) (x_d >> 4), the INT4 MSB dot product.
           Cosine ranks by the f32 key f32(s1) * rsqrt(max(f32(n), 1)),
           0 where n = 0 (n = sum_d x_d^2); MIPS by s1. The C best keys are
           the candidates, ties toward the lower slot.
  stage 2  e = sum_d q_d x_d, exact. Cosine orders the candidates by
           e |e| / n (0 where n = 0), compared exactly as fractions; MIPS
           by e; ties toward the earlier candidate. The k best are the
           result: their slots and exact scores.

Plain PyTorch and NumPy. The dot products run as float matrix products
with TF32 off: every partial sum is an integer below 2**24 for D <= 1024
(|x|, |q| <= 128), so float32 is exact; wider rows use float64. The
cosine key is the f32 arithmetic above, on the same device as the
program, so its bits are those the configuration's key defines.

`bits=4` is the control: stage 2 and the norms computed on the INT4 MSB
nibbles instead of the INT8 codes, the precision below the one the
configuration states.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Iterable

import numpy as np
import torch

_LOW32 = 0xFFFFFFFF


def _float_dtype(dim: int) -> torch.dtype:
    return torch.float32 if dim * 128 * 128 < 2 ** 24 else torch.float64


def _dots(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(S, D) x (R, D) small integers -> (S, R) int64, exact."""
    return (a.to(dtype) @ b.to(dtype).T).round_().to(torch.int64)


def _key_image(s1: torch.Tensor, norms: torch.Tensor, metric: str
               ) -> torch.Tensor:
    """An int64 whose order is the stage-1 key's order."""
    if metric == "mips":
        return s1
    n = norms.to(torch.float32).clamp(min=1.0)
    key = s1.to(torch.float32) * torch.rsqrt(n)[None, :]
    key = torch.where(norms[None, :] > 0, key, torch.zeros_like(key))
    bits = key.view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)


def _block_top(queries: torch.Tensor, codes: torch.Tensor,
               slots: torch.Tensor, c: int, metric: str, bits: int):
    """One block of rows: the block's best c candidates of every query as
    (packed stage-1 key, slot, exact score, norm), each (S, min(c, R))."""
    dtype = _float_dtype(codes.shape[1])
    s1 = _dots(queries >> 4, codes >> 4, dtype)
    xs, qs = (codes, queries) if bits == 8 else (codes >> 4, queries >> 4)
    norms = (xs.to(dtype) ** 2).sum(dim=1).round_().to(torch.int64)
    packed = ((_key_image(s1, norms, metric) << 32)
              | (_LOW32 - slots.to(torch.int64))[None, :])
    top, pos = torch.topk(packed, min(c, codes.shape[0]), dim=1)
    exact = _dots(qs, xs, dtype).gather(1, pos)
    return top, slots.to(torch.int64)[pos], exact, norms[pos]


def _final_order(exact: list[int], norms: list[int], metric: str) -> list[int]:
    """Candidate positions in the order stage 2 ranks them."""
    if metric == "mips":
        return sorted(range(len(exact)), key=lambda i: (-exact[i], i))

    def value(i):
        e, n = exact[i], norms[i]
        return Fraction(e * abs(e), n) if n > 0 else Fraction(0)
    return sorted(range(len(exact)), key=lambda i: (-value(i), i))


def retrieve(queries: torch.Tensor,
             blocks: Iterable[tuple[torch.Tensor, torch.Tensor]], *,
             k: int, candidates: int, metric: str, bits: int = 8
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One tenant's queries (S, D) int8 over its rows, given as blocks of
    (codes (R, D) int8, slots (R,) int64) on the queries' device. Returns
    (ids (S, k), scores (S, k), candidates (S, C)) int64: -1 ids and 0
    scores where the tenant holds fewer rows than asked for."""
    if metric not in ("cosine", "mips") or bits not in (4, 8):
        raise ValueError(f"metric {metric!r}, bits {bits}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        parts = [_block_top(queries, codes, slots, candidates, metric, bits)
                 for codes, slots in blocks]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    top, slot, exact, norm = (torch.cat([p[i] for p in parts], dim=1)
                              for i in range(4))
    _, pos = torch.topk(top, min(candidates, top.shape[1]), dim=1)
    slot, exact, norm = (t.gather(1, pos).cpu().numpy()
                         for t in (slot, exact, norm))
    s = queries.shape[0]
    ids = np.full((s, k), -1, np.int64)
    scores = np.zeros((s, k), np.int64)
    cands = np.full((s, candidates), -1, np.int64)
    cands[:, :slot.shape[1]] = slot
    for i in range(s):
        order = _final_order(exact[i].tolist(), norm[i].tolist(),
                             metric)[:k]
        ids[i, :len(order)] = slot[i, order]
        scores[i, :len(order)] = exact[i, order]
    return ids, scores, cands
