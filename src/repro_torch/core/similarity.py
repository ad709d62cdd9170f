"""Similarity: exact integer MIPS, the non-division cosine comparator, and
a stable top-k.

Port of `repro.core.similarity`. The plain integer products run in
float64: every partial sum of int8 x int8 products is an integer far below
2**53, so float64 is exact, and a float64 product is never computed in
TF32 (`torch.matmul` has no integer kernel on CUDA).

The rerank compares cosine similarities without division or sqrt: to
order s_a / sqrt(n_a) against s_b / sqrt(n_b) it compares s_a^2 * n_b with
s_b^2 * n_a (sign-aware). Those products reach 93 bits, so they are
computed exactly in 15-bit limbs held in int64 lanes.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Exact integer products
# ---------------------------------------------------------------------------

def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer dot product of int8 codes -> int32. a, b: (..., D)."""
    return (a.to(torch.int32) * b.to(torch.int32)).sum(dim=-1,
                                                        dtype=torch.int32)


def int_matvec(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N, D) int8 x (D,) int8 -> (N,) int32 scores, exact."""
    return (db.double() @ q.double()).to(torch.int32)


def int_matmul(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N, D) int8 x (B, D) int8 -> (B, N) int32 scores, exact."""
    return (q.double() @ db.double().T).to(torch.int32)


def int_bmm(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, M, D) int8 x (B, D) int8 -> (B, M) int32 per-lane scores."""
    return torch.bmm(rows.double(), q.double()[:, :, None])[..., 0].to(
        torch.int32)


# ---------------------------------------------------------------------------
# The non-division comparator (15-bit limbs in int64 lanes)
# ---------------------------------------------------------------------------

_LIMB = 15
_LIMB_MASK = (1 << _LIMB) - 1


def _to_limbs(x: torch.Tensor, num_limbs: int) -> list[torch.Tensor]:
    """Non-negative int64 -> little-endian 15-bit limbs."""
    return [(x >> (_LIMB * i)) & _LIMB_MASK for i in range(num_limbs)]


def _mul_limbs(a: list[torch.Tensor],
               b: list[torch.Tensor]) -> list[torch.Tensor]:
    """Exact schoolbook product of limb vectors -> len(a)+len(b) limbs."""
    out = [torch.zeros_like(a[0]) for _ in range(len(a) + len(b))]
    for i, ai in enumerate(a):
        carry = torch.zeros_like(ai)
        for j, bj in enumerate(b):
            t = out[i + j] + ai * bj + carry
            out[i + j] = t & _LIMB_MASK
            carry = t >> _LIMB
        for k in range(i + len(b), len(out)):        # ripple the last carry
            t = out[k] + carry
            out[k] = t & _LIMB_MASK
            carry = t >> _LIMB
    return out


def _limbs_gt_lt(a: list[torch.Tensor], b: list[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic (a > b, a < b) over equal-length limb vectors."""
    gt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones_like(gt)
    for a_l, b_l in zip(reversed(a), reversed(b)):
        gt = gt | (eq & (a_l > b_l))
        eq = eq & (a_l == b_l)
    return gt, ~gt & ~eq


def fraction_greater(s_a: torch.Tensor, n_a: torch.Tensor,
                     s_b: torch.Tensor, n_b: torch.Tensor) -> torch.Tensor:
    """Non-division comparator s_a/sqrt(n_a) > s_b/sqrt(n_b), elementwise
    with broadcasting.

    s_*: int32 dot products (any value except INT32_MIN); n_*: int32
    squared norms >= 0. A zero norm is treated as similarity 0.
    """
    s_a, s_b = s_a.to(torch.int64), s_b.to(torch.int64)
    n_a, n_b = n_a.to(torch.int64), n_b.to(torch.int64)
    s_a, s_b, n_a, n_b = torch.broadcast_tensors(s_a, s_b, n_a, n_b)
    zero = torch.zeros_like(s_a)
    sign_a = torch.where(n_a > 0, torch.sign(s_a), zero)
    sign_b = torch.where(n_b > 0, torch.sign(s_b), zero)

    # |s| <= 2**31 - 1 -> 3 limbs; s^2 -> 6 limbs; s^2 * n -> 9 limbs.
    abs_a = _to_limbs(s_a.abs(), 3)
    abs_b = _to_limbs(s_b.abs(), 3)
    prod_a = _mul_limbs(_mul_limbs(abs_a, abs_a),
                        _to_limbs(torch.clamp(n_b, min=1), 3))
    prod_b = _mul_limbs(_mul_limbs(abs_b, abs_b),
                        _to_limbs(torch.clamp(n_a, min=1), 3))
    mag_gt, mag_lt = _limbs_gt_lt(prod_a, prod_b)

    both_pos = (sign_a > 0) & (sign_b > 0)
    both_neg = (sign_a < 0) & (sign_b < 0)
    return torch.where(sign_a != sign_b, sign_a > sign_b,
                       (both_pos & mag_gt) | (both_neg & mag_lt))


def cosine_key_f32(scores: torch.Tensor,
                   norms_sq: torch.Tensor) -> torch.Tensor:
    """Float fast-path monotone key for cosine ranking: s / sqrt(n).

    The f32 bits can differ from the reference's by an ulp (`torch.rsqrt`
    and XLA's rsqrt round differently); every backend of this package
    shares this one computation, so they agree with each other exactly.
    """
    n = torch.clamp(norms_sq.to(torch.float32), min=1.0)
    key = scores.to(torch.float32) * torch.rsqrt(n)
    return torch.where(norms_sq > 0, key, torch.zeros_like(key))


# ---------------------------------------------------------------------------
# Stable top-k
# ---------------------------------------------------------------------------

def _ordered_i32(x: torch.Tensor) -> torch.Tensor:
    """An order-preserving int32 image of int32 or float32 values.

    Floats map by their bits with the usual sign flip, which is a total
    order: -0.0 sorts below +0.0 and -inf below every finite value, as in
    XLA's top_k."""
    if x.dtype == torch.float32:
        bits = x.view(torch.int32)
        return bits ^ ((bits >> 31) & 0x7FFFFFFF)
    if x.dtype == torch.int32:
        return x
    raise TypeError(f"stable_topk takes int32 or float32 keys, got {x.dtype}")


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties toward the lower index.

    `jax.lax.top_k`'s order, which `torch.topk` does not promise: each key
    is packed into a unique int64 — its order-preserving 32-bit image in
    the high half, the bit-complemented index in the low half — and that
    is what `torch.topk` ranks. Returns (values, int64 indices)."""
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    packed = (_ordered_i32(x).to(torch.int64) << 32) | (~idx & 0xFFFFFFFF)
    _, top = torch.topk(packed, k, dim=-1, sorted=True)
    return torch.gather(x, -1, top), top


def rerank_dense_comparator(scores: torch.Tensor, norms_sq: torch.Tensor,
                            k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's dense-comparison rerank, batched over lanes.

    scores, norms_sq: (B, K). Builds each lane's (K, K) pairwise
    'greater' matrix with the non-division comparator, ranks by win count
    with a lower-index tie-break, and returns (top-k indices into the
    candidate set (B, k) int64, their int32 scores (B, k))."""
    kk = scores.shape[-1]
    gt = fraction_greater(scores[:, :, None], norms_sq[:, :, None],
                          scores[:, None, :], norms_sq[:, None, :])
    wins = gt.sum(dim=-1, dtype=torch.int32)
    order_key = wins * kk - torch.arange(kk, dtype=torch.int32,
                                         device=scores.device)
    _, idx = stable_topk(order_key, k)
    return idx, torch.gather(scores, -1, idx)


def topk_mips(scores: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by raw integer dot product (MIPS), ties toward the lower
    index. Returns (values, int32 indices), as `jax.lax.top_k` does."""
    values, idx = stable_topk(scores, k)
    return values, idx.to(torch.int32)
