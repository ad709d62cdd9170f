"""Attention: GQA with naive, chunked (flash-style) and decode paths (port
of `repro.models.attention`).

Plain torch ops that follow the reference's algorithm: the naive path
when the sequence fits one chunk or is not a multiple of it, otherwise an
online softmax over key chunks (for a causal query chunk i only key chunks
0..i are touched). Scores, softmax statistics and the value product are
f32; the output is cast to q's dtype.

Shapes: q (B, S, H, hd); k, v (B, T, KH, hd); GQA groups G = H // KH.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _split_groups(q: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KH, G, hd)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kh, h // kh, d)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None,
                    causal: bool = True) -> torch.Tensor:
    """O(S^2)-memory masked attention."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    scale = scale or hd ** -0.5
    qg = _split_groups(q, kh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk: int = 2048, scale: float | None = None,
                      causal: bool = True) -> torch.Tensor:
    """Flash-style attention; never materializes the (S, T) score matrix.
    S (and T) must be multiples of chunk, else the naive path is used."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    if s <= chunk or s % chunk != 0 or t % chunk != 0:
        return naive_attention(q, k, v, scale, causal)
    g = h // kh
    nk = t // chunk
    scale = scale or hd ** -0.5
    qg = _split_groups(q, kh)                                  # (B,S,KH,G,hd)
    pos = torch.arange(chunk, device=q.device)
    upper = pos[None, :] > pos[:, None]
    outs = []
    for i in range(s // chunk):
        qc = qg[:, i * chunk:(i + 1) * chunk].permute(0, 2, 3, 1, 4)
        qc = qc.to(torch.float32)                              # (B,KH,G,C,hd)
        acc = torch.zeros((b, kh, g, chunk, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, kh, g, chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        denom = torch.zeros((b, kh, g, chunk), dtype=torch.float32,
                            device=q.device)
        for j in range((i + 1) if causal else nk):
            kc = k[:, j * chunk:(j + 1) * chunk].to(torch.float32)
            vc = v[:, j * chunk:(j + 1) * chunk].to(torch.float32)
            srs = torch.einsum("bkgcd,btkd->bkgct", qc, kc) * scale
            if causal and j == i:
                srs = torch.where(upper, NEG_INF, srs)
            new_m = torch.maximum(m, srs.amax(dim=-1))
            p = torch.exp(srs - new_m[..., None])
            alpha = torch.exp(m - new_m)
            denom = denom * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgct,btkd->bkgcd",
                                                        p, vc)
            m = new_m
        outs.append(acc / torch.clamp(denom[..., None], min=1e-30))
    out = torch.cat(outs, dim=3)                               # (B,KH,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def chunked_causal_attention(q, k, v, chunk: int = 2048, scale=None):
    return chunked_attention(q, k, v, chunk, scale, causal=True)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length,
                     scale: float | None = None) -> torch.Tensor:
    """One-token attention against a (possibly partially filled) KV cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, T, KH, hd); length: () or (B,)
    count of valid cache positions (new token already written). At length
    0 every score is masked alike, so the softmax is uniform and the
    output is the mean of V, as in the reference."""
    b, _, h, hd = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    scale = scale or hd ** -0.5
    qg = _split_groups(q, kh)[:, 0]                            # (B,KH,G,hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    length = torch.as_tensor(length, device=q.device)
    valid = (torch.arange(t, dtype=torch.int32, device=q.device)[None, :]
             < length.reshape(-1, 1).to(torch.int32))          # (B or 1, T)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, hd).to(q.dtype)
