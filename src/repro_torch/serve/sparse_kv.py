"""Sparse-KV decode attention: the cache-facing side of the engine's KV
cascade (port of `repro.serve.sparse_kv`).

Decode attention over a long cache is memory bound: a dense step streams
every position's bf16 K and V. Here the keys are stored as INT8 nibble
planes and each step runs the engine's cascade (`engine.kv_decode_batched`:
page prune -> sign prescreen -> approx top-k on the MSB plane -> exact
attention over the survivors):

  * `QuantKVCache` — nibble-planar INT8 K and compute-dtype V of one layer,
    with optional page-centroid sidecars for the page prune;
  * `sparse_decode_attention` — the entry point; without a prune or a
    prescreen it is bit-identical to `sparse_decode_attention_ref`, the
    original two-stage schedule kept as the oracle;
  * the byte model (`dense_bytes_per_step`, `sparse_bytes_per_step`),
    equal to the engine's `kv_plan` ledger.

Everything runs on the device of its inputs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bitplanar, engine, quantization, similarity

NEG_INF = -1e30


@dataclasses.dataclass
class QuantKVCache:
    """INT8 K stored nibble-planar and V at compute precision, one layer.

    k_msb / k_lsb: (B, T, KH, hd//2) uint8 nibble planes of INT8 keys.
    k_scale: (B, T, KH) f32 per-(position, head) scales.
    v: (B, T, KH, hd) values.
    cent_msb / cent_scale: optional (B, P, KH, hd//2) / (B, P, KH) page
        centroids (P = T // page_rows) for the engine's page prune (see
        `build_page_centroids` / `update_page_centroids`).
    """

    k_msb: torch.Tensor
    k_lsb: torch.Tensor
    k_scale: torch.Tensor
    v: torch.Tensor
    cent_msb: torch.Tensor | None = None
    cent_scale: torch.Tensor | None = None


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) f32 -> (int8 codes (..., hd), f32 scale (...)): symmetric
    per-row INT8, ``max(amax, 1e-12) / 127``, round half to even. Both
    divisions are by tensors, as `jnp` divides (a scalar divisor may
    become a multiply by its reciprocal, which rounds differently)."""
    amax = x.abs().amax(dim=-1)
    scale = quantization.true_div(torch.clamp(amax, min=1e-12), 127.0)
    codes = torch.clamp(torch.round(x / scale[..., None].expand_as(x)),
                        -127, 127).to(torch.int8)
    return codes, scale


def quantize_keys(k: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k (B, T, KH, hd) -> (msb_plane, lsb_plane, scale) per (B, T, KH)."""
    b, t, kh, hd = k.shape
    codes, scale = _quantize_rows(k.to(torch.float32))
    msb, lsb = bitplanar.pack_nibble_planes(codes.reshape(-1, hd))
    return (msb.reshape(b, t, kh, hd // 2), lsb.reshape(b, t, kh, hd // 2),
            scale)


def build_quant_cache(k: torch.Tensor, v: torch.Tensor) -> QuantKVCache:
    msb, lsb, scale = quantize_keys(k)
    return QuantKVCache(k_msb=msb, k_lsb=lsb, k_scale=scale, v=v)


def _quantize_centroids(mean: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) f32 page means -> (packed MSB nibbles (..., hd//2), scale
    (...)): the keys' INT8 scheme, so the centroids are one more nibble
    plane the rows kernel scores."""
    hd = mean.shape[-1]
    codes, scale = _quantize_rows(mean)
    msb, _ = bitplanar.pack_nibble_planes(codes.reshape(-1, hd))
    return msb.reshape(*mean.shape[:-1], hd // 2), scale


def _dequantized(k_msb: torch.Tensor, k_lsb: torch.Tensor,
                 k_scale: torch.Tensor) -> torch.Tensor:
    """(..., KH, hd//2) planes and (..., KH) scales -> (..., KH, hd) f32."""
    hd2 = k_msb.shape[-1]
    k_int = bitplanar.reconstruct_int8(k_msb.reshape(-1, hd2),
                                       k_lsb.reshape(-1, hd2))
    return (k_int.reshape(*k_msb.shape[:-1], 2 * hd2).to(torch.float32)
            * k_scale[..., None])


def build_page_centroids(cache: QuantKVCache, length: torch.Tensor,
                         page_rows: int = 8) -> QuantKVCache:
    """Per-page mean-key centroids for the engine's page prune.

    A page is `page_rows` consecutive positions; its centroid is the mean
    of its valid (position < length) dequantized keys, quantized to INT8
    and kept as packed MSB nibbles and an f32 scale per (B, page, KH).
    Returns a new cache with cent_msb/cent_scale set. T must be a multiple
    of page_rows."""
    b, t, kh, hd2 = cache.k_msb.shape
    hd = hd2 * 2
    if t % page_rows:
        raise ValueError(f"cache length {t} not a multiple of "
                         f"page_rows={page_rows}")
    p = t // page_rows
    dev = cache.k_msb.device
    pagev = _dequantized(cache.k_msb, cache.k_lsb, cache.k_scale).reshape(
        b, p, page_rows, kh, hd)
    pos = (torch.arange(p, device=dev)[:, None] * page_rows
           + torch.arange(page_rows, device=dev)[None, :])    # (P, pr)
    live = pos[None] < length.reshape(-1, 1, 1).to(torch.int32)
    cnt = live.sum(dim=2).to(torch.float32)                   # (B, P)
    mean = (torch.where(live[..., None, None], pagev, 0.0).sum(dim=2)
            / torch.clamp(cnt, min=1.0)[..., None, None])     # (B, P, KH, hd)
    cent_msb, cent_scale = _quantize_centroids(mean)
    return dataclasses.replace(cache, cent_msb=cent_msb,
                               cent_scale=cent_scale)


def update_page_centroids(k_msb: torch.Tensor, k_lsb: torch.Tensor,
                          k_scale: torch.Tensor, cent_msb: torch.Tensor,
                          cent_scale: torch.Tensor, length: torch.Tensor,
                          page_rows: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Refresh one page's centroid after an append.

    A decode step writes position length - 1, so only that page's mean can
    change: `page_rows` quantized rows are read again and one centroid is
    quantized again. Returns new (cent_msb, cent_scale)."""
    b = k_msb.shape[0]
    dev = k_msb.device
    idx = (length - 1).to(torch.int64)                        # (B,)
    pidx = torch.div(idx, page_rows, rounding_mode="floor")
    start = pidx * page_rows
    offs = torch.arange(page_rows, dtype=torch.int64, device=dev)
    rows = start[:, None] + offs[None, :]                     # (B, pr)
    bidx = torch.arange(b, device=dev)[:, None]
    k_f = _dequantized(k_msb[bidx, rows], k_lsb[bidx, rows],
                       k_scale[bidx, rows])                   # (B, pr, KH, hd)
    ncnt = torch.clamp(length.to(torch.int64) - start, 1, page_rows)
    live = offs[None, :] < ncnt[:, None]                      # (B, pr)
    mean = (torch.where(live[:, :, None, None], k_f, 0.0).sum(dim=1)
            / ncnt.to(torch.float32)[:, None, None])          # (B, KH, hd)
    nm, ns = _quantize_centroids(mean)
    rows_b = torch.arange(b, device=dev)
    cent_msb, cent_scale = cent_msb.clone(), cent_scale.clone()
    cent_msb[rows_b, pidx] = nm
    cent_scale[rows_b, pidx] = ns
    return cent_msb, cent_scale


def kv_policy(cache: QuantKVCache, length: torch.Tensor
              ) -> engine.KVCachePolicy:
    """This cache slice as the engine's corpus."""
    return engine.KVCachePolicy(
        k_msb=cache.k_msb, k_lsb=cache.k_lsb, k_scale=cache.k_scale,
        v=cache.v,
        length=torch.as_tensor(length, dtype=torch.int32,
                               device=cache.v.device),
        cent_msb=cache.cent_msb, cent_scale=cache.cent_scale)


def sparse_decode_attention(q: torch.Tensor, cache: QuantKVCache,
                            length: torch.Tensor, top_k: int,
                            scale: float | None = None, *,
                            npages: int | None = None,
                            prescreen_c0: int | None = None,
                            page_rows: int = 8,
                            backend: str = "cuda") -> torch.Tensor:
    """q (B, 1, H, hd) against the quantized cache -> (B, 1, H, hd).

    The engine's KV cascade. Without `npages` or `prescreen_c0` it is the
    original two-stage filter (approximate MSB-nibble scores, exact masked
    softmax over the per-(B, KH) top-k), bit-identical to
    `sparse_decode_attention_ref`. `npages` prepends the page prune (the
    cache needs centroids), `prescreen_c0` the sign prescreen after it.
    `backend` picks the integer stages' functions, as
    `RetrievalConfig.backend` does: "cuda", the default, launches the
    kernels on a CUDA tensor and takes their plain versions on a CPU one;
    "torch" takes the plain versions everywhere."""
    cfg = engine.KVCascadeConfig(
        top_k=top_k, npages=npages, page_rows=page_rows,
        prescreen_c0=prescreen_c0, backend=backend, scale=scale)
    return engine.kv_decode_batched(q, kv_policy(cache, length), cfg)


def sparse_decode_attention_ref(q: torch.Tensor, cache: QuantKVCache,
                                length: torch.Tensor, top_k: int,
                                scale: float | None = None) -> torch.Tensor:
    """The original two-stage implementation, kept as the bit-parity oracle
    of the engine path (including the length < top_k and empty-cache
    masked-softmax cases)."""
    b, _, h, hd = q.shape
    t, kh = cache.v.shape[1], cache.v.shape[2]
    g = h // kh
    scale = scale or hd ** -0.5
    k_eff = min(top_k, t)
    dev = q.device
    length = torch.as_tensor(length, dtype=torch.int32, device=dev)

    # ---- Stage 1: approximate scores from the MSB nibble plane only.
    k_msb = bitplanar.unpack_nibble_plane_signed(
        cache.k_msb.reshape(-1, hd // 2)).reshape(b, t, kh, hd)
    qg = q.reshape(b, kh, g, hd).to(torch.float32)
    s1 = torch.matmul(qg, k_msb.transpose(1, 2).to(torch.float32)
                      .contiguous().transpose(-1, -2))        # (B,KH,G,T)
    s1 = s1 * cache.k_scale.transpose(1, 2)[:, :, None, :]
    s1 = s1.amax(dim=2)                                       # group max
    valid = (torch.arange(t, dtype=torch.int32, device=dev)[None, None, :]
             < length.reshape(-1, 1, 1))
    s1 = s1.masked_fill(~valid, NEG_INF)
    _, sel = similarity.stable_topk(s1, k_eff)  # ties: lower position

    # ---- Stage 2: exact attention on the selected positions only. The
    # planes are gathered first and only the k survivors rebuilt.
    bidx = torch.arange(b, device=dev)[:, None, None]
    hidx = torch.arange(kh, device=dev)[None, :, None]
    msb_sel = cache.k_msb[bidx, sel, hidx]
    lsb_sel = cache.k_lsb[bidx, sel, hidx]
    scale_sel = cache.k_scale[bidx, sel, hidx]                # (B,KH,k)
    k_int = bitplanar.reconstruct_int8(
        msb_sel.reshape(-1, hd // 2),
        lsb_sel.reshape(-1, hd // 2)).reshape(b, kh, k_eff, hd)
    k_sel = k_int.to(torch.float32) * scale_sel[..., None]    # (B,KH,k,hd)
    v_sel = cache.v[bidx, sel, hidx].to(torch.float32)
    s2 = torch.matmul(qg, k_sel.contiguous().transpose(-1, -2)) * scale
    sel_valid = sel < length.reshape(-1, 1, 1)
    mask = sel_valid[:, :, None, :]
    s2 = s2.masked_fill(~mask, NEG_INF)
    # Masked softmax with a zero-output fallback: at length == 0 every
    # selected position is invalid, and a plain softmax over the all-NEG_INF
    # row would give NaNs; masked entries weigh exp 0, and an all-masked
    # row divides by 1.
    e = torch.where(mask, torch.exp(s2 - s2.amax(dim=-1, keepdim=True)),
                    0.0)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / torch.where(denom > 0, denom, 1.0)
    out = torch.matmul(p, v_sel)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def dense_bytes_per_step(t: int, hd: int, kv_bytes: int = 2) -> int:
    """Device-memory bytes per (layer, kv-head) of dense decode: K and V."""
    return 2 * t * hd * kv_bytes


def sparse_bytes_per_step(t: int, hd: int, top_k: int,
                          kv_bytes: int = 2) -> int:
    """The MSB plane scan with its scales, then the exact gather of the
    top-k rows, per (layer, kv-head) per step: t*hd/2 + 4t, then both
    nibble planes and the scale of each survivor (k*(hd + 4); K is rebuilt
    from INT8, never read at bf16) and its V row (k*hd*kv_bytes). Equals
    `engine.kv_plan`'s no-prune approx and exact stages divided by
    (layers * batch * kv_heads)."""
    return t * hd // 2 + t * 4 + top_k * (hd + 4) + top_k * hd * kv_bytes


def decode_plan(cfg_or_topk, *, batch: int, kv_heads: int, q_heads: int,
                seq_len: int, head_dim: int,
                layers: int = 1) -> engine.SchedulePlan:
    """The engine's kv_plan from a KVCascadeConfig or a bare top_k (the
    no-prune schedule)."""
    cfg = (cfg_or_topk if isinstance(cfg_or_topk, engine.KVCascadeConfig)
           else engine.KVCascadeConfig(top_k=int(cfg_or_topk)))
    return engine.kv_plan(cfg, batch=batch, kv_heads=kv_heads,
                          q_heads=q_heads, seq_len=seq_len,
                          head_dim=head_dim, layers=layers)
