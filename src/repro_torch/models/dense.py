"""Dense decoder-only transformer (GQA + RoPE + SwiGLU, pre-RMSNorm): port
of `repro.models.dense`.

Covers qwen2 (QKV bias, tied embeddings) and the LM backbone of a VLM
(optional prefix embeddings). Layer parameters are stacked on a leading
axis, as in the reference; the layers run one after another. Every
product casts its f32 weight to the compute dtype per call, as the
reference does (the tied head casts the whole embedding table per call).

Decode writes the new token's K and V (or its quantized key planes) into
the cache it is given, in place, and returns a cache over the same
tensors; the reference returns new arrays (ROADMAP C14). A write past the
cache's allocated length raises, where the reference drops it.

`loss_fn` is the training loss. Under `cfg.remat`, while autograd
records, `forward` runs each block through `torch.utils.checkpoint`
(the counterpart of the reference's `jax.checkpoint`): the block's
activations are recomputed in the backward pass instead of kept.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (ModelConfig, Params, apply_rope,
                                       check_generator, constrain,
                                       constrain_kv, cross_entropy_loss,
                                       dense_init, embed_init, layer,
                                       remat_applies, residual_pattern,
                                       rmsnorm, rope_tables, swiglu)
from repro_torch.serve import sparse_kv


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # (L, B, T, KH, hd)
    v: torch.Tensor        # (L, B, T, KH, hd)
    length: torch.Tensor   # (B,) int32 — valid positions per sequence


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Params:
    """Random parameters drawn from `gen` on `device` (the CUDA device
    unless the caller asks for another; `gen` must be on it)."""
    check_generator(gen, resolve_device(device))
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.pdtype
    blocks = init_blocks(cfg, gen)        # drawn before the embedding
    params = {
        "embed": embed_init(gen, (v, d), dt),
        "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, v), dt)
    return params


def init_blocks(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """cfg.num_layers blocks' parameters, stacked on axis 0, drawn from
    `gen` on its device."""
    l, d, h, kh, hd, f = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                          cfg.num_kv_heads, cfg.hd, cfg.d_ff)
    dt = cfg.pdtype

    def const(shape, fill):
        return torch.full(shape, fill, dtype=dt, device=gen.device)
    blocks = {
        "ln1": const((l, d), 1.0),
        "wq": dense_init(gen, (l, d, h * hd), dt),
        "wk": dense_init(gen, (l, d, kh * hd), dt),
        "wv": dense_init(gen, (l, d, kh * hd), dt),
        "wo": dense_init(gen, (l, h * hd, d), dt, scale=(h * hd) ** -0.5),
        "ln2": const((l, d), 1.0),
        "w_gate": dense_init(gen, (l, d, f), dt),
        "w_up": dense_init(gen, (l, d, f), dt),
        "w_down": dense_init(gen, (l, f, d), dt, scale=f ** -0.5),
    }
    if cfg.qkv_bias:
        blocks["bq"] = const((l, h * hd), 0.0)
        blocks["bk"] = const((l, kh * hd), 0.0)
        blocks["bv"] = const((l, kh * hd), 0.0)
    return blocks


def _qkv(p, x, cfg: ModelConfig):
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (constrain(q.reshape(b, s, cfg.num_heads, cfg.hd),
                      "dp", None, "mp", None),
            constrain(k.reshape(b, s, cfg.num_kv_heads, cfg.hd),
                      "dp", None, "mp", None),
            constrain(v.reshape(b, s, cfg.num_kv_heads, cfg.hd),
                      "dp", None, "mp", None))


def _mlp_residual(p, x, cfg: ModelConfig) -> torch.Tensor:
    hn = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(hn, p["w_gate"], p["w_up"], p["w_down"])


def block_fwd(p, x, cos, sin, cfg: ModelConfig):
    """Full-sequence (prefill) block. Returns (x, (k, v))."""
    hn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, hn, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attn.chunked_causal_attention(q, k, v, cfg.attn_chunk)
    x = constrain(x + o.reshape(*o.shape[:2], -1) @ p["wo"].to(x.dtype),
                  *residual_pattern(cfg))
    return constrain(_mlp_residual(p, x, cfg), *residual_pattern(cfg)), (k, v)


def _step_slots(length: torch.Tensor, t: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (rows, positions) a decode step writes: position length - 1 of
    each sequence, where `length` counts the new token. Raises when a
    sequence's cache is full (the reference drops such a write)."""
    if int(length.max()) > t:
        raise IndexError(f"decode past the cache: a sequence would reach "
                         f"length {int(length.max())} of {t} positions")
    return (torch.arange(length.shape[0], device=length.device),
            (length - 1).to(torch.int64))


def block_decode(p, x, kc, vc, length, cos, sin, cfg: ModelConfig):
    """Single-token block against a per-layer KV cache slice.

    x (B,1,D); kc/vc (B,T,KH,hd); length (B,) = count INCLUDING this token.
    Writes the token's K and V into kc/vc in place; returns (x, kc, vc)."""
    return _block_decode(p, x, kc, vc, length,
                         _step_slots(length, kc.shape[1]), cos, sin, cfg)


def _block_decode(p, x, kc, vc, length, slots, cos, sin, cfg: ModelConfig):
    hn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, hn, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows, idx = slots
    kc[rows, idx] = k[:, 0]
    vc[rows, idx] = v[:, 0]
    kc, vc = constrain_kv(kc), constrain_kv(vc)
    o = attn.decode_attention(q, kc, vc, length)
    x = x + o.reshape(x.shape[0], 1, -1) @ p["wo"].to(x.dtype)
    return _mlp_residual(p, x, cfg), kc, vc


def embed_tokens(params, tokens, cfg: ModelConfig,
                 prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    dev = params["embed"].device
    x = params["embed"][torch.as_tensor(tokens, device=dev)].to(cfg.cdtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dev, cfg.cdtype), x], dim=1)
    return constrain(x, "dp", None, None)


def _logits(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].to(x.dtype).T if cfg.tie_embeddings
            else params["lm_head"].to(x.dtype))
    return constrain(x @ head, "dp", None, "mp")


def _positions(s: int, dev) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=dev)


def _block_out(p, x, cos, sin, cfg: ModelConfig) -> torch.Tensor:
    return block_fwd(p, x, cos, sin, cfg)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forcing forward -> logits (B, S(+P), V)."""
    x = embed_tokens(params, tokens, cfg, prefix_embeds)
    cos, sin = rope_tables(_positions(x.shape[1], x.device), cfg.hd,
                           cfg.rope_theta)
    remat = remat_applies(cfg, x, params)
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        if remat:
            x = checkpoint(_block_out, p, x, cos, sin, cfg,
                           use_reentrant=False)
        else:
            x = _block_out(p, x, cos, sin, cfg)
    return _logits(params, x, cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token CE of batch["tokens"] against batch["labels"]; with
    batch["prefix_embeds"] (the VLM's patches) their positions are
    labelled -1, so they carry no loss."""
    prefix = batch.get("prefix_embeds")
    logits = forward(params, batch["tokens"], cfg, prefix)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if prefix is not None:
        pad = torch.full((labels.shape[0], prefix.shape[1]), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return cross_entropy_loss(logits, labels)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=cfg.cdtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.cdtype, device=dev),
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=dev))


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None, lengths: torch.Tensor | None = None,
            prefix_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt, return (logits (B, S, V), primed KV cache of
    `max_len` positions)."""
    x = embed_tokens(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max_len or s, device=x.device)
    cos, sin = rope_tables(_positions(s, x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.num_layers):
        x, (k, v) = block_fwd(layer(params["blocks"], i), x, cos, sin, cfg)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    set_lengths(cache.length, lengths, s)
    return _logits(params, x, cfg), cache


def set_lengths(length: torch.Tensor, lengths, s: int) -> None:
    """A primed cache's lengths: `lengths` where given, else s for every
    row."""
    if lengths is None:
        length.fill_(s)
    else:
        length.copy_(torch.as_tensor(lengths, device=length.device))


def decode_step(params: Params, cache: KVCache, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, KVCache]:
    """One decode step. tokens (B, 1) -> logits (B, 1, V), the cache with
    the token written."""
    x = embed_tokens(params, tokens, cfg)
    length = cache.length + 1
    cos, sin = rope_tables((length - 1)[:, None], cfg.hd, cfg.rope_theta)
    slots = _step_slots(length, cache.k.shape[2])    # one host read a step
    for i in range(cfg.num_layers):
        x, _, _ = _block_decode(layer(params["blocks"], i), x, cache.k[i],
                                cache.v[i], length, slots, cos, sin, cfg)
    return _logits(params, x, cfg), KVCache(k=cache.k, v=cache.v,
                                            length=length)


# ---------------------------------------------------------------------------
# Quantized-KV decode: the paper's two-stage idea applied to the KV cache.
# Keys live as INT8 nibble planes; each step runs the engine's KV cascade
# (serve/sparse_kv.py) per layer.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantCache:
    k_msb: torch.Tensor    # (L, B, T, KH, hd//2) uint8
    k_lsb: torch.Tensor    # (L, B, T, KH, hd//2) uint8
    k_scale: torch.Tensor  # (L, B, T, KH) f32
    v: torch.Tensor        # (L, B, T, KH, hd)
    length: torch.Tensor   # (B,)
    # Optional page-centroid sidecars (P = T // page_rows), kept up to date
    # by decode_step_quant; they enable the cascade's page prune.
    cent_msb: torch.Tensor | None = None    # (L, B, P, KH, hd//2) uint8
    cent_scale: torch.Tensor | None = None  # (L, B, P, KH) f32
    page_rows: int = 8

    def layer(self, i: int) -> sparse_kv.QuantKVCache:
        """Layer i as the cascade's cache (views of this cache)."""
        return sparse_kv.QuantKVCache(
            k_msb=self.k_msb[i], k_lsb=self.k_lsb[i],
            k_scale=self.k_scale[i], v=self.v[i],
            cent_msb=None if self.cent_msb is None else self.cent_msb[i],
            cent_scale=(None if self.cent_scale is None
                        else self.cent_scale[i]))


def init_quant_cache(cfg: ModelConfig, batch: int, max_len: int,
                     page_rows: int | None = None, *,
                     device=None) -> QuantCache:
    dev = resolve_device(device)
    l, kh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)
    cent_msb = cent_scale = None
    if page_rows is not None:
        if max_len % page_rows:
            raise ValueError(f"max_len={max_len} not a multiple of "
                             f"page_rows={page_rows}")
        p = max_len // page_rows
        cent_msb = zeros((l, batch, p, kh, hd // 2), torch.uint8)
        cent_scale = zeros((l, batch, p, kh), torch.float32)
    return QuantCache(
        k_msb=zeros((l, batch, max_len, kh, hd // 2), torch.uint8),
        k_lsb=zeros((l, batch, max_len, kh, hd // 2), torch.uint8),
        k_scale=zeros((l, batch, max_len, kh), torch.float32),
        v=zeros((l, batch, max_len, kh, hd), cfg.cdtype),
        length=zeros((batch,), torch.int32),
        cent_msb=cent_msb, cent_scale=cent_scale, page_rows=page_rows or 8)


def quantize_cache(cache: KVCache, page_rows: int | None = None
                   ) -> QuantCache:
    """Convert a prefill's KVCache into the nibble-planar QuantCache (keys
    quantized per (position, head)). V is copied, so each cache can be
    decoded on its own (decode writes in place). With `page_rows` the
    page-centroid sidecars are built too, so the first decode step can
    run the paged cascade over the prompt."""
    l, b, t, kh, hd = cache.k.shape
    ms, ls, ss = sparse_kv.quantize_keys(cache.k.reshape(l * b, t, kh, hd))
    out = QuantCache(k_msb=ms.reshape(l, b, t, kh, hd // 2),
                     k_lsb=ls.reshape(l, b, t, kh, hd // 2),
                     k_scale=ss.reshape(l, b, t, kh), v=cache.v.clone(),
                     length=cache.length.clone(), page_rows=page_rows or 8)
    if page_rows is not None:
        cents = [sparse_kv.build_page_centroids(out.layer(i), cache.length,
                                                page_rows) for i in range(l)]
        out.cent_msb = torch.stack([c.cent_msb for c in cents])
        out.cent_scale = torch.stack([c.cent_scale for c in cents])
    return out


def decode_step_quant(params: Params, cache: QuantCache,
                      tokens: torch.Tensor, cfg: ModelConfig,
                      top_k: int = 256, npages: int | None = None,
                      prescreen_c0: int | None = None,
                      backend: str = "cuda"
                      ) -> tuple[torch.Tensor, QuantCache]:
    """Decode against the INT8 nibble-planar K cache through the engine's
    KV cascade (`sparse_kv.sparse_decode_attention`): per layer the MSB
    plane is scanned and exact attention runs over the top_k survivors;
    with `npages` (a cache built with page_rows) the scan shrinks to
    npages * page_rows rows behind the page prune, and `prescreen_c0`
    puts the sign prescreen between prune and scan. Only the page the
    token lands on has its centroid refreshed. `backend` as in
    `sparse_decode_attention`: "cuda" launches the kernels on CUDA
    tensors, "torch" takes the plain versions."""
    if npages is not None and cache.cent_msb is None:
        raise ValueError("npages requires a paged cache — build it with "
                         "init_quant_cache(page_rows=...)")
    page_rows = cache.page_rows
    x = embed_tokens(params, tokens, cfg)
    length = cache.length + 1
    cos, sin = rope_tables((length - 1)[:, None], cfg.hd, cfg.rope_theta)
    b = x.shape[0]
    rows, idx = _step_slots(length, cache.v.shape[2])
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        hn = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(p, hn, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        nm, nl, nsc = sparse_kv.quantize_keys(k)        # (B,1,KH,hd//2) x2
        cache.k_msb[i, rows, idx] = nm[:, 0]
        cache.k_lsb[i, rows, idx] = nl[:, 0]
        cache.k_scale[i, rows, idx] = nsc[:, 0]
        cache.v[i, rows, idx] = v[:, 0]
        if cache.cent_msb is not None:
            cm, cs = sparse_kv.update_page_centroids(
                cache.k_msb[i], cache.k_lsb[i], cache.k_scale[i],
                cache.cent_msb[i], cache.cent_scale[i], length, page_rows)
            cache.cent_msb[i] = cm
            cache.cent_scale[i] = cs
        o = sparse_kv.sparse_decode_attention(
            q, cache.layer(i), length, top_k, npages=npages,
            prescreen_c0=prescreen_c0, page_rows=page_rows, backend=backend)
        x = x + o.reshape(b, 1, -1) @ p["wo"].to(x.dtype)
        x = _mlp_residual(p, x, cfg)
    return _logits(params, x, cfg), dataclasses.replace(cache, length=length)
