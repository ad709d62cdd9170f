"""MiniLM-style sentence embedder, the paper's embedding model (port of
`repro.models.embedder`).

A small bidirectional transformer encoder + masked mean pooling + linear
projection to `pooled_dim` (512 in the paper) + L2 normalization. Its
attention takes no mask: the mask weights only the pooling, as in the
reference. `info_nce_loss` trains it: an in-batch-negative contrastive
loss over (query, positive-doc) pairs.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.core.quantization import true_div
from repro_torch.models.common import (ModelConfig, Params, apply_rope,
                                       check_generator, dense_init,
                                       embed_init, layer, rmsnorm,
                                       rope_tables, swiglu)

MINILM_CFG = ModelConfig(
    name="minilm-embedder", family="dense", num_layers=6, d_model=384,
    num_heads=12, num_kv_heads=12, d_ff=1536, vocab_size=30522,
    pooled_dim=512, rope_theta=1e4, compute_dtype="float32", remat=False)


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Params:
    """Random parameters drawn from `gen` on `device` (the CUDA device
    unless the caller asks for another; `gen` must be on it)."""
    check_generator(gen, resolve_device(device))
    l, d, h, hd, f = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hd,
                      cfg.d_ff)
    dt = cfg.pdtype
    ones = torch.ones((l, d), dtype=dt, device=gen.device)
    return {
        "embed": embed_init(gen, (cfg.vocab_size, d), dt),
        "blocks": {
            "ln1": ones,
            "wq": dense_init(gen, (l, d, h * hd), dt),
            "wk": dense_init(gen, (l, d, h * hd), dt),
            "wv": dense_init(gen, (l, d, h * hd), dt),
            "wo": dense_init(gen, (l, h * hd, d), dt, scale=(h * hd) ** -0.5),
            "ln2": ones.clone(),
            "w_gate": dense_init(gen, (l, d, f), dt),
            "w_up": dense_init(gen, (l, d, f), dt),
            "w_down": dense_init(gen, (l, f, d), dt, scale=f ** -0.5),
        },
        "final_norm": torch.ones((d,), dtype=dt, device=gen.device),
        "proj": dense_init(gen, (d, cfg.pooled_dim), dt),
    }


def encode(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """tokens (B, S) [+ mask (B, S) bool] -> L2-normalized (B, pooled_dim)
    f32, on the parameters' device."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=dev)
    x = params["embed"][tokens].to(cfg.cdtype)
    b, s = tokens.shape
    cos, sin = rope_tables(torch.arange(s, dtype=torch.int32, device=dev),
                           cfg.hd, cfg.rope_theta)
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        hn = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = (
            (hn @ p[w].to(x.dtype)).reshape(b, s, cfg.num_heads, cfg.hd)
            for w in ("wq", "wk", "wv"))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        o = attn.naive_attention(q, k, v, causal=False)
        x = x + o.reshape(b, s, -1) @ p["wo"].to(x.dtype)
        hn = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + swiglu(hn, p["w_gate"], p["w_up"], p["w_down"])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    m = torch.as_tensor(mask, device=dev).to(torch.float32)[..., None]
    pooled = (torch.sum(x.to(torch.float32) * m, dim=1)
              / torch.clamp(torch.sum(m, dim=1), min=1.0))
    emb = pooled @ params["proj"].to(torch.float32)
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1,
                                                      keepdim=True), min=1e-9)


def info_nce_loss(params: Params, batch: dict, cfg: ModelConfig,
                  temperature: float = 0.05) -> torch.Tensor:
    """In-batch-negative contrastive loss over (query, positive-doc)
    pairs: query i's positive is doc i, the batch's other docs its
    negatives."""
    q = encode(params, batch["query_tokens"], cfg, batch.get("query_mask"))
    d = encode(params, batch["doc_tokens"], cfg, batch.get("doc_mask"))
    logits = true_div(q @ d.T, temperature)                  # (B, B)
    return torch.mean(torch.logsumexp(logits, dim=-1)
                      - torch.diagonal(logits))
