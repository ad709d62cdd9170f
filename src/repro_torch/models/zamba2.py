"""Zamba2: a Mamba2 backbone with one SHARED attention block (hybrid):
port of `repro.models.zamba2`.

After every `hybrid_attn_period` mamba2 layers, one shared transformer
block (GQA attention + SwiGLU MLP, the dense model's block) runs. Every
application reads the same tensors (Zamba's parameter sharing), so the
shared block's grad is the sum over its applications; each application
keeps its OWN KV cache. As in the reference, the upstream model's
per-application LoRA deltas are left out (ROADMAP C26), and the shared
block casts its weights to the compute dtype at each application.

Cache: the SSM state and conv tail of every mamba2 layer plus a KV cache
with a leading application axis (APPS, B, T, KH, hd). Decode writes
every layer's state and conv tail and each application's K and V in
place (ROADMAP C14). Under `cfg.remat`, while autograd records, each
superblock (its mamba2 layers and the shared block) runs through
`torch.utils.checkpoint`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import dense, mamba2
from repro_torch.models.common import (ModelConfig, Params, check_generator,
                                       cross_entropy_loss, embed_init, layer,
                                       remat_applies, rope_tables,
                                       stacked_init)


@dataclasses.dataclass
class HybridCache:
    state: torch.Tensor    # (L, B, H, P, N) f32: mamba2 states
    conv: torch.Tensor     # (L, B, W-1, conv_dim)
    k: torch.Tensor        # (APPS, B, T, KH, hd)
    v: torch.Tensor        # (APPS, B, T, KH, hd)
    length: torch.Tensor   # (B,) int32


def num_apps(cfg: ModelConfig) -> int:
    if cfg.num_layers % cfg.hybrid_attn_period:
        raise ValueError(f"{cfg.num_layers} layers do not split into "
                         f"superblocks of {cfg.hybrid_attn_period}")
    return cfg.num_layers // cfg.hybrid_attn_period


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Params:
    """Random parameters drawn from `gen` on `device` (the CUDA device
    unless the caller asks for another; `gen` must be on it): the
    reference's keys and shapes, `shared` one dense block (no layer
    axis)."""
    check_generator(gen, resolve_device(device))
    num_apps(cfg)
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.pdtype
    blocks = mamba2.init_blocks(cfg, gen, cfg.num_layers)
    shared = layer(dense.init_blocks(cfg.with_(num_layers=1), gen), 0)
    params = {"embed": embed_init(gen, (v, d), dt), "blocks": blocks,
              "shared": shared,
              "final_norm": torch.ones((d,), dtype=dt, device=gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = stacked_init(gen, (), (d, v), dt)
    return params


def _superblock(params, i: int, x, cos, sin, cfg: ModelConfig):
    """Superblock i: its mamba2 layers, then the shared block. Returns (x,
    [(state, conv)] per mamba2 layer, (k, v))."""
    per = cfg.hybrid_attn_period
    ssm = []
    for j in range(per):
        x, sc = mamba2.block_fwd(layer(params["blocks"], i * per + j), x,
                                 cfg)
        ssm.append(sc)
    x, kv = dense.block_fwd(params["shared"], x, cos, sin, cfg)
    return x, ssm, kv


def _superblock_out(params, i: int, x, cos, sin, cfg: ModelConfig):
    return _superblock(params, i, x, cos, sin, cfg)[0]


def _rope(s: int, dev, cfg: ModelConfig):
    return rope_tables(dense._positions(s, dev), cfg.hd, cfg.rope_theta)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None) -> torch.Tensor:
    """Teacher-forcing forward -> logits (B, S, V). `prefix_embeds` is
    taken and ignored, as in the reference."""
    x = dense.embed_tokens(params, tokens, cfg)
    cos, sin = _rope(x.shape[1], x.device, cfg)
    remat = remat_applies(cfg, x, params)
    for i in range(num_apps(cfg)):
        x = (checkpoint(_superblock_out, params, i, x, cos, sin, cfg,
                        use_reentrant=False)
             if remat else _superblock_out(params, i, x, cos, sin, cfg))
    return dense._logits(params, x, cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    return cross_entropy_loss(forward(params, batch["tokens"], cfg),
                              batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> HybridCache:
    ssm = mamba2.init_cache(cfg, batch, device=device)
    kv_shape = (num_apps(cfg), batch, max_len, cfg.num_kv_heads, cfg.hd)
    dev = ssm.state.device
    return HybridCache(
        state=ssm.state, conv=ssm.conv,
        k=torch.zeros(kv_shape, dtype=cfg.cdtype, device=dev),
        v=torch.zeros(kv_shape, dtype=cfg.cdtype, device=dev),
        length=ssm.length)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None, lengths: torch.Tensor | None = None,
            prefix_embeds=None) -> tuple[torch.Tensor, HybridCache]:
    """Run the prompt, return (logits (B, S, V), the cache after it, its
    K/V of max(max_len, S) positions)."""
    x = dense.embed_tokens(params, tokens, cfg)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max(max_len or s, s), device=x.device)
    cos, sin = _rope(s, x.device, cfg)
    per = cfg.hybrid_attn_period
    for i in range(num_apps(cfg)):
        x, ssm, (k, v) = _superblock(params, i, x, cos, sin, cfg)
        for j, (st, conv) in enumerate(ssm):
            cache.state[i * per + j] = st
            cache.conv[i * per + j] = conv
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    dense.set_lengths(cache.length, lengths, s)
    return dense._logits(params, x, cfg), cache


def decode_step(params: Params, cache: HybridCache, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, HybridCache]:
    """One decode step. tokens (B, 1) -> logits (B, 1, V), the cache with
    the token taken in (in place)."""
    x = dense.embed_tokens(params, tokens, cfg)
    length = cache.length + 1
    cos, sin = rope_tables((length - 1)[:, None], cfg.hd, cfg.rope_theta)
    slots = dense._step_slots(length, cache.k.shape[2])
    per = cfg.hybrid_attn_period
    for i in range(num_apps(cfg)):
        for li in range(i * per, (i + 1) * per):
            x, st, conv = mamba2.block_decode(
                layer(params["blocks"], li), x, cache.state[li],
                cache.conv[li], cfg)
            cache.state[li] = st
            cache.conv[li] = conv
        x, _, _ = dense._block_decode(params["shared"], x, cache.k[i],
                                      cache.v[i], length, slots, cos, sin,
                                      cfg)
    return dense._logits(params, x, cfg), HybridCache(
        state=cache.state, conv=cache.conv, k=cache.k, v=cache.v,
        length=length)
