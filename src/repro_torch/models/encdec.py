"""Encoder-decoder transformer (the seamless-m4t-medium backbone): port of
`repro.models.encdec`.

The speech frontend is a STUB, as in the reference: the encoder takes
precomputed frame embeddings (B, S_src, d_model). Encoder: bidirectional
GQA blocks with RoPE. Decoder: causal self-attention with RoPE, then
cross-attention over the encoder's output (no RoPE on the cross Q/K),
then the SwiGLU FFN. Layer parameters are stacked on a leading axis
(`enc_blocks`, `dec_blocks`), as in the reference; the layers run one
after another, and every product casts its f32 weight to the compute
dtype per call.

At serving time the encoder runs once, in `prefill`; each decoder
layer's cross K/V over the encoder's output are cached (decode never
changes them) beside the self K/V, which grow by one position a step.
`decode_step` writes the new token's self K/V into the cache it is
given, in place, and returns a cache over the same tensors (ROADMAP
C14, C27); a write past the cache's length raises. `prefill` takes
`lengths` for the cache's `length` only, as in the reference.

Under `cfg.remat`, while autograd records, each encoder and decoder
block runs through `torch.utils.checkpoint`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import dense
from repro_torch.models.common import (ModelConfig, Params, apply_rope,
                                       check_generator, constrain,
                                       cross_entropy_loss, embed_init, layer,
                                       remat_applies, rmsnorm, rope_tables,
                                       stacked_init)


@dataclasses.dataclass
class EncDecCache:
    self_k: torch.Tensor    # (Ld, B, T, KH, hd)
    self_v: torch.Tensor
    cross_k: torch.Tensor   # (Ld, B, S_src, KH, hd)
    cross_v: torch.Tensor
    length: torch.Tensor    # (B,) int32: decoder positions filled


def _attn(cfg: ModelConfig, gen: torch.Generator, n: int,
          prefix: str = "") -> Params:
    """`n` attention projections (`prefix` + wq, wk, wv, wo), stacked on
    axis 0."""
    d, h, kh, hd, dt = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.hd, cfg.pdtype)
    return {prefix + "wq": stacked_init(gen, (n,), (d, h * hd), dt),
            prefix + "wk": stacked_init(gen, (n,), (d, kh * hd), dt),
            prefix + "wv": stacked_init(gen, (n,), (d, kh * hd), dt),
            prefix + "wo": stacked_init(gen, (n,), (h * hd, d), dt,
                                        scale=(h * hd) ** -0.5)}


def _norm(cfg: ModelConfig, gen: torch.Generator, *lead: int):
    return torch.ones((*lead, cfg.d_model), dtype=cfg.pdtype,
                      device=gen.device)


def _blocks(cfg: ModelConfig, gen: torch.Generator, n: int) -> Params:
    """`n` pre-norm blocks (attention and the SwiGLU FFN), stacked on
    axis 0."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    return {"ln1": _norm(cfg, gen, n), **_attn(cfg, gen, n),
            "ln2": _norm(cfg, gen, n),
            "w_gate": stacked_init(gen, (n,), (d, f), dt),
            "w_up": stacked_init(gen, (n,), (d, f), dt),
            "w_down": stacked_init(gen, (n,), (f, d), dt, scale=f ** -0.5)}


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Params:
    """Random parameters drawn from `gen` on `device` (the CUDA device
    unless the caller asks for another; `gen` must be on it), one stacked
    leaf at a time: the reference's keys and shapes (`encoder_layers`
    encoder blocks, 0 meaning `num_layers`)."""
    check_generator(gen, resolve_device(device))
    l, d, v, dt = cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.pdtype
    return {
        "enc_blocks": _blocks(cfg, gen, cfg.encoder_layers or l),
        "dec_blocks": {**_blocks(cfg, gen, l), "lnx": _norm(cfg, gen, l),
                       **_attn(cfg, gen, l, "x")},
        "embed": embed_init(gen, (v, d), dt),
        "enc_norm": _norm(cfg, gen),
        "final_norm": _norm(cfg, gen),
        "lm_head": stacked_init(gen, (), (d, v), dt),
    }


def _proj_kv(p, x, cfg: ModelConfig, prefix: str):
    b, s, _ = x.shape
    kh, hd = cfg.num_kv_heads, cfg.hd
    k = x @ p[prefix + "wk"].to(x.dtype)
    v = x @ p[prefix + "wv"].to(x.dtype)
    return (constrain(k.reshape(b, s, kh, hd), "dp", None, "mp", None),
            constrain(v.reshape(b, s, kh, hd), "dp", None, "mp", None))


def _proj_q(p, x, cfg: ModelConfig, prefix: str):
    b, s, _ = x.shape
    q = (x @ p[prefix + "wq"].to(x.dtype)).reshape(b, s, cfg.num_heads,
                                                    cfg.hd)
    return constrain(q, "dp", None, "mp", None)


def _out(p, x, o, key: str) -> torch.Tensor:
    """x plus the heads' output `o` (B, S, H, hd) through p[key]."""
    return x + o.reshape(*o.shape[:2], -1) @ p[key].to(x.dtype)


def _rope(s: int, dev, cfg: ModelConfig):
    return rope_tables(dense._positions(s, dev), cfg.hd, cfg.rope_theta)


def _enc_block(p, h, cos, sin, cfg: ModelConfig) -> torch.Tensor:
    hn = rmsnorm(h, p["ln1"], cfg.norm_eps)
    q = _proj_q(p, hn, cfg, "")
    k, v = _proj_kv(p, hn, cfg, "")
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = attn.chunked_attention(q, k, v, cfg.attn_chunk, causal=False)
    return dense._mlp_residual(p, _out(p, h, o, "wo"), cfg)


def encode(params: Params, frames, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, S_src, D) stub embeddings -> encoder states (B, S_src, D)
    in the compute dtype."""
    dev = params["embed"].device
    x = constrain(torch.as_tensor(frames, device=dev).to(cfg.cdtype),
                  "dp", None, None)
    cos, sin = _rope(x.shape[1], dev, cfg)
    remat = remat_applies(cfg, x, params)
    for i in range(cfg.encoder_layers or cfg.num_layers):
        p = layer(params["enc_blocks"], i)
        x = (checkpoint(_enc_block, p, x, cos, sin, cfg, use_reentrant=False)
             if remat else _enc_block(p, x, cos, sin, cfg))
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block_fwd(p, x, enc, cos, sin, cfg: ModelConfig):
    """Training/prefill decoder block. Returns (x, (k, v, xk, xv))."""
    hn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = _proj_q(p, hn, cfg, "")
    k, v = _proj_kv(p, hn, cfg, "")
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = attn.chunked_attention(q, k, v, cfg.attn_chunk, causal=True)
    x = _out(p, x, o, "wo")
    hn = rmsnorm(x, p["lnx"], cfg.norm_eps)
    xq = _proj_q(p, hn, cfg, "x")
    xk, xv = _proj_kv(p, enc, cfg, "x")
    o = attn.chunked_attention(xq, xk, xv, cfg.attn_chunk, causal=False)
    x = _out(p, x, o, "xwo")
    return dense._mlp_residual(p, x, cfg), (k, v, xk, xv)


def _dec_block_out(p, x, enc, cos, sin, cfg: ModelConfig) -> torch.Tensor:
    return _dec_block_fwd(p, x, enc, cos, sin, cfg)[0]


def forward(params: Params, frames, tokens, cfg: ModelConfig
            ) -> torch.Tensor:
    """Teacher-forcing decoder logits (B, S_tgt, V)."""
    enc = encode(params, frames, cfg)
    x = dense.embed_tokens(params, tokens, cfg)
    cos, sin = _rope(x.shape[1], x.device, cfg)
    remat = remat_applies(cfg, x, params)
    for i in range(cfg.num_layers):
        p = layer(params["dec_blocks"], i)
        x = (checkpoint(_dec_block_out, p, x, enc, cos, sin, cfg,
                        use_reentrant=False)
             if remat else _dec_block_out(p, x, enc, cos, sin, cfg))
    return dense._logits(params, x, cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token CE of the decoder's logits over batch["frames"] and
    batch["tokens"] against batch["labels"]."""
    return cross_entropy_loss(
        forward(params, batch["frames"], batch["tokens"], cfg),
        batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int, *,
               device=None) -> EncDecCache:
    dev = resolve_device(device)
    l, kh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd

    def zeros(t):
        return torch.zeros((l, batch, t, kh, hd), dtype=cfg.cdtype,
                           device=dev)
    return EncDecCache(self_k=zeros(max_len), self_v=zeros(max_len),
                       cross_k=zeros(src_len), cross_v=zeros(src_len),
                       length=torch.zeros((batch,), dtype=torch.int32,
                                          device=dev))


def prefill(params: Params, frames, tokens, cfg: ModelConfig,
            max_len: int | None = None, lengths: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, EncDecCache]:
    """Encode the source and run the target prompt. Returns (logits (B, S,
    V), the cache: self K/V of max(max_len, S) positions, the cross K/V
    of the whole source)."""
    enc = encode(params, frames, cfg)
    x = dense.embed_tokens(params, tokens, cfg)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max(max_len or s, s), enc.shape[1],
                       device=x.device)
    cos, sin = _rope(s, x.device, cfg)
    for i in range(cfg.num_layers):
        x, (k, v, xk, xv) = _dec_block_fwd(layer(params["dec_blocks"], i),
                                           x, enc, cos, sin, cfg)
        cache.self_k[i, :, :s] = k
        cache.self_v[i, :, :s] = v
        cache.cross_k[i] = xk
        cache.cross_v[i] = xv
    dense.set_lengths(cache.length, lengths, s)
    return dense._logits(params, x, cfg), cache


def decode_step(params: Params, cache: EncDecCache, tokens,
                cfg: ModelConfig) -> tuple[torch.Tensor, EncDecCache]:
    """One decode step. tokens (B, 1) -> logits (B, 1, V), the cache with
    the token's self K/V written (in place). Cross-attention reads the
    whole source (`cross_k`'s length), not `length`."""
    x = dense.embed_tokens(params, tokens, cfg)
    b = x.shape[0]
    length = cache.length + 1
    cos, sin = rope_tables((length - 1)[:, None], cfg.hd, cfg.rope_theta)
    rows, idx = dense._step_slots(length, cache.self_k.shape[2])
    full = torch.full((b,), cache.cross_k.shape[2], dtype=torch.int32,
                      device=x.device)
    for i in range(cfg.num_layers):
        p = layer(params["dec_blocks"], i)
        hn = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = _proj_q(p, hn, cfg, "")
        k, v = _proj_kv(p, hn, cfg, "")
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        kc, vc = cache.self_k[i], cache.self_v[i]
        kc[rows, idx] = k[:, 0]
        vc[rows, idx] = v[:, 0]
        x = _out(p, x, attn.decode_attention(q, kc, vc, length), "wo")
        hn = rmsnorm(x, p["lnx"], cfg.norm_eps)
        xq = _proj_q(p, hn, cfg, "x")
        x = _out(p, x, attn.decode_attention(xq, cache.cross_k[i],
                                             cache.cross_v[i], full), "xwo")
        x = dense._mlp_residual(p, x, cfg)
    return dense._logits(params, x, cfg), dataclasses.replace(
        cache, length=length)
