"""Mixture-of-Experts transformer (llama4-style: top-1 routed + shared
expert): port of `repro.models.moe`.

Deterministic-shape capacity-based dispatch, as in the reference: tokens
pick their top-1 expert by a softmax router (f32); each expert has
capacity ceil(tokens/E * capacity_factor); overflow tokens fall back to
the residual (and the shared expert). Dispatch and combine are a scatter
(`index_put` with accumulation) and a gather with a sacrificial overflow
slot, so no (tokens, E, capacity) one-hot tensor is materialized. Kept
tokens own distinct (expert, slot) pairs, so the kept rows of the expert
buffer hold their token's bits exactly, whatever order the adds run in;
only the overflow slot takes many adds, and it is cut off. The expert
FFN is three batched products over the (E, capacity, D) buffer, each
casting its expert bank to the compute dtype per call, as the reference
does.

`moe_layer_period = k` makes every k-th layer MoE (maverick: 2; scout:
1); a superblock is (k-1) dense layers + 1 MoE layer. Attention params
are stacked for ALL layers (`blocks`); dense-FFN params exist only for
the dense sub-layers (`dense_ffn`, (SB, k-1, ...), or {} when k is 1);
the expert banks are stacked per superblock (`moe`: router (SB, D, E),
w_gate/w_up (SB, E, D, F), w_down (SB, E, F, D), and `sh_*` for the
shared expert). The dense sub-layers run the port's `dense.block_fwd` /
`dense._block_decode`; the KV cache's layer order is superblock-major,
as the reference's. Under `cfg.remat`, while autograd records, each
superblock runs through `torch.utils.checkpoint`.

Capacity under a mesh (ROADMAP C25): with `ns` batch shards in the
active mesh (`set_mesh`) and a global microbatch of `nt` tokens, `ns`
dividing `nt`, the reference enforces capacity per contiguous chunk of
nt/ns tokens (its shard-aligned dispatch). Under the sharded train step
a rank runs only its rows of the microbatch, so the chunk size comes
from the global microbatch (`batch_block`), not from the rows the call
is given: a rank's rows are whole chunks, one or several. The expert
buffer's "mp" pin returns its input (expert parallelism is not realized,
as C24 says of every pin).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import dense
from repro_torch.models.common import (ModelConfig, Params, active_batch_block,
                                       active_mesh, apply_rope,
                                       check_generator, constrain,
                                       cross_entropy_loss, embed_init, layer,
                                       remat_applies, residual_pattern,
                                       rmsnorm, rope_tables, stacked_init,
                                       swiglu)

_FFN_KEYS = ("w_gate", "w_up", "w_down")


def _capacity(num_tokens: int, cfg: ModelConfig) -> int:
    return max(1, math.ceil(num_tokens / cfg.num_experts * cfg.capacity_factor))


def _init_moe(cfg: ModelConfig, gen, lead: tuple[int, ...]) -> Params:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    dt = cfg.pdtype
    p = {
        "router": stacked_init(gen, lead, (d, e), dt, scale=d ** -0.5),
        "w_gate": stacked_init(gen, (*lead, e), (d, f), dt),
        "w_up": stacked_init(gen, (*lead, e), (d, f), dt),
        "w_down": stacked_init(gen, (*lead, e), (f, d), dt,
                               scale=f ** -0.5),
    }
    if cfg.shared_expert:
        p["sh_gate"] = stacked_init(gen, lead, (d, f), dt)
        p["sh_up"] = stacked_init(gen, lead, (d, f), dt)
        p["sh_down"] = stacked_init(gen, lead, (f, d), dt,
                                    scale=f ** -0.5)
    return p


def init_moe_ffn(cfg: ModelConfig, gen: torch.Generator, *,
                 device=None) -> Params:
    """One MoE FFN's parameters drawn from `gen` on `device`."""
    check_generator(gen, resolve_device(device))
    return _init_moe(cfg, gen, ())


def _dp_shards() -> int:
    """Number of batch-axis shards in the active mesh (1 outside
    set_mesh)."""
    mesh = active_mesh()
    if mesh is None:
        return 1
    n = 1
    for a in mesh.axis_names:
        if a != "model":
            n *= mesh.shape[a]
    return n


def dispatch_chunk(num_tokens: int, seq: int) -> int:
    """Tokens per capacity chunk of a call given `num_tokens` tokens in
    rows of `seq`: the global microbatch's tokens over the mesh's batch
    shards where they divide (the reference's shard-aligned dispatch),
    else the whole microbatch, which must then be this call's."""
    ns = _dp_shards()
    blk = active_batch_block()
    total, offset = ((num_tokens, 0) if blk is None
                     else (blk.rows * seq, blk.start * seq))
    if ns > 1 and total % ns == 0:
        chunk = total // ns
        if offset % chunk or num_tokens % chunk:
            raise ValueError(f"tokens [{offset}, {offset + num_tokens}) of "
                             f"a {total}-token microbatch are not whole "
                             f"chunks of {chunk} ({ns} batch shards)")
        return chunk
    if (total, offset) != (num_tokens, 0):
        raise ValueError(f"a {total}-token microbatch that does not split "
                         f"into {ns} batch shards must be run whole, not "
                         f"tokens [{offset}, {offset + num_tokens})")
    return num_tokens


def route(p: Params, xt: torch.Tensor, cfg: ModelConfig, chunk: int):
    """Top-1 routing of tokens xt (nt, D) with capacity per chunk of
    `chunk` tokens. Returns (eidx, gate, keep, slot, cap): each token's
    expert and router weight, whether it is kept, its row in the (E, cap
    + 1) buffer (cap for a dropped token) and the buffer's capacity."""
    nt = xt.shape[0]
    e = cfg.num_experts
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    eidx = torch.argmax(probs, dim=-1)                  # first maximum
    gate = torch.amax(probs, dim=-1)
    nch = nt // chunk
    cap_l = _capacity(chunk, cfg)
    oh = F.one_hot(eidx, e).reshape(nch, chunk, e)
    pos_in_e = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1).reshape(nt)
    keep = pos_in_e < cap_l
    blk = torch.arange(nch, device=xt.device).repeat_interleave(chunk)
    cap = nch * cap_l
    slot = torch.where(keep, blk * cap_l + pos_in_e,
                       torch.full_like(pos_in_e, cap))
    return eidx, gate, keep, slot, cap


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). Top-1 routing with capacity dropping."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    eidx, gate, keep, slot, cap = route(p, xt, cfg,
                                        dispatch_chunk(b * s, s))
    # scatter into (E, cap+1, D); slot `cap` swallows overflow
    buf = xt.new_zeros((cfg.num_experts, cap + 1, d))
    buf = buf.index_put((eidx, slot), xt, accumulate=True)
    buf = constrain(buf[:, :cap], "mp", None, None)
    dt = x.dtype
    g = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    y = torch.bmm(F.silu(g) * u, p["w_down"].to(dt))   # (E, cap, D)
    y = constrain(y, "mp", None, None)
    out = y[eidx, torch.clamp(slot, max=cap - 1)]       # (nt, D)
    out = out * (gate * keep).to(dt)[:, None]
    if cfg.shared_expert:
        out = out + swiglu(xt, p["sh_gate"], p["sh_up"], p["sh_down"])
    return out.reshape(b, s, d)


def aux_load_balance_loss(p: Params, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction * prob per
    expert)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d).to(torch.float32)
    probs = torch.softmax(xt @ p["router"].to(torch.float32), dim=-1)
    eidx = torch.argmax(probs, dim=-1)
    frac = torch.mean(F.one_hot(eidx, cfg.num_experts).to(torch.float32),
                      dim=0)
    return cfg.num_experts * torch.sum(frac * torch.mean(probs, dim=0))


# ---------------------------------------------------------------------------
# Full model: superblock = (period-1) dense layers + 1 MoE layer
# ---------------------------------------------------------------------------

def _num_superblocks(cfg: ModelConfig) -> int:
    if cfg.num_layers % cfg.moe_layer_period:
        raise ValueError(f"{cfg.num_layers} layers do not split into "
                         f"superblocks of {cfg.moe_layer_period}")
    return cfg.num_layers // cfg.moe_layer_period


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Params:
    """Random parameters drawn from `gen` on `device` (the CUDA device
    unless the caller asks for another; `gen` must be on it), with the
    reference's keys and shapes."""
    check_generator(gen, resolve_device(device))
    sb, period = _num_superblocks(cfg), cfg.moe_layer_period
    l, d, h, kh, hd, f, v = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                             cfg.num_kv_heads, cfg.hd, cfg.d_ff,
                             cfg.vocab_size)
    dt = cfg.pdtype

    def const(shape, fill):
        return torch.full(shape, fill, dtype=dt, device=gen.device)
    blocks = {
        "ln1": const((l, d), 1.0),
        "wq": stacked_init(gen, (l,), (d, h * hd), dt),
        "wk": stacked_init(gen, (l,), (d, kh * hd), dt),
        "wv": stacked_init(gen, (l,), (d, kh * hd), dt),
        "wo": stacked_init(gen, (l,), (h * hd, d), dt,
                           scale=(h * hd) ** -0.5),
        "ln2": const((l, d), 1.0),
    }
    if cfg.qkv_bias:
        blocks["bq"] = const((l, h * hd), 0.0)
        blocks["bk"] = const((l, kh * hd), 0.0)
        blocks["bv"] = const((l, kh * hd), 0.0)
    dense_ffn = {}
    if period > 1:
        lead = (sb, period - 1)
        dense_ffn = {"w_gate": stacked_init(gen, lead, (d, f), dt),
                     "w_up": stacked_init(gen, lead, (d, f), dt),
                     "w_down": stacked_init(gen, lead, (f, d), dt,
                                     scale=f ** -0.5)}
    params = {"embed": embed_init(gen, (v, d), dt), "blocks": blocks,
              "dense_ffn": dense_ffn, "moe": _init_moe(cfg, gen, (sb,)),
              "final_norm": const((d,), 1.0)}
    if not cfg.tie_embeddings:
        params["lm_head"] = stacked_init(gen, (), (d, v), dt)
    return params


def _group_params(params, cfg: ModelConfig):
    sb = _num_superblocks(cfg)
    period = cfg.moe_layer_period
    blocks = {k: t.reshape(sb, period, *t.shape[1:])
              for k, t in params["blocks"].items()}
    return blocks, params["dense_ffn"], params["moe"], sb, period


def _sublayer(bp: dict, fp: dict, j: int) -> dict:
    """Dense sub-layer j of a superblock: its attention and FFN params."""
    sub = layer(bp, j)
    sub.update(layer(fp, j))
    return sub


def _moe_attn_ffn(bp, mp, x, cos, sin, cfg: ModelConfig):
    """Attention + MoE FFN. bp has attention params only."""
    hn = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = dense._qkv(bp, hn, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attn.chunked_causal_attention(q, k, v, cfg.attn_chunk)
    x = constrain(x + o.reshape(*o.shape[:2], -1) @ bp["wo"].to(x.dtype),
                  *residual_pattern(cfg))
    hn = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    x = constrain(x + moe_ffn(mp, hn, cfg), *residual_pattern(cfg))
    return x, (k, v)


def _superblock(bp, fp, mp, x, cos, sin, cfg: ModelConfig):
    """(period-1) dense layers then the MoE layer. Returns (x, [(k, v)]
    per layer)."""
    kvs = []
    for j in range(cfg.moe_layer_period - 1):
        x, kv = dense.block_fwd(_sublayer(bp, fp, j), x, cos, sin, cfg)
        kvs.append(kv)
    x, kv = _moe_attn_ffn(layer(bp, cfg.moe_layer_period - 1), mp, x, cos,
                          sin, cfg)
    kvs.append(kv)
    return x, kvs


def _superblock_out(bp, fp, mp, x, cos, sin, cfg: ModelConfig):
    return _superblock(bp, fp, mp, x, cos, sin, cfg)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forcing forward -> logits (B, S(+P), V)."""
    x = dense.embed_tokens(params, tokens, cfg, prefix_embeds)
    cos, sin = rope_tables(dense._positions(x.shape[1], x.device), cfg.hd,
                           cfg.rope_theta)
    blocks, dense_ffn, moe_p, sb, _ = _group_params(params, cfg)
    remat = remat_applies(cfg, x, params)
    for i in range(sb):
        args = (layer(blocks, i), layer(dense_ffn, i), layer(moe_p, i))
        if remat:
            x = checkpoint(_superblock_out, *args, x, cos, sin, cfg,
                           use_reentrant=False)
        else:
            x = _superblock_out(*args, x, cos, sin, cfg)
    return dense._logits(params, x, cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token CE of batch["tokens"] against batch["labels"];
    prefix positions (batch["prefix_embeds"]) are labelled -1, as in
    `dense.loss_fn`."""
    prefix = batch.get("prefix_embeds")
    logits = forward(params, batch["tokens"], cfg, prefix)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if prefix is not None:
        pad = torch.full((labels.shape[0], prefix.shape[1]), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return cross_entropy_loss(logits, labels)


init_cache = dense.init_cache


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None, lengths: torch.Tensor | None = None,
            prefix_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dense.KVCache]:
    """Run the prompt, return (logits (B, S, V), primed KV cache of
    `max_len` positions, layers superblock-major)."""
    x = dense.embed_tokens(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max_len or s, device=x.device)
    cos, sin = rope_tables(dense._positions(s, x.device), cfg.hd,
                           cfg.rope_theta)
    blocks, dense_ffn, moe_p, sb, period = _group_params(params, cfg)
    for i in range(sb):
        x, kvs = _superblock(layer(blocks, i), layer(dense_ffn, i),
                             layer(moe_p, i), x, cos, sin, cfg)
        for j, (k, v) in enumerate(kvs):
            cache.k[i * period + j, :, :s] = k
            cache.v[i * period + j, :, :s] = v
    dense.set_lengths(cache.length, lengths, s)
    return dense._logits(params, x, cfg), cache


def _moe_attn_ffn_decode(bp, mp, x, kc, vc, length, slots, cos, sin,
                         cfg: ModelConfig):
    """Single-token attention + MoE FFN; writes the token's K and V into
    kc/vc in place."""
    hn = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = dense._qkv(bp, hn, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows, idx = slots
    kc[rows, idx] = k[:, 0]
    vc[rows, idx] = v[:, 0]
    o = attn.decode_attention(q, kc, vc, length)
    x = x + o.reshape(x.shape[0], 1, -1) @ bp["wo"].to(x.dtype)
    hn = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + moe_ffn(mp, hn, cfg)


def decode_step(params: Params, cache: dense.KVCache, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dense.KVCache]:
    """One decode step. tokens (B, 1) -> logits (B, 1, V), the cache with
    the token written (in place, as `dense.decode_step`)."""
    x = dense.embed_tokens(params, tokens, cfg)
    length = cache.length + 1
    cos, sin = rope_tables((length - 1)[:, None], cfg.hd, cfg.rope_theta)
    slots = dense._step_slots(length, cache.k.shape[2])
    blocks, dense_ffn, moe_p, sb, period = _group_params(params, cfg)
    for i in range(sb):
        bp, fp = layer(blocks, i), layer(dense_ffn, i)
        for j in range(period - 1):
            li = i * period + j
            x, _, _ = dense._block_decode(_sublayer(bp, fp, j), x,
                                          cache.k[li], cache.v[li], length,
                                          slots, cos, sin, cfg)
        li = i * period + period - 1
        x = _moe_attn_ffn_decode(layer(bp, period - 1), layer(moe_p, i), x,
                                 cache.k[li], cache.v[li], length, slots,
                                 cos, sin, cfg)
    return dense._logits(params, x, cfg), dense.KVCache(k=cache.k, v=cache.v,
                                                        length=length)
