"""Mamba2 (SSD, state-space duality): port of `repro.models.mamba2`.

The chunked SSD algorithm (a quadratic, attention-like form inside each
chunk and a linear state recurrence across chunks) runs training and
prefill; the O(1)-per-token recurrent form runs decode. The two are
equal up to rounding.

Per-block dataflow (mamba_ssm's layout, ngroups = 1):

    in_proj: d -> [z (d_in), xBC (d_in + 2n), dt (H)]
    causal depthwise conv (width w) + silu on xBC
    SSD over heads H = d_in / P with A = -exp(A_log) per head
    gated RMSNorm: norm(y * silu(z)); out_proj: d_in -> d

Decode state: ssm (B, H, P, N) f32 and the conv tail (B, w-1, conv_dim)
per layer. The layers run one after another over the stacked blocks;
under `cfg.remat`, while autograd records, each layer runs through
`torch.utils.checkpoint`.

Numerics follow the reference's dtype promotion: the causal conv
multiplies the compute-dtype input by the f32 `conv_w`, so the conv's
output and the SSD's inputs are f32 at bf16 compute and `y` is cast back
only before the gated norm. A block takes one chunk of the whole length
when `ssm_chunk` does not divide it (the reference's fallback, kept:
ROADMAP C26). The intra-chunk product runs in an explicit order (C·Bᵀ,
times the decay mask, times x), so its largest intermediate is one
(B, H, NC, Q, Q) f32 tensor.

`decode_step` writes each layer's new SSM state and conv tail into the
cache it is given, in place, and returns a cache over the same tensors
(the dense decode's KV cache does the same; ROADMAP C14). `prefill`
takes `lengths` for the cache only: every row's state is that of its
whole prompt, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import dense
from repro_torch.models.common import (ModelConfig, Params, check_generator,
                                       constrain, cross_entropy_loss,
                                       embed_init, layer, remat_applies,
                                       residual_pattern, rmsnorm,
                                       stacked_init)


@dataclasses.dataclass
class SSMCache:
    state: torch.Tensor    # (L, B, H, P, N) f32
    conv: torch.Tensor     # (L, B, W-1, conv_dim)
    length: torch.Tensor   # (B,) int32


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_blocks(cfg: ModelConfig, gen: torch.Generator,
                num_layers: int) -> Params:
    """`num_layers` mamba2 blocks' parameters, stacked on axis 0, drawn
    from `gen` on its device. A_log, dt_bias and D are f32 whatever
    `param_dtype` is, as in the reference."""
    d, din, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_conv_width)
    dt, dev, l = cfg.pdtype, gen.device, num_layers
    cd = conv_dim(cfg)
    conv_w = torch.empty((l, w, cd), dtype=dt, device=dev)
    for i in range(l):
        conv_w[i] = (torch.randn((w, cd), generator=gen, device=dev)
                     * (w * cd) ** -0.5).to(dt)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=dev))
    return {
        "ln": torch.ones((l, d), dtype=dt, device=dev),
        "in_proj": stacked_init(gen, (l,), (d, 2 * din + 2 * n + h), dt),
        "conv_w": conv_w,
        "conv_b": torch.zeros((l, cd), dtype=dt, device=dev),
        "A_log": a_log.expand(l, h).clone(),
        "dt_bias": torch.zeros((l, h), dtype=torch.float32, device=dev),
        "D": torch.ones((l, h), dtype=torch.float32, device=dev),
        "norm": torch.ones((l, din), dtype=dt, device=dev),
        "out_proj": stacked_init(gen, (l,), (din, d), dt, scale=din ** -0.5),
    }


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    din, n = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * n],
            zxbcdt[..., 2 * din + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence. xbc (B, L, C); w (W, C).
    The taps are summed in order i = 0 .. W-1; a compute-dtype input
    times an f32 `w` gives f32, as in the reference."""
    width, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + length] * w[i][None, None]
              for i in range(width))
    return F.silu(out + b[None, None].to(out.dtype))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T) with S[i, j] = sum a[j+1..i] for j <= i
    and -inf above the diagonal. The mask is applied before any exp, so
    neither the value nor its grad sees an inf."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, s, torch.full_like(s, -torch.inf))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None):
    """Chunked SSD scan.

    x (B, L, H, P): the inputs ALREADY multiplied by dt;
    a (B, L, H):    dt * A (a negative decay log);
    b, c (B, L, N): shared across heads (ngroups = 1).
    Returns (y (B, L, H, P), final_state (B, H, P, N)), in f32."""
    bs, l, h, p = x.shape
    n = b.shape[-1]
    if l % chunk:
        raise ValueError(f"chunk {chunk} does not divide length {l}")
    nc = l // chunk
    # heads lead: (B, H, NC, Q, P), (B, H, NC, Q)
    xh = x.to(torch.float32).reshape(bs, nc, chunk, h, p).permute(
        0, 3, 1, 2, 4)
    a = a.to(torch.float32).reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)
    b = b.to(torch.float32).reshape(bs, 1, nc, chunk, n)
    c = c.to(torch.float32).reshape(bs, 1, nc, chunk, n)

    a_cs = torch.cumsum(a, dim=-1)                          # (B, H, NC, Q)
    ldec = torch.exp(_segsum(a))                            # (B, H, NC, Q, Q)
    # intra-chunk (quadratic) term: ((C Bᵀ) * L) x
    y_diag = ((c @ b.transpose(-1, -2)) * ldec) @ xh        # (B, H, NC, Q, P)
    # each chunk's input -> its end-of-chunk state
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)         # (B, H, NC, Q)
    states = (xh * decay_states[..., None]).transpose(-1, -2) @ b
    # inter-chunk recurrence; emits the state BEFORE each chunk
    chunk_decay = torch.exp(a_cs[..., -1])                  # (B, H, NC)
    prev = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
            if initial_state is None else initial_state.to(torch.float32))
    before = []
    for i in range(nc):
        before.append(prev)
        prev = states[:, :, i] + chunk_decay[:, :, i, None, None] * prev
    prev_states = torch.stack(before, dim=2)                # (B, H, NC, P, N)
    # the carried-in state's contribution to each position
    state_decay = torch.exp(a_cs)                           # (B, H, NC, Q)
    y_off = (c @ prev_states.transpose(-1, -2)) * state_decay[..., None]
    y = (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(bs, l, h, p)
    return y, prev


def block_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig,
              initial_state: torch.Tensor | None = None,
              conv_init: torch.Tensor | None = None):
    """Full-sequence mamba2 block. Returns (x_out, (final_state,
    conv_tail))."""
    h_heads, pdim, n, w = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                           cfg.ssm_conv_width)
    res = x
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    zxbcdt = constrain(xn @ p["in_proj"].to(xn.dtype), "dp", None, None)
    z, xbc, dt_raw = _split_in_proj(zxbcdt, cfg)
    if conv_init is not None:
        ext = torch.cat([conv_init.to(xbc.dtype), xbc], dim=1)
        xbc_c = _causal_conv(ext, p["conv_w"], p["conv_b"])[:, w - 1:]
    else:
        xbc_c = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc_c[..., :cfg.d_inner]
    b_in = xbc_c[..., cfg.d_inner:cfg.d_inner + n]
    c_in = xbc_c[..., cfg.d_inner + n:]
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])                              # (H,)
    bs, l = xs.shape[0], xs.shape[1]
    xh = xs.reshape(bs, l, h_heads, pdim).to(torch.float32)
    chunk = min(cfg.ssm_chunk, l)
    if l % chunk:
        chunk = l                                           # one chunk
    y, final = ssd_chunked(xh * dt[..., None], dt * a[None, None], b_in,
                           c_in, chunk, initial_state)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(bs, l, -1).to(x.dtype)
    y = constrain(rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps),
                  "dp", None, "mp")
    out = y @ p["out_proj"].to(y.dtype)
    conv_tail = (xbc[:, l - (w - 1):] if l >= w - 1
                 else F.pad(xbc, (0, 0, w - 1 - l, 0)))
    return constrain(res + out, *residual_pattern(cfg)), (final, conv_tail)


def block_decode(p: Params, x: torch.Tensor, state: torch.Tensor,
                 conv_cache: torch.Tensor, cfg: ModelConfig):
    """One-token recurrent step. x (B, 1, D); state (B, H, P, N);
    conv_cache (B, W-1, conv_dim). Returns (x_out, new_state, new_conv),
    new tensors (the caller writes them into its cache)."""
    h_heads, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    res = x
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    zxbcdt = xn @ p["in_proj"].to(xn.dtype)
    z, xbc, dt_raw = _split_in_proj(zxbcdt, cfg)
    buf = torch.cat([conv_cache.to(xbc.dtype), xbc], dim=1)   # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", buf.to(torch.float32),
                            p["conv_w"].to(torch.float32))
    xbc_c = F.silu(conv_out + p["conv_b"].to(torch.float32))[:, None]
    new_conv = buf[:, 1:]
    xs = xbc_c[..., :cfg.d_inner]
    b_in = xbc_c[:, 0, cfg.d_inner:cfg.d_inner + n]          # (B, N)
    c_in = xbc_c[:, 0, cfg.d_inner + n:]
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])[:, 0]  # (B, H)
    a = -torch.exp(p["A_log"])
    xh = xs.reshape(xs.shape[0], h_heads, pdim).to(torch.float32)
    da = torch.exp(dt * a[None])                              # (B, H)
    state = state * da[..., None, None] + (
        (dt[..., None] * xh)[..., None] * b_in[:, None, None, :])
    y = (state @ c_in[:, None, :, None])[..., 0] + p["D"][None, :, None] * xh
    y = y.reshape(y.shape[0], 1, -1).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(y.dtype)
    return res + out, state, new_conv


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Params:
    """Random parameters drawn from `gen` on `device` (the CUDA device
    unless the caller asks for another; `gen` must be on it), with the
    reference's keys and shapes."""
    check_generator(gen, resolve_device(device))
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.pdtype
    blocks = init_blocks(cfg, gen, cfg.num_layers)
    params = {"embed": embed_init(gen, (v, d), dt), "blocks": blocks,
              "final_norm": torch.ones((d,), dtype=dt, device=gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = stacked_init(gen, (), (d, v), dt)
    return params


def _layer_out(p, x, cfg: ModelConfig) -> torch.Tensor:
    return block_fwd(p, x, cfg)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None) -> torch.Tensor:
    """Teacher-forcing forward -> logits (B, S, V). `prefix_embeds` is
    taken and ignored, as in the reference."""
    x = dense.embed_tokens(params, tokens, cfg)
    remat = remat_applies(cfg, x, params)
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        x = (checkpoint(_layer_out, p, x, cfg, use_reentrant=False)
             if remat else _layer_out(p, x, cfg))
    return dense._logits(params, x, cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    return cross_entropy_loss(forward(params, batch["tokens"], cfg),
                              batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, *,
               device=None) -> SSMCache:
    """A zero cache; its size does not depend on `max_len`."""
    dev = resolve_device(device)
    l, h, pd, n, w = (cfg.num_layers, cfg.ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state, cfg.ssm_conv_width)
    return SSMCache(
        state=torch.zeros((l, batch, h, pd, n), dtype=torch.float32,
                          device=dev),
        conv=torch.zeros((l, batch, w - 1, conv_dim(cfg)), dtype=cfg.cdtype,
                         device=dev),
        length=torch.zeros((batch,), dtype=torch.int32, device=dev))


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None, lengths: torch.Tensor | None = None,
            prefix_embeds=None) -> tuple[torch.Tensor, SSMCache]:
    """Run the prompt, return (logits (B, S, V), the cache after it)."""
    x = dense.embed_tokens(params, tokens, cfg)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, device=x.device)
    for i in range(cfg.num_layers):
        x, (st, conv) = block_fwd(layer(params["blocks"], i), x, cfg)
        cache.state[i] = st
        cache.conv[i] = conv
    dense.set_lengths(cache.length, lengths, s)
    return dense._logits(params, x, cfg), cache


def decode_step(params: Params, cache: SSMCache, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, SSMCache]:
    """One decode step. tokens (B, 1) -> logits (B, 1, V), the cache with
    every layer's state and conv tail advanced (in place)."""
    x = dense.embed_tokens(params, tokens, cfg)
    for i in range(cfg.num_layers):
        x, st, conv = block_decode(layer(params["blocks"], i), x,
                                   cache.state[i], cache.conv[i], cfg)
        cache.state[i] = st
        cache.conv[i] = conv
    return dense._logits(params, x, cfg), SSMCache(
        state=cache.state, conv=cache.conv, length=cache.length + 1)
