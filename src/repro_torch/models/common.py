"""Shared model-definition substrate: config, layers, init (port of
`repro.models.common`).

Parameters are nested dicts of tensors, as in the reference; repeated
transformer blocks keep theirs STACKED along a leading layer axis, so a
parameter tree carried across from the reference (`convert.dense_params`,
`convert.embedder_params`) has the same keys and shapes. Layers run on the
device of their inputs.

The reference's GSPMD hints (`constrain`, `constrain_kv`,
`residual_pattern`) do nothing on one device and have no counterpart
here (ROADMAP A2's training half).

`ModelConfig` holds the fields that the dense model, the embedder, the
registry and training read, with the reference's defaults. Of the
training knobs, `remat` checkpoints each dense block while autograd
records and `optimizer` names the launcher's optimizer; `scan_layers`
and `seq_shard` are kept for parity and do nothing here: the layers
always run one after another, and one device needs no sequence-sharding
hint (ROADMAP C22). The MoE, SSM, hybrid, enc-dec and frontend fields
come with those families (ROADMAP A3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal

import torch

Params = Any  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False         # qwen2-style QKV bias
    # --- numerics / misc ---
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 2048         # flash-attention block size
    remat: bool = True             # checkpoint each block under autograd
    scan_layers: bool = True       # no-op: the layers run in a loop
    seq_shard: bool = False        # no-op: one device, no sharding hint
    optimizer: Literal["adamw", "adafactor"] = "adamw"
    tie_embeddings: bool = False
    # embedder head (MiniLM-style sentence encoder)
    pooled_dim: int = 0            # >0: mean-pool + project to this dim

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Initializers (on the generator's device; the draws are torch's, not JAX's)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype: torch.dtype, *,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype: torch.dtype
               ) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02
            ).to(dtype)


def check_generator(gen: torch.Generator, device: torch.device) -> None:
    """Parameters are drawn on the generator's device, which must be the
    one the caller asked for."""
    if gen.device.type != device.type:
        raise ValueError(f"the generator is on {gen.device}, the parameters "
                         f"are asked for on {device}")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalized in f32, cast back to x's dtype, then scaled by gamma in
    that dtype (the reference's order)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (torch.nn.functional.silu(g) * u) @ w_down.to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos/sin tables (..., S, head_dim//2) f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, half) or (S, half). Rotate-half
    RoPE (the two halves of the head, not interleaved pairs), in f32 with
    a cast back at the end."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean CE over positions with label >= 0 (negative = padding).

    logits (..., V) any float dtype (upcast to f32); labels (...) int."""
    logits = logits.to(torch.float32)
    labels = torch.as_tensor(labels, device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).to(torch.int64)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)


def param_count(params: Params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(params.numel())


def layer(blocks: dict, i: int) -> dict:
    """Layer i's parameters: a view of every stacked block tensor."""
    return {name: t[i] for name, t in blocks.items()}
