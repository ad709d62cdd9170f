"""Shared model-definition substrate: config, layers, init (port of
`repro.models.common`).

Parameters are nested dicts of tensors, as in the reference; repeated
transformer blocks keep theirs STACKED along a leading layer axis, so a
parameter tree carried across from the reference (`convert.dense_params`,
`convert.embedder_params`) has the same keys and shapes. Layers run on the
device of their inputs.

The reference's GSPMD hints (`constrain`, `constrain_kv`,
`residual_pattern`) pin an activation's sharding inside `jit`. Their spec
resolution is ported as pure functions (`constrain_spec`,
`constrain_kv_spec`: the PartitionSpec the reference would pin for a
shape, a pattern and a mesh), and `set_mesh` is the active-mesh context.
The hints themselves return their input, on one device as in the
reference and under a sharded mesh as well: the port does not split
compute over the model axis. Under the sharded train step each rank runs
its own batch block, so the "dp" part of every pin holds by
construction; the "mp" part is not realized (ROADMAP C24).

`ModelConfig` holds the fields that the dense, vlm, MoE, SSM, hybrid and
enc-dec models, the embedder, the registry and training read, with the
reference's defaults: the MoE fields (`num_experts`, `moe_top_k`,
`moe_layer_period`, `shared_expert`, `capacity_factor`), the SSM fields
(`ssm_state`, `ssm_expand`, `ssm_head_dim`, `ssm_conv_width`,
`ssm_chunk`, with the properties `d_inner` and `ssm_heads`), the
hybrid's `hybrid_attn_period`, the enc-dec's `encoder_layers` and the
frontends' (`num_prefix_embeds`, `frontend_dim`). Of the training knobs,
`remat` checkpoints each dense block (each MoE, SSM or hybrid
superblock, each mamba2 layer, each encoder and decoder block of the
enc-dec) while autograd records and `optimizer` names the
launcher's optimizer; `scan_layers` and `seq_shard` are kept for parity:
the layers always run one after another (ROADMAP C22), and `seq_shard`
only changes the spec `residual_pattern` names.

`batch_block` tells the layers which rows of the global microbatch a
rank runs (the sharded train step sets it): the MoE dispatch enforces
its capacity per batch shard of the global microbatch, as the reference
does under a mesh (ROADMAP C25).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Literal

import torch

from repro_torch import _tree

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
    # --- MoE ---
    num_experts: int = 0
    moe_top_k: int = 1
    moe_layer_period: int = 1      # 1 = every layer MoE; 2 = interleaved
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # --- hybrid (Zamba2) ---
    hybrid_attn_period: int = 0    # shared attn block after every k SSM layers
    # --- enc-dec ---
    encoder_layers: int = 0        # 0 -> num_layers (the decoder's depth)
    # --- frontends (VLM / audio): stubbed embeddings prepended/encoded ---
    num_prefix_embeds: int = 0     # VLM: image patch embeddings per sample
    frontend_dim: int = 0          # embedding dim delivered by the stub
    # --- numerics / misc ---
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 2048         # flash-attention block size
    remat: bool = True             # checkpoint each block under autograd
    scan_layers: bool = True       # no-op: the layers run in a loop
    seq_shard: bool = False        # Megatron-SP pin (a spec only: C24)
    optimizer: Literal["adamw", "adafactor"] = "adamw"
    tie_embeddings: bool = False
    # embedder head (MiniLM-style sentence encoder)
    pooled_dim: int = 0            # >0: mean-pool + project to this dim

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

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


def stacked_init(gen: torch.Generator, lead: tuple[int, ...], shape,
                 dtype: torch.dtype, scale: float | None = None
                 ) -> torch.Tensor:
    """A (*lead, *shape) tensor of `dense_init` draws, one trailing
    (*shape) slice at a time, so a stack of layers or experts never needs
    an f32 copy of itself."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=gen.device)
    flat = out.view(-1, *shape)
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, shape, dtype, scale=scale)
    return out


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
    h = torch.nn.functional.silu(g) * u
    if h.ndim == 3:                       # (B, S, F): TP-shard the hidden
        h = constrain(h, "dp", None, "mp")
    return h @ w_down.to(x.dtype)


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


def remat_applies(cfg, x: torch.Tensor, params: Params) -> bool:
    """Whether `cfg.remat` checkpoints the blocks of this call: autograd
    records it (x or a parameter requires grad)."""
    return cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in _tree.leaves(params)))


def residual_pattern(cfg) -> tuple:
    """Sharding pins for the (B, S, D) residual stream: plain TP keeps it
    batch-sharded only; Megatron-SP (cfg.seq_shard) also shards S over
    the model axis between blocks."""
    return ("dp", "mp", None) if cfg.seq_shard else ("dp", None, None)


# ---------------------------------------------------------------------------
# Activation sharding constraints (GSPMD hints)
# ---------------------------------------------------------------------------

_ACTIVE: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """The active mesh for the hints below (the reference's
    `jax.set_mesh`): any object with `.shape` and `.axis_names`."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The innermost mesh set by `set_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@dataclasses.dataclass(frozen=True)
class BatchBlock:
    rows: int       # rows of the global microbatch
    start: int      # the first of them that this call runs


_BLOCK: list = []


@contextlib.contextmanager
def batch_block(rows: int, start: int):
    """Calls inside run rows [start, start + b) of a global microbatch of
    `rows` rows (b the rows they are given)."""
    _BLOCK.append(BatchBlock(int(rows), int(start)))
    try:
        yield
    finally:
        _BLOCK.pop()


def active_batch_block() -> BatchBlock | None:
    """The innermost block set by `batch_block`, or None: the call runs
    the whole microbatch."""
    return _BLOCK[-1] if _BLOCK else None


def _axes(mesh) -> tuple[tuple[str, ...], str | None]:
    names = tuple(mesh.axis_names)
    mp = "model" if "model" in names else None
    return tuple(n for n in names if n != "model"), mp


def constrain_spec(shape: tuple[int, ...], pattern, mesh) -> tuple:
    """The spec the reference's `constrain` pins on an activation of
    `shape`: pattern entries are 'dp' (batch axes), 'mp' (model axis) or
    None, one per dim; each entry divisibility-guarded, each axis used
    once. A tuple of entries (None, an axis name or a tuple of names)."""
    dp, mp = _axes(mesh)
    spec = []
    used = set()
    for dim, want in enumerate(pattern):
        d = shape[dim] if dim < len(shape) else 0
        if want == "dp" and "dp" not in used and dp:
            size = 1
            for a in dp:
                size *= mesh.shape[a]
            if d % size == 0 and d > 0:
                spec.append(dp if len(dp) > 1 else dp[0])
                used.add("dp")
                continue
        if want == "mp" and "mp" not in used and mp:
            if d % mesh.shape[mp] == 0 and d > 0:
                spec.append(mp)
                used.add("mp")
                continue
        spec.append(None)
    return tuple(spec)


def constrain_kv_spec(shape: tuple[int, ...], mesh) -> tuple:
    """The spec the reference's `constrain_kv` pins on a KV-cache slice
    (B, T, KH, hd): B -> dp; KH -> mp when divisible, else T -> mp
    (context-parallel decode)."""
    dp, mp = _axes(mesh)
    b, t, kh, _ = shape
    dsz = 1
    for a in dp:
        dsz *= mesh.shape[a]
    bspec = (dp if len(dp) > 1 else dp[0]) if (dp and b % dsz == 0) else None
    if mp and kh % mesh.shape[mp] == 0:
        return (bspec, None, mp, None)
    if mp and t % mesh.shape[mp] == 0:
        return (bspec, mp, None, None)
    return (bspec, None, None, None)


def constrain(x: torch.Tensor, *pattern: str | None) -> torch.Tensor:
    """Pin an activation's sharding (`constrain_spec`). Returns x: outside
    a mesh there is nothing to pin, as in the reference; under a sharded
    mesh the batch block a rank runs is the "dp" pin, and the "mp" pin is
    not realized (ROADMAP C24)."""
    return x


def constrain_kv(kc: torch.Tensor) -> torch.Tensor:
    """Pin a KV-cache slice's sharding (`constrain_kv_spec`); returns kc,
    as `constrain` does."""
    return kc
