"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention blocks
[arXiv:2411.15242; hf].

54 Mamba2 layers; ONE shared transformer block (MHA kv=32, head_dim 80 +
SwiGLU d_ff=10240) applied after every 6 Mamba layers (9 applications,
all reusing the same weights; per-application LoRA deltas omitted —
ROADMAP C26)."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, head_dim=80, d_ff=10240,
    vocab_size=32000, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    ssm_conv_width=4, ssm_chunk=256, hybrid_attn_period=6)

SMOKE = FULL.with_(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                   head_dim=16, d_ff=128, vocab_size=128, ssm_state=16,
                   ssm_head_dim=16, ssm_chunk=16, hybrid_attn_period=2,
                   attn_chunk=64)
