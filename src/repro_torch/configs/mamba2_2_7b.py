"""mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

d_inner = 2*d_model = 5120, head_dim 64 -> 80 SSD heads, ngroups=1.
num_heads/num_kv_heads/d_ff are unused by the SSM family (attention-free).
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm", num_layers=64, d_model=2560,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=256, tie_embeddings=True)

SMOKE = FULL.with_(num_layers=2, d_model=64, vocab_size=128,
                   ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
