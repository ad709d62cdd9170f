"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

12 encoder + 12 decoder layers. The speech frontend is a STUB, as in the
reference: the encoder takes precomputed frame embeddings (B, S_src,
d_model) as its input.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    encoder_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, frontend_dim=1024, rope_theta=1e4)

SMOKE = FULL.with_(num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=4, d_ff=128, vocab_size=128, frontend_dim=64,
                   attn_chunk=64)
