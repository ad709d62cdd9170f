"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b", family="dense", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6)

SMOKE = FULL.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   d_ff=128, vocab_size=128, attn_chunk=64)
