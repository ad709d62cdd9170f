"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-67b", family="dense", num_layers=95, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=22016, vocab_size=102400,
    rope_theta=1e4)

SMOKE = FULL.with_(num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
                   d_ff=128, vocab_size=128, attn_chunk=64)
