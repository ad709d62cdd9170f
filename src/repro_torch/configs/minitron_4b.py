"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron [arXiv:2407.14679; hf]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="minitron-4b", family="dense", num_layers=32, d_model=3072,
    num_heads=24, num_kv_heads=8, d_ff=9216, vocab_size=256000,
    rope_theta=1e4)

SMOKE = FULL.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   d_ff=128, vocab_size=128, attn_chunk=64)
