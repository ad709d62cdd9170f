"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16e top-1 — MoE every layer + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", num_layers=48,
    d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192,
    vocab_size=202048, num_experts=16, moe_top_k=1, moe_layer_period=1,
    shared_expert=True, capacity_factor=1.25, rope_theta=5e5)

SMOKE = FULL.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   d_ff=128, vocab_size=128, num_experts=4, attn_chunk=64)
