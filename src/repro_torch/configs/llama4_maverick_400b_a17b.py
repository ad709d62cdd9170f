"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 — interleaved MoE (every other
layer) + shared expert [hf:meta-llama; unverified].

bf16 params + Adafactor, as in the reference: AdamW's f32 moments for
400B parameters do not fit a device's memory.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
    d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192,
    vocab_size=202048, num_experts=128, moe_top_k=1, moe_layer_period=2,
    shared_expert=True, capacity_factor=1.25, param_dtype="bfloat16",
    optimizer="adafactor", rope_theta=5e5)

SMOKE = FULL.with_(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                   d_ff=128, vocab_size=128, num_experts=4, attn_chunk=64,
                   param_dtype="float32", optimizer="adamw")
