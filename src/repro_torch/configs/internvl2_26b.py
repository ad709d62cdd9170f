"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821; hf].

The InternViT vision frontend is a STUB, as in the reference: a batch's
`prefix_embeds` holds precomputed patch embeddings (B,
num_prefix_embeds, d_model) that are prepended to the token embeddings;
the LM backbone (InternLM2-20B dims) is fully implemented.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="internvl2-26b", family="vlm", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92553,
    num_prefix_embeds=1024, frontend_dim=6144, rope_theta=1e6)

SMOKE = FULL.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   d_ff=128, vocab_size=128, num_prefix_embeds=8,
                   frontend_dim=64, attn_chunk=64)
