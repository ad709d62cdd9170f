"""minilm-embedder — the PAPER's own embedding model (MiniLM-L6-v2 dims +
Sentence-BERT pooling, projected to the paper's 512-dim embeddings)."""
from repro_torch.models.embedder import MINILM_CFG

FULL = MINILM_CFG

SMOKE = FULL.with_(num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
                   d_ff=64, vocab_size=128, pooled_dim=16)
