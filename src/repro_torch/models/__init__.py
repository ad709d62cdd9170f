"""Model library (port of `repro.models`, its serving half): the dense GQA
decoder (with the quantized-KV decode), its VLM backbone, and the paper's
MiniLM-style embedder. MoE, Mamba2, Zamba2 and the encoder-decoder wait
for ROADMAP A3."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelApi, get_model

__all__ = ["ModelApi", "ModelConfig", "get_model"]
