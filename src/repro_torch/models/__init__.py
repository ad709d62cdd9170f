"""Model library (port of `repro.models`): the dense GQA decoder (with the
quantized-KV decode), its VLM backbone, the MoE, Mamba2, Zamba2 and the
encoder-decoder, and the paper's MiniLM-style embedder."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelApi, get_model

__all__ = ["ModelApi", "ModelConfig", "get_model"]
