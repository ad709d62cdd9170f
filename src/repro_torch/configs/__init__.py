"""Architecture config registry (port of `repro.configs`):
`get_config("<arch-id>")` / `--arch <id>` for the reference's ten
architectures and the paper's embedder."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = (
    "qwen2-0.5b",
    "minitron-4b",
    "deepseek-coder-33b",
    "deepseek-67b",
    "mamba2-2.7b",
    "llama4-maverick-400b-a17b",
    "llama4-scout-17b-a16e",
    "zamba2-2.7b",
    "internvl2-26b",
    "seamless-m4t-medium",
)

# the paper's own model, selectable too
EXTRA_IDS = ("minilm-embedder",)

_MOD = {aid: "repro_torch.configs." + aid.replace("-", "_").replace(".", "_")
        for aid in ARCH_IDS + EXTRA_IDS}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MOD)}")
    mod = importlib.import_module(_MOD[arch])
    return mod.SMOKE if smoke else mod.FULL
