"""Architecture config registry (port of `repro.configs`):
`get_config("<arch-id>")` / `--arch <id>` for the ported architectures."""
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
)

# the paper's own model, selectable too
EXTRA_IDS = ("minilm-embedder",)

# The reference's other architecture, whose family is not ported yet.
NOT_PORTED = ("seamless-m4t-medium",)

_MOD = {aid: "repro_torch.configs." + aid.replace("-", "_").replace(".", "_")
        for aid in ARCH_IDS + EXTRA_IDS}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MOD:
        why = ("is not ported yet (ROADMAP A3)" if arch in NOT_PORTED
               else "is unknown")
        raise KeyError(f"arch {arch!r} {why}; ported: {sorted(_MOD)}")
    mod = importlib.import_module(_MOD[arch])
    return mod.SMOKE if smoke else mod.FULL
