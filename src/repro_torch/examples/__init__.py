"""The five runnable examples, the port of the reference's `examples/`:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.multi_user_agent
    PYTHONPATH=src python -m repro_torch.examples.serve_rag_agent
    PYTHONPATH=src python -m repro_torch.examples.pod_retrieval
    PYTHONPATH=src python -m repro_torch.examples.train_100m [--full]

Each runs on the CUDA device unless `--device` names another, and raises
without one. Each keeps its work in a function that takes the objects it
runs on (configs, parameters, a device or mesh), so the same work runs
with the parameters a caller brings; `main` draws its own from seeded
`torch.Generator`s on the CPU and moves them to the device, so the card
and the CPU run the same weights.
"""
from __future__ import annotations

import torch

from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.models import embedder, get_model


def seeded_params(init, seed: int, device: torch.device):
    """`init(generator, device="cpu")` drawn from a CPU generator seeded
    with `seed`, then moved to `device`."""
    params = init(torch.Generator().manual_seed(seed), device="cpu")
    return _tree.tree_map(lambda t: t.to(device), params)


def agent_models(device: torch.device):
    """The agent examples' models: the qwen2-0.5b smoke generator (seed 0)
    and a 2-layer MiniLM-style embedder over its vocabulary (seed 1).
    Returns (embedder config, embedder params, generator api, generator
    params), all on `device`."""
    gcfg = get_config("qwen2-0.5b", smoke=True)
    gen_api = get_model(gcfg)
    ecfg = embedder.MINILM_CFG.with_(num_layers=2, d_model=64, num_heads=4,
                                     num_kv_heads=4, d_ff=128,
                                     vocab_size=gcfg.vocab_size,
                                     pooled_dim=64)
    eparams = seeded_params(
        lambda gen, device: embedder.init_params(ecfg, gen, device=device),
        1, device)
    return ecfg, eparams, gen_api, seeded_params(gen_api.init, 0, device)
