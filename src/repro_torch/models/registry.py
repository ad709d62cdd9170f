"""Uniform model API: family dispatch for init / loss / prefill / decode
(port of `repro.models.registry`).

`get_model(cfg)` returns a ModelApi whose members close over cfg, so the
launchers, the trainer and the RAG pipelines treat every architecture
the same way. The `vlm` family is the dense model fed stub patch
embeddings (prefix_embeds); `moe` is `models/moe.py`, `ssm`
`models/mamba2.py` and `hybrid` `models/zamba2.py`; `encdec`
(`models/encdec.py`) carries its own batch layout (frames + tokens) and
its cache's source length.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import dense, encdec, mamba2, moe, zamba2
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]             # (generator, device=None) -> params
    loss_fn: Callable[..., Any]          # (params, batch) -> scalar
    prefill: Callable[..., Any]          # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable[..., Any]      # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable[..., Any]       # (batch_size, max_len, ..., device=None) -> cache


_FAMILIES = {"moe": moe, "ssm": mamba2, "hybrid": zamba2}


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "vlm"):
        mod = dense
    elif cfg.family in _FAMILIES:
        mod = _FAMILIES[cfg.family]
    elif cfg.family == "encdec":
        return _encdec_api(cfg)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")

    def init(gen: torch.Generator, device=None):
        return mod.init_params(cfg, gen, device=device)

    def loss(params, batch):
        return mod.loss_fn(params, batch, cfg)

    def prefill(params, batch, max_len=None):
        return mod.prefill(params, batch["tokens"], cfg, max_len=max_len,
                           lengths=batch.get("lengths"),
                           prefix_embeds=batch.get("prefix_embeds"))

    def decode(params, cache, tokens):
        return mod.decode_step(params, cache, tokens, cfg)

    def init_cache(batch_size, max_len, device=None, **kw):
        return mod.init_cache(cfg, batch_size, max_len, device=device)

    return ModelApi(cfg=cfg, init=init, loss_fn=loss, prefill=prefill,
                    decode_step=decode, init_cache=init_cache)


def _encdec_api(cfg: ModelConfig) -> ModelApi:
    def init(gen: torch.Generator, device=None):
        return encdec.init_params(cfg, gen, device=device)

    def loss(params, batch):
        return encdec.loss_fn(params, batch, cfg)

    def prefill(params, batch, max_len=None):
        return encdec.prefill(params, batch["frames"], batch["tokens"], cfg,
                              max_len=max_len, lengths=batch.get("lengths"))

    def decode(params, cache, tokens):
        return encdec.decode_step(params, cache, tokens, cfg)

    def init_cache(batch_size, max_len, src_len=None, device=None, **kw):
        return encdec.init_cache(cfg, batch_size, max_len,
                                 src_len or max_len, device=device)

    return ModelApi(cfg=cfg, init=init, loss_fn=loss, prefill=prefill,
                    decode_step=decode, init_cache=init_cache)
