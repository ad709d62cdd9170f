"""Batched autoregressive sampling loop over any ModelApi (port of
`repro.serve.sampler`).

Greedy decoding (temperature 0) takes the first maximal logit, as
`jnp.argmax` does, so its tokens equal the reference's for equal logits.
Sampling at temperature > 0 draws from an explicit `torch.Generator` and
cannot match `jax.random.categorical` bit for bit (ROADMAP C15). The
reference caches one jitted (prefill, decode) pair per ModelApi; eager
calls here rebuild nothing per call.
"""
from __future__ import annotations

from typing import Any

import torch


def sample_tokens(logits: torch.Tensor,
                  generator: torch.Generator | None = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """logits (B, 1, V) -> next tokens (B, 1) int32."""
    last = logits[:, -1]
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(last.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def decode_loop(logits: torch.Tensor, cache, step, max_new: int, *,
                temperature: float = 0.0,
                generator: torch.Generator | None = None):
    """Sample the first token from the prompt's logits, then run
    `step(cache, tok) -> (logits, cache)` for max_new - 1 more tokens (the
    last token is sampled but never fed back). Returns (tokens (B,
    max_new) int32, final cache)."""
    tok = sample_tokens(logits[:, -1:], generator, temperature)
    outs = [tok]
    for _ in range(max_new - 1):
        logits, cache = step(cache, tok)
        tok = sample_tokens(logits, generator, temperature)
        outs.append(tok)
    return torch.cat(outs, dim=1), cache


def generate(api, params: Any, batch: dict, *, max_new: int,
             max_len: int | None = None, temperature: float = 0.0,
             generator: torch.Generator | None = None):
    """Prefill the prompt batch, then decode `max_new` tokens.

    Returns (generated (B, max_new) int32, final cache). Lockstep batched
    decoding; `generator` draws the samples when temperature > 0."""
    prompt_len = batch["tokens"].shape[1]
    total = max_len or (prompt_len + max_new)
    logits, cache = api.prefill(params, batch, max_len=total)
    return decode_loop(
        logits, cache, lambda c, t: api.decode_step(params, c, t), max_new,
        temperature=temperature, generator=generator)
