"""train_step factory: value and grad + microbatch accumulation +
optimizer (port of `repro.train.step`).

The returned function maps (params, opt_state, batch) to (params,
opt_state, metrics) without writing its inputs. Autograd takes the place
of `jax.value_and_grad`: the loss is evaluated on detached leaves that
require grad, so the caller's parameters need not. Gradient accumulation
splits the batch axis into `grad_accum` microbatches and sums their f32
gradients in a loop, in the reference's order; the sums are divided by a
tensor (`true_div`).

`grad_transform` is an optional hook applied to the gradient tree before
clipping and the optimizer (the INT8 error-feedback compression of
`repro_torch.distributed.compression`).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import _tree
from repro_torch.core.quantization import true_div
from repro_torch.train.optim import Optimizer

F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32)))
                          for leaf in _tree.leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return _tree.tree_map(lambda leaf: (leaf * scale).to(leaf.dtype),
                          tree), norm


def value_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor], params,
                   batch) -> tuple[torch.Tensor, Any]:
    """(loss, grads of loss w.r.t. every leaf of params); a leaf the loss
    does not reach gets zeros, as in JAX."""
    live = [leaf.detach().requires_grad_(True)
            for leaf in _tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_tree.unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), _tree.unflatten(params, grads)


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    optimizer: Optimizer, *, grad_accum: int = 1,
                    clip_norm: float | None = 1.0,
                    grad_transform: Callable | None = None):
    """loss_fn(params, batch) -> scalar. Returns train_step fn."""

    def train_step(params, opt_state, batch):
        if grad_accum > 1:
            rows = {len(v) for v in batch.values()}
            if len(rows) != 1 or next(iter(rows)) % grad_accum:
                raise ValueError(f"batch rows {sorted(rows)} do not split "
                                 f"into {grad_accum} microbatches")
            mb = next(iter(rows)) // grad_accum
            loss_sum = torch.zeros((), dtype=F32,
                                   device=_tree.leaves(params)[0].device)
            grads = _tree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                params)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g = value_and_grad(loss_fn, params, micro)
                grads = _tree.tree_map(lambda a, b: a + b.to(F32), grads, g)
                loss_sum = loss_sum + loss
            loss = true_div(loss_sum, grad_accum)
            grads = _tree.tree_map(lambda g: true_div(g, grad_accum), grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)

        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = torch.zeros((), dtype=F32, device=loss.device)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
